// flash_attention_bwd: the gradients of causal (optionally sliding-window)
// GQA attention with respect to q, k and v.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py: flash_attention
// (_flash_kernel) has no backward: the JAX package trains through
// jax.value_and_grad over jnp attention, so no Pallas kernel is
// differentiated there. The port's forward runs the flash_attention kernel
// (csrc/flash_attention.cu), whose output carries no graph; this is its
// backward, reached through FlashAttentionFn (kernels/flash_attention/ops.py).
// The visibility is the forward's: query i at position q_offset + i sees key
// t if t <= q_offset + i (causal) and q_offset + i - t < window (window > 0).
//
// With S = scale Q K^T, P = softmax(S) over the visible keys, O = P V and
// dO the output's gradient:
//   D = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - D),
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K.
// Each gradient element is written by one thread of one CTA and every sum
// runs in a fixed order: no atomics, the same bits on every run. Two
// variants, chosen by the wrapper by dtype and head dim (ops.py:
// bwd_variant_for):
//
// * wgmma (bfloat16 / float16, d in {64, 128, 256}: every model the port
//   trains).
//   The forward's wgmma kernel saved each query row's logsumexp, in log2
//   units of the scaled scores (lse = m + log2 l, so P = exp2(scale log2(e)
//   s - lse)), so nothing recomputes the softmax statistics. Three kernels:
//   - pre: D = rowsum(dO o O) in float32, a warp a row;
//   - dK/dV: a CTA of two warpgroups per (request, kv head, 128 keys). One
//     thread issues TMA loads (128-byte swizzle) of the K and V tiles once,
//     then, for every query head of the group and every 64-row query tile
//     that sees any of the keys, of the Q and dO tiles and (1-d bulk copies)
//     the 64 rows' lse and D into a ring of three stages guarded by
//     mbarriers: "full", completed by the copies' byte count, and "empty",
//     released by all 256 threads, after which the same thread refills the
//     stage. Each warpgroup owns 64 keys, the M dimension of every product,
//     so all of them stay in the accumulator layout: S^T = K Q^T and
//     dP^T = V dO^T as wgmma m64n64k16 with both operands read from shared
//     memory; P^T = exp2(S^T - lse) and dS^T = P^T o (dP^T - D) on the
//     registers (the mask only on a tile that crosses an edge; a tile none
//     of whose pairs is visible is skipped); then dV += P^T dO and
//     dK += dS^T Q as wgmma m64n64k16 per 64 columns of d, P^T and dS^T
//     rounded to the input dtype as A operands from registers, dO and Q
//     read MN-major (the transpose bit) from the same tiles. dK and dV (64 +
//     64 floats a thread at d = 128) stay in registers across the whole walk
//     and are written once.
//   - dQ: a CTA of two warpgroups per (request, query head, 128 query rows):
//     Q and dO loaded once, 64-key K and V tiles through the ring;
//     S = Q K^T and dP = dO V^T (both from shared memory), dS on the
//     registers, dQ += dS K with K read MN-major.
//   No producer warpgroup: under a launch bound of 384 threads ptxas holds
//   every thread to 168 registers whatever setmaxnreg grants at run time
//   (the forward's finding), and the dK/dV kernel's 128 accumulators and
//   two score tiles spilled 992 bytes there at d = 128; at 256 threads it
//   uses 242 and spills nothing. The key (dK/dV) or query (dQ) tile varies
//   slowest across the grid, so the CTAs with the most work start first
//   for every head at once (with the tile fastest, one head's longest CTAs
//   started last: 0.98 against 0.68 ms at the shape below, PERF.md).
//   Seven products where the minimum is five: S (or S^T) twice, dP twice.
//   P and dS are rounded to 16 bits before the products that take them from
//   registers; every product accumulates in float32 and each gradient is
//   rounded once.
//   At d = 256 (gemma3-4b) the preprocess is the same, and two kernels of
//   their own take the other two roles, both 256 threads with one thread
//   issuing the copies:
//   - dK/dV: a CTA per (request, kv head, 64 keys). A 64-key x 256 tile of
//     dK and of dV would be 256 floats a thread of a warpgroup, so the two
//     warpgroups hold the same 64 keys and split by role: warpgroup 0 runs
//     S^T = K Q^T, forms P^T and adds dV += P^T dO; warpgroup 1 runs
//     dP^T = V dO^T, reads P^T from shared memory (float32, in the
//     accumulator's own layout, between two named barriers), forms
//     dS^T = P^T o (dP^T - D) and adds dK += dS^T Q: two products a
//     warpgroup a step, 128 + 32 floats a thread. K and V stay resident,
//     Q, dO, lse and D come through a ring of two stages (210 KB in all),
//     and warpgroup 1's first thread, which finishes a step last, refills
//     it. Every step of its query tiles sees some of its keys (the tiles
//     are cut to the keys' visible range), so no step is skipped.
//   - dQ: a CTA per (request, query head, 128 query rows), 64 a warpgroup
//     (a 64 x 256 accumulator), Q and dO resident (128 KB), 64-key K tiles
//     in two slots and V tiles in one (225 KB in all): S = Q K^T and
//     dP = dO V^T as wgmma m64n64k16, dS on the registers, dQ += dS K with
//     K read MN-major; 32 floats each of S, dP and dS beside the
//     accumulator. V (i + 1) loads while dS and dQ (i) are computed, K
//     (i + 1) while S and dP (i) are. A tile none of whose pairs a
//     warpgroup sees runs all the same, its P masked to 0. ptxas serializes
//     every product of a kernel (C7520) if a branch encloses them with a
//     one-thread refill inside, or if a barrier wait sits between the
//     products of one commit group: S and dP are two groups, the wait on V
//     between them. 32-key tiles (m64n32k16 products, three stages) took
//     0.289 ms at gemma3-4b's shape, and the serialized 64-key form 0.264,
//     against 0.201 now: a product with both operands in shared memory
//     reads (64 + N) x 32 bytes for 64 x N x 32 operations, 192 bytes a
//     clock at N = 32 where the SM reads 128.
// * cuda_core_f32 (float32 at d in {16, 32, 64, 128}, and 16-bit at d in
//   {16, 32}, which the 128-byte swizzled tiles do not take): three kernels,
//   float32 on the CUDA cores (the forward's 64 x 64 tiles and 4 x 4 scores a
//   thread, common.cuh), inputs of any float dtype widened as they are
//   loaded:
//   - stats: a CTA per (request, query head, 64 query rows) recomputes the
//     row max and sum over the visible key tiles into a float32 logsumexp
//     (natural log), and D from the O and dO tiles;
//   - dK/dV: a CTA per (request, kv head, 64 keys) holds its K and V tiles and
//     walks, for each query head of the group, the query tiles that see any
//     of its keys: P = exp(S - lse), dP, dS, then dV += P^T dO and
//     dK += dS^T Q, accumulated in float32 registers (4 keys x d / 16
//     columns a thread) and written once;
//   - dQ: a CTA per (request, query head, 64 query rows) walks the visible
//     key tiles: dQ += dS K.
//
// Bound on the H100 at qwen3-1.7b's training shape (b 1, 16 query heads over
// 8 kv heads, s 4096, d 128, causal): the minimum of five products over the
// s^2 / 2 visible pairs is 5 x 2 x 8.4e6 x 128 x 16 = 1.7e11 operations,
// 0.17 ms at the tensor cores' 989 TFLOP/s; the wgmma variant's seven are
// 2.4e11, 0.24 ms; ~100 MB of q, k, v, O, dO and the gradients, 0.03 ms.
// gemma3-4b's (8 query heads over 4, d 256) is the same 1.7e11, since
// 8 x 256 = 16 x 128: 0.17 ms causal, 0.076 ms with window 1024 (seven
// products: 0.24 and 0.106). Its kernels run at about three times the
// five-product bound (PERF.md). What holds them back: the first product of
// each kernel reads both operands from shared memory (S^T and dP^T, S and
// dP), at the SM's 128 bytes a clock when the tensor cores run at full
// rate; in dK/dV warpgroup 1's product waits for warpgroup 0's P^T, so
// the tensor cores idle while both warpgroups are in their elementwise
// work; and a warpgroup's elementwise work and its products take turns.
// The float32 variant recomputes S three times and P twice (eight
// products) on the CUDA cores' 67 TFLOP/s.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace ckv {

// (batch, head, position) element strides of q, k, v, out, dout, dq, dk, dv
struct BwdStrides {
  long long sb[8], sh[8], ss[8];
};
enum { BQ = 0, BK, BV, BO, BDO, BDQ, BDK, BDV };

constexpr int FB_LP = TK + 4;  // row stride of the P and dS tiles

template <typename T>
struct RowsOf {
  const T* base;
  long long ss;
  int r0, n;
  __device__ const T* operator()(int r) const {
    return r0 + r < n ? base + (long long)(r0 + r) * ss : nullptr;
  }
};

__device__ __forceinline__ bool fb_visible(int i, int t, int s_q, int s_k, int causal, int window,
                                           int q_offset) {
  const int p = q_offset + i;
  return i < s_q && t < s_k && (!causal || t <= p) && (window <= 0 || p - t < window);
}

// The keys [k_begin, k_end) that any query of rows [m0, m0 + TR) may see.
__device__ __forceinline__ void fb_key_range(int m0, int s_q, int s_k, int causal, int window,
                                             int q_offset, int* k_begin, int* k_end) {
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + TR, s_q) - 1;
  *k_end = causal ? min(s_k, p_hi + 1) : s_k;
  *k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
}

// stats: lse (natural log, scaled scores) and D = rowsum(dO o O) per query row
template <typename T, int HD>
static __global__ void __launch_bounds__(NT) fa_bwd_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ out,
    const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ dsum, int n_q,
    int n_kv, int s_q, int s_k, int causal, int window, int q_offset, int lse_row, float scale,
    BwdStrides st) {
  constexpr int LD = HD + 4;
  extern __shared__ float smem[];
  float* qs = smem;          // [TR][LD]
  float* ks = qs + TR * LD;  // [TK][LD]
  const int n_mb = (s_q + TR - 1) / TR;
  const int m0 = (n_mb - 1 - blockIdx.x) * TR;  // the longest rows first
  const int qh = blockIdx.y, b = blockIdx.z, kh = qh / (n_q / n_kv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * st.sb[BQ] + qh * st.sh[BQ];
  const T* kb = k + b * st.sb[BK] + kh * st.sh[BK];
  int k_begin, k_end;
  fb_key_range(m0, s_q, s_k, causal, window, q_offset, &k_begin, &k_end);
  load_tile<T>(qs, TR, HD, RowsOf<T>{qb, st.ss[BQ], m0, s_q});
  float m_run[4], l_run[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = CKV_NEG_INF, l_run[i] = 0.f;
  for (int n0 = (k_begin / TK) * TK; n0 < k_end; n0 += TK) {
    __syncthreads();
    load_tile<T>(ks, TK, HD, RowsOf<T>{kb, st.ss[BK], n0, s_k});
    __syncthreads();
    float sc[4][4];
    tile_scores(qs, ks, HD, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[i][j] = fb_visible(m0 + ty + 16 * i, n0 + tx + 16 * j, s_q, s_k, causal, window,
                              q_offset)
                       ? sc[i][j] * scale
                       : CKV_NEG_INF;
    online_softmax(sc, m_run, l_run, alpha);
  }
  // D from the O and dO tiles, read into the two tiles just used
  __syncthreads();
  load_tile<T>(qs, TR, HD, RowsOf<T>{out + b * st.sb[BO] + qh * st.sh[BO], st.ss[BO], m0, s_q});
  load_tile<T>(ks, TR, HD, RowsOf<T>{dout + b * st.sb[BDO] + qh * st.sh[BDO], st.ss[BDO], m0, s_q});
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float s = 0.f;
#pragma unroll
    for (int x = tx; x < HD; x += 16) s = fmaf(qs[r * LD + x], ks[r * LD + x], s);
    s = half_sum(s);
    if (tx == 0 && m0 + r < s_q) {
      const long long row = ((long long)b * n_q + qh) * lse_row + m0 + r;
      // a row that sees no key has no probability to differentiate
      lse[row] = l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : 0.f;
      dsum[row] = s;
    }
  }
}

// P and dS of one (64 queries x 64 keys) tile into shared memory, rows the
// queries: P = exp(S - lse) where visible, dS = P (dP - D).
template <int HD>
__device__ __forceinline__ void fb_p_ds(const float* qs, const float* ks, const float* dos,
                                        const float* vs, const float* lse_s, const float* dd_s,
                                        float* ps, float* dss, int m0, int n0, int s_q, int s_k,
                                        int causal, int window, int q_offset, float scale) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float sc[4][4], dp[4][4];
  tile_scores(qs, ks, HD, ty, tx, sc);
  tile_scores(dos, vs, HD, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = fb_visible(m0 + r, n0 + c, s_q, s_k, causal, window, q_offset)
                          ? expf(sc[i][j] * scale - lse_s[r])
                          : 0.f;
      if (ps) ps[r * FB_LP + c] = p;
      dss[r * FB_LP + c] = p * (dp[i][j] - dd_s[r]);
    }
  }
}

__device__ __forceinline__ void fb_row_stats(float* lse_s, float* dd_s, const float* lse,
                                             const float* dsum, int m0, int s_q) {
  const int tid = threadIdx.x;
  if (tid < TR) {
    const bool ok = m0 + tid < s_q;
    lse_s[tid] = ok ? lse[m0 + tid] : 0.f;
    dd_s[tid] = ok ? dsum[m0 + tid] : 0.f;
  }
}

// dK and dV of 64 keys of one kv head, over every query head of its group
template <typename T, int HD>
static __global__ void __launch_bounds__(NT) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dk, T* __restrict__ dv, int n_q, int n_kv, int s_q, int s_k, int causal,
    int window, int q_offset, int lse_row, float scale, BwdStrides st) {
  constexpr int LD = HD + 4, CPT = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [TK][LD]
  float* vs = ks + TK * LD;      // [TK][LD]
  float* qs = vs + TK * LD;      // [TR][LD]
  float* dos = qs + TR * LD;     // [TR][LD]
  float* ps = dos + TR * LD;     // [TR][FB_LP]
  float* dss = ps + TR * FB_LP;  // [TR][FB_LP]
  float* lse_s = dss + TR * FB_LP;
  float* dd_s = lse_s + TR;
  const int n0 = blockIdx.x * TK;  // causal: the first key tiles see the most queries
  const int kh = blockIdx.y, b = blockIdx.z, group = n_q / n_kv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<T>(ks, TK, HD, RowsOf<T>{k + b * st.sb[BK] + kh * st.sh[BK], st.ss[BK], n0, s_k});
  load_tile<T>(vs, TK, HD, RowsOf<T>{v + b * st.sb[BV] + kh * st.sh[BV], st.ss[BV], n0, s_k});
  // the queries that see any of these keys: [i_lo, i_hi)
  const int t_hi = min(n0 + TK, s_k) - 1;
  const int i_lo = causal ? max(0, n0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(s_q, t_hi + window - q_offset) : s_q;
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  for (int g = 0; g < group; ++g) {
    const int qh = kh * group + g;
    const T* qb = q + b * st.sb[BQ] + qh * st.sh[BQ];
    const T* dob = dout + b * st.sb[BDO] + qh * st.sh[BDO];
    const long long row0 = ((long long)b * n_q + qh) * lse_row;
    for (int m0 = (i_lo / TR) * TR; m0 < i_hi; m0 += TR) {
      __syncthreads();  // the last tile's readers are done
      load_tile<T>(qs, TR, HD, RowsOf<T>{qb, st.ss[BQ], m0, s_q});
      load_tile<T>(dos, TR, HD, RowsOf<T>{dob, st.ss[BDO], m0, s_q});
      fb_row_stats(lse_s, dd_s, lse + row0, dsum + row0, m0, s_q);
      __syncthreads();
      fb_p_ds<HD>(qs, ks, dos, vs, lse_s, dd_s, ps, dss, m0, n0, s_q, s_k, causal, window,
                  q_offset, scale);
      __syncthreads();
      // rows of dK and dV: keys ty + 16 i; columns tx + 16 c
      for (int r = 0; r < TR; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = ps[r * FB_LP + ty + 16 * i];
          ds[i] = dss[r * FB_LP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float o = dos[r * LD + tx + 16 * c], qq = qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(p[i], o, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qq, dk_acc[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = n0 + ty + 16 * i;
    if (t >= s_k) continue;
    T* dkr = dk + b * st.sb[BDK] + kh * st.sh[BDK] + (long long)t * st.ss[BDK];
    T* dvr = dv + b * st.sb[BDV] + kh * st.sh[BDV] + (long long)t * st.ss[BDV];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkr[tx + 16 * c] = from_f32<T>(dk_acc[i][c] * scale);
      dvr[tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// dQ of 64 query rows of one query head
template <typename T, int HD>
static __global__ void __launch_bounds__(NT) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dq, int n_q, int n_kv, int s_q, int s_k, int causal, int window,
    int q_offset, int lse_row, float scale, BwdStrides st) {
  constexpr int LD = HD + 4, CPT = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [TR][LD]
  float* dos = qs + TR * LD;     // [TR][LD]
  float* ks = dos + TR * LD;     // [TK][LD]
  float* vs = ks + TK * LD;      // [TK][LD]
  float* dss = vs + TK * LD;     // [TR][FB_LP]
  float* lse_s = dss + TR * FB_LP;
  float* dd_s = lse_s + TR;
  const int n_mb = (s_q + TR - 1) / TR;
  const int m0 = (n_mb - 1 - blockIdx.x) * TR;  // the longest rows first
  const int qh = blockIdx.y, b = blockIdx.z, kh = qh / (n_q / n_kv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + b * st.sb[BK] + kh * st.sh[BK];
  const T* vb = v + b * st.sb[BV] + kh * st.sh[BV];
  const long long row0 = ((long long)b * n_q + qh) * lse_row;
  load_tile<T>(qs, TR, HD, RowsOf<T>{q + b * st.sb[BQ] + qh * st.sh[BQ], st.ss[BQ], m0, s_q});
  load_tile<T>(dos, TR, HD,
               RowsOf<T>{dout + b * st.sb[BDO] + qh * st.sh[BDO], st.ss[BDO], m0, s_q});
  fb_row_stats(lse_s, dd_s, lse + row0, dsum + row0, m0, s_q);
  int k_begin, k_end;
  fb_key_range(m0, s_q, s_k, causal, window, q_offset, &k_begin, &k_end);
  float dq_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq_acc[i][c] = 0.f;
  for (int n0 = (k_begin / TK) * TK; n0 < k_end; n0 += TK) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T>(ks, TK, HD, RowsOf<T>{kb, st.ss[BK], n0, s_k});
    load_tile<T>(vs, TK, HD, RowsOf<T>{vb, st.ss[BV], n0, s_k});
    __syncthreads();
    fb_p_ds<HD>(qs, ks, dos, vs, lse_s, dd_s, nullptr, dss, m0, n0, s_q, s_k, causal, window,
                q_offset, scale);
    __syncthreads();
    // rows of dQ: queries ty + 16 i; columns tx + 16 c
    for (int kk = 0; kk < TK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty + 16 * i) * FB_LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][c] = fmaf(ds[i], kv, dq_acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= s_q) continue;
    T* dqr = dq + b * st.sb[BDQ] + qh * st.sh[BDQ] + (long long)r * st.ss[BDQ];
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqr[tx + 16 * c] = from_f32<T>(dq_acc[i][c] * scale);
  }
}

template <typename T, int HD>
static int launch_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                            const void* dout, void* dq, void* dk, void* dv, float* lse,
                            float* dsum, int b, int n_q, int n_kv, int s_q, int s_k, int causal,
                            int window, int q_offset, int lse_row, const BwdStrides& st,
                            cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const float scale = softmax_scale(HD);
  const int smem_stats = (int)sizeof(float) * 2 * TR * LD;
  const int smem_dkdv = (int)sizeof(float) * (4 * TR * LD + 2 * TR * FB_LP + 2 * TR);
  const int smem_dq = (int)sizeof(float) * (4 * TR * LD + TR * FB_LP + 2 * TR);
  cudaFuncSetAttribute(fa_bwd_stats_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_stats);
  cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_dkdv);
  cudaFuncSetAttribute(fa_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_dq);
  const int n_qb = (s_q + TR - 1) / TR, n_kb = (s_k + TK - 1) / TK;
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v;
  fa_bwd_stats_kernel<T, HD><<<dim3(n_qb, n_q, b), NT, smem_stats, stream>>>(
      tq, tk, (const T*)out, (const T*)dout, lse, dsum, n_q, n_kv, s_q, s_k, causal, window,
      q_offset, lse_row, scale, st);
  fa_bwd_dkdv_kernel<T, HD><<<dim3(n_kb, n_kv, b), NT, smem_dkdv, stream>>>(
      tq, tk, tv, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, n_q, n_kv, s_q, s_k, causal, window,
      q_offset, lse_row, scale, st);
  fa_bwd_dq_kernel<T, HD><<<dim3(n_qb, n_q, b), NT, smem_dq, stream>>>(
      tq, tk, tv, (const T*)dout, lse, dsum, (T*)dq, n_q, n_kv, s_q, s_k, causal, window,
      q_offset, lse_row, scale, st);
  return 0;
}

template <typename T>
static int launch_flash_bwd_d(int d, const void* q, const void* k, const void* v,
                              const void* out, const void* dout, void* dq, void* dk, void* dv,
                              float* lse, float* dsum, int b, int n_q, int n_kv, int s_q,
                              int s_k, int causal, int window, int q_offset, int lse_row,
                              const BwdStrides& st, cudaStream_t stream) {
#define CKV_FB_CASE(HD)                                                                      \
  case HD:                                                                                   \
    return launch_flash_bwd<T, HD>(q, k, v, out, dout, dq, dk, dv, lse, dsum, b, n_q, n_kv, \
                                   s_q, s_k, causal, window, q_offset, lse_row, st, stream);
  switch (d) {
    CKV_FB_CASE(16)
    CKV_FB_CASE(32)
    CKV_FB_CASE(64)
    CKV_FB_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CKV_FB_CASE
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernels (bfloat16 / float16, d in {64, 128})

// two warpgroups, no producer warpgroup: one thread of warpgroup 0 issues
// the copies. A launch bound of 256 threads lets ptxas give each thread up to
// 255 registers; with a producer warpgroup (384 threads) it holds every
// thread to 168 whatever setmaxnreg grants at run time, and the dK/dV
// kernel's 128 accumulators and two score tiles spill there at d = 128
constexpr int BW_THREADS = 256;
constexpr int BW_ROWS = 64;        // rows of a warpgroup's tile and of a staged tile
constexpr int BW_BOX = 64 * 128;   // bytes of one swizzled box: 64 rows x 64 columns

template <int HD>
struct BwCfg {
  static constexpr int SUB = HD / 64;        // 128-byte column blocks of a row
  static constexpr int TILE = SUB * BW_BOX;  // 64 rows x HD
  static constexpr int STAGES = 3;
  // four resident tiles (the two warpgroups' K and V, or Q and dO), a ring of
  // two tiles a stage (Q and dO, or K and V), the stages' lse and D (64
  // floats each), then the mbarriers
  static constexpr int RING = 4 * TILE;
  static constexpr int STATS = RING + 2 * STAGES * TILE;
  static constexpr int BAR = STATS + STAGES * 512;
  static constexpr int SMEM = 1024 + BAR + 8 * (1 + 2 * STAGES);  // + alignment slack
};

// K-major operand (A, or B of A B^T): columns [16 kk, 16 kk + 16) of a 64-row tile
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * BW_BOX + (kk % 4) * 32u, 16, 1024);
}
// MN-major B operand: rows [16 kk, 16 kk + 16) of column block c of a 64-row
// tile (two 1024-byte groups of 8 rows; one 64-column block a product, so
// the leading offset is unused)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c, int kk) {
  return sw128_desc(tile + c * BW_BOX + kk * 2048, 1024, 1024);
}

// D = rowsum(dO o O) in float32, a warp a query row; rows s_q to lse_row get 0
template <typename T, int HD>
static __global__ void __launch_bounds__(256) fa_bwd_pre_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ dsum, int n_q,
    int s_q, int lse_row, BwdStrides st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + warp, qh = blockIdx.y, b = blockIdx.z;
  float acc = 0.f;
  if (row < s_q) {
    const T* o = out + b * st.sb[BO] + qh * st.sh[BO] + (long long)row * st.ss[BO];
    const T* g = dout + b * st.sb[BDO] + qh * st.sh[BDO] + (long long)row * st.ss[BDO];
#pragma unroll
    for (int x = 2 * lane; x < HD; x += 64) {
      acc = fmaf(to_f32(o[x]), to_f32(g[x]), acc);
      acc = fmaf(to_f32(o[x + 1]), to_f32(g[x + 1]), acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) dsum[((long long)b * n_q + qh) * lse_row + row] = acc;
}

// dK and dV of 128 keys of one kv head (64 a consumer warpgroup), over every
// query head of its group
template <typename T, int HD>
static __global__ void __launch_bounds__(BW_THREADS, 1) fa_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ dsum, T* __restrict__ dk,
    T* __restrict__ dv, int n_q, int n_kv, int s_q, int s_k, int causal, int window,
    int q_offset, int lse_row, float scale_log2, float scale, MapCoord cq, MapCoord ck,
    MapCoord cv, MapCoord cdo, BwdStrides st) {
  using C = BwCfg<HD>;
  constexpr int SUB = C::SUB, TILE = C::TILE, STAGES = C::STAGES, QB = BW_ROWS;
  extern __shared__ unsigned char bw_smem[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 1024 bytes
  const uint32_t raw = smem_addr(bw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + 2 * TILE, q_s = base + C::RING;
  const uint32_t do_s = q_s + STAGES * TILE, stats = base + C::STATS, bar_kv = base + C::BAR;
  const float* stats_p = reinterpret_cast<const float*>(bw_smem + (stats - raw));
  auto bar_f = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  // the key tile varies slowest across the grid: the CTAs that see the most
  // queries (causal: the first key tiles) start first, every head's together
  const int n0 = blockIdx.y * 2 * BW_ROWS;
  const int kh = blockIdx.x, b = blockIdx.z, group = n_q / n_kv;
  // the queries that see any of these keys, [i_lo, i_hi), in tiles of QB
  const int t_hi = min(n0 + 2 * BW_ROWS, s_k) - 1;
  const int i_lo = causal ? max(0, n0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(s_q, t_hi + window - q_offset) : s_q;
  const int m_first = (i_lo / QB) * QB;
  const int n_mt = i_hi > i_lo ? (i_hi - m_first + QB - 1) / QB : 0;
  const int n_iter = group * n_mt;  // steps of (query head, query tile)

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: K and V and the first stages here, each
  // later stage once both warpgroups have released it
  auto issue = [&](int it) {
    const int s = it % STAGES, qh = kh * group + it / n_mt;
    const int m0 = m_first + (it % n_mt) * QB;
    mbar_expect_tx(bar_f(s), 2 * TILE + 512);
    for (int c = 0; c < SUB; ++c) {
      cq.load(q_s + s * TILE + c * BW_BOX, &tm_q, bar_f(s), c * 64, m0, qh, b);
      cdo.load(do_s + s * TILE + c * BW_BOX, &tm_do, bar_f(s), c * 64, m0, qh, b);
    }
    const long long row = ((long long)b * n_q + qh) * lse_row + m0;
    bulk_load(stats + s * 512, lse + row, 256, bar_f(s));
    bulk_load(stats + s * 512 + 256, dsum + row, 256, bar_f(s));
  };
  if (threadIdx.x == 0 && n_iter > 0) {
    mbar_expect_tx(bar_kv, 4 * TILE);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < SUB; ++c) {
        ck.load(k_s + w * TILE + c * BW_BOX, &tm_k, bar_kv, c * 64, n0 + 64 * w, kh, b);
        cv.load(v_s + w * TILE + c * BW_BOX, &tm_v, bar_kv, c * 64, n0 + 64 * w, kh, b);
      }
    for (int it = 0; it < min(STAGES, n_iter); ++it) issue(it);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw0 = n0 + 64 * wg, kw_last = min(kw0 + 63, s_k - 1);  // this warpgroup's keys
  const int key = kw0 + warp * 16 + g;  // this thread's keys: key and key + 8
  const uint32_t k_w = k_s + wg * TILE, v_w = v_s + wg * TILE;
  float dk_acc[SUB][32], dv_acc[SUB][32];
#pragma unroll
  for (int c = 0; c < SUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  if (n_iter > 0) mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES, m0 = m_first + (it % n_mt) * QB;
    const uint32_t q_t = q_s + s * TILE, do_t = do_s + s * TILE;
    const float* lse_t = stats_p + s * 128;
    const float* dd_t = lse_t + 64;
    const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + QB, s_q) - 1;
    // no visible pair: nothing to add; every pair visible: no mask
    const bool none = kw0 >= s_k || (causal && kw0 > p_hi) ||
                      (window > 0 && p_lo - kw_last >= window);
    const bool whole = m0 + QB <= s_q && kw0 + 64 <= s_k && (!causal || kw0 + 63 <= p_lo) &&
                       (window <= 0 || p_hi - kw0 < window);
    mbar_wait(bar_f(s), (it / STAGES) & 1);
    if (!none) {
      // rows: this warpgroup's keys; columns: the tile's queries
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64, T>::ss(sc, kmajor(k_w, kk), kmajor(q_t, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64, T>::ss(dp, kmajor(v_w, kk), kmajor(do_t, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t4);
        const float2 d2 = *reinterpret_cast<const float2*>(dd_t + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (!whole && !fb_visible(m0 + 8 * j + 2 * t4 + (e & 1), key + 8 * (e >> 1), s_q,
                                    s_k, causal, window, q_offset))
            p = 0.f;
          sc[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // P^T and dS^T as A operands: accumulator tiles 2 kk and 2 kk + 1
      // hold queries [16 kk, 16 kk + 16)
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kk][x] = pack2<T>(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
          dsa[kk][x] = pack2<T>(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < SUB; ++c) {
          Wgmma<64, T>::rs(dv_acc[c], pa[kk], mnmajor(do_t, c, kk));
          Wgmma<64, T>::rs(dk_acc[c], dsa[kk], mnmajor(q_t, c, kk));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        fence_regs(dk_acc[c]);
        fence_regs(dv_acc[c]);
      }
    }
    mbar_arrive(bar_e(s));
    if (threadIdx.x == 0 && it + STAGES < n_iter) {
      mbar_wait(bar_e(s), (it / STAGES) & 1);
      issue(it + STAGES);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key + 8 * r;
    if (t >= s_k) continue;
    T* dkr = dk + b * st.sb[BDK] + kh * st.sh[BDK] + (long long)t * st.ss[BDK];
    T* dvr = dv + b * st.sb[BDV] + kh * st.sh[BDV] + (long long)t * st.ss[BDV];
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + c * 64 + 8 * j + 2 * t4) =
            pack2<T>(dk_acc[c][4 * j + 2 * r] * scale, dk_acc[c][4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + c * 64 + 8 * j + 2 * t4) =
            pack2<T>(dv_acc[c][4 * j + 2 * r], dv_acc[c][4 * j + 2 * r + 1]);
      }
  }
}

// dQ of 128 query rows of one query head (64 a consumer warpgroup)
template <typename T, int HD>
static __global__ void __launch_bounds__(BW_THREADS, 1) fa_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ dsum, T* __restrict__ dq, int n_q,
    int n_kv, int s_q, int s_k, int causal, int window, int q_offset, int lse_row,
    float scale_log2, float scale, MapCoord cq, MapCoord ck, MapCoord cv, MapCoord cdo,
    BwdStrides st) {
  using C = BwCfg<HD>;
  constexpr int SUB = C::SUB, TILE = C::TILE, STAGES = C::STAGES, BN = BW_ROWS;
  extern __shared__ unsigned char bw_smem[];
  const uint32_t raw = smem_addr(bw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + 2 * TILE, k_s = base + C::RING;
  const uint32_t v_s = k_s + STAGES * TILE, bar_q = base + C::BAR;
  auto bar_f = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  // the longest rows first, every head's together
  const int n_mb = (s_q + 2 * BW_ROWS - 1) / (2 * BW_ROWS);
  const int m0 = (n_mb - 1 - blockIdx.y) * 2 * BW_ROWS;
  const int qh = blockIdx.x, b = blockIdx.z, kh = qh / (n_q / n_kv);
  // the keys any row of this CTA may see, in whole tiles
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + 2 * BW_ROWS, s_q) - 1;
  const int k_end = causal ? min(s_k, p_hi + 1) : s_k;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_begin = k_begin / BN;
  const int n_tiles = max(0, (k_end + BN - 1) / BN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy, as in the dK/dV kernel
  auto issue = [&](int i) {
    const int s = i % STAGES, n0 = (t_begin + i) * BN;
    mbar_expect_tx(bar_f(s), 2 * TILE);
    for (int c = 0; c < SUB; ++c) {
      ck.load(k_s + s * TILE + c * BW_BOX, &tm_k, bar_f(s), c * 64, n0, kh, b);
      cv.load(v_s + s * TILE + c * BW_BOX, &tm_v, bar_f(s), c * 64, n0, kh, b);
    }
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, 4 * TILE);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < SUB; ++c) {
        cq.load(q_s + w * TILE + c * BW_BOX, &tm_q, bar_q, c * 64, m0 + 64 * w, qh, b);
        cdo.load(do_s + w * TILE + c * BW_BOX, &tm_do, bar_q, c * 64, m0 + 64 * w, qh, b);
      }
    for (int i = 0; i < min(STAGES, n_tiles); ++i) issue(i);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = m0 + 64 * wg;         // this warpgroup's first row
  const int row = r0 + warp * 16 + g;  // this thread's rows: row and row + 8
  const bool ok[2] = {row < s_q, row + 8 < s_q};
  // the warpgroup's positions, for the tests of a tile
  const int w_lo = q_offset + r0, w_hi = q_offset + min(r0 + 63, s_q - 1);
  // rows up to lse_row (a multiple of 128) are allocated: past s_q they are
  // read and masked
  const long long rb = ((long long)b * n_q + qh) * lse_row;
  const float lr[2] = {lse[rb + row], lse[rb + row + 8]};
  const float dd[2] = {dsum[rb + row], dsum[rb + row + 8]};
  const uint32_t q_w = q_s + wg * TILE, do_w = do_s + wg * TILE;
  float dq_acc[SUB][32];
#pragma unroll
  for (int c = 0; c < SUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[c][i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, n0 = (t_begin + i) * BN;
    const uint32_t k_t = k_s + s * TILE, v_t = v_s + s * TILE;
    const int t_last = min(n0 + BN - 1, s_k - 1);
    const bool none = r0 >= s_q || (causal && n0 > w_hi) ||
                      (window > 0 && w_lo - t_last >= window);
    const bool whole = r0 + 64 <= s_q && n0 + BN <= s_k && (!causal || n0 + BN - 1 <= w_lo) &&
                       (window <= 0 || w_hi - n0 < window);
    mbar_wait(bar_f(s), (i / STAGES) & 1);
    if (!none) {
      // rows: this warpgroup's queries; columns: the tile's keys
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64, T>::ss(sc, kmajor(q_w, kk), kmajor(k_t, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<64, T>::ss(dp, kmajor(do_w, kk), kmajor(v_t, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lr[r]));
          if (!whole && !fb_visible(row + 8 * r, n0 + 8 * j + 2 * t4 + (e & 1), s_q, s_k,
                                    causal, window, q_offset))
            p = 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - dd[r]);
        }
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dsa[kk][x] = pack2<T>(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < SUB; ++c) Wgmma<64, T>::rs(dq_acc[c], dsa[kk], mnmajor(k_t, c, kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < SUB; ++c) fence_regs(dq_acc[c]);
    }
    mbar_arrive(bar_e(s));
    if (threadIdx.x == 0 && i + STAGES < n_tiles) {
      mbar_wait(bar_e(s), (i / STAGES) & 1);
      issue(i + STAGES);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    T* dqr = dq + b * st.sb[BDQ] + qh * st.sh[BDQ] + (long long)(row + 8 * r) * st.ss[BDQ];
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dqr + c * 64 + 8 * j + 2 * t4) =
            pack2<T>(dq_acc[c][4 * j + 2 * r] * scale, dq_acc[c][4 * j + 2 * r + 1] * scale);
  }
}

template <typename T, int HD>
static int launch_flash_bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  const float* lse, float* dsum, int b, int n_q, int n_kv,
                                  int s_q, int s_k, int causal, int window, int q_offset,
                                  int lse_row, const BwdStrides& st, cudaStream_t stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv, tdo;
  MapCoord cq, ck, cv, cdo;
  if (!encode_map(&tq, q, BF, HD, s_q, n_q, b, st.ss[BQ], st.sh[BQ], st.sb[BQ], BW_ROWS, &cq) ||
      !encode_map(&tk, k, BF, HD, s_k, n_kv, b, st.ss[BK], st.sh[BK], st.sb[BK], BW_ROWS, &ck) ||
      !encode_map(&tv, v, BF, HD, s_k, n_kv, b, st.ss[BV], st.sh[BV], st.sb[BV], BW_ROWS, &cv) ||
      !encode_map(&tdo, dout, BF, HD, s_q, n_q, b, st.ss[BDO], st.sh[BDO], st.sb[BDO], BW_ROWS,
                  &cdo))
    return (int)cudaErrorInvalidValue;
  const int smem = BwCfg<HD>::SMEM;
  cudaFuncSetAttribute(fa_bwd_dkdv_wgmma_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const float scale = softmax_scale(HD), scale_log2 = softmax_scale(HD) * LOG2E;
  fa_bwd_pre_kernel<T, HD><<<dim3(lse_row / 8, n_q, b), 256, 0, stream>>>(
      (const T*)out, (const T*)dout, dsum, n_q, s_q, lse_row, st);
  fa_bwd_dkdv_wgmma_kernel<T, HD>
      <<<dim3(n_kv, (s_k + 2 * BW_ROWS - 1) / (2 * BW_ROWS), b), BW_THREADS, smem, stream>>>(
          tq, tk, tv, tdo, lse, dsum, (T*)dk, (T*)dv, n_q, n_kv, s_q, s_k, causal, window,
          q_offset, lse_row, scale_log2, scale, cq, ck, cv, cdo, st);
  fa_bwd_dq_wgmma_kernel<T, HD>
      <<<dim3(n_q, (s_q + 2 * BW_ROWS - 1) / (2 * BW_ROWS), b), BW_THREADS, smem, stream>>>(
          tq, tk, tv, tdo, lse, dsum, (T*)dq, n_q, n_kv, s_q, s_k, causal, window, q_offset,
          lse_row, scale_log2, scale, cq, ck, cv, cdo, st);
  return 0;
}

template <typename T>
static int launch_flash_bwd_wgmma256(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, void* dq, void* dk,
                                     void* dv, const float* lse, float* dsum, int b, int n_q,
                                     int n_kv, int s_q, int s_k, int causal, int window,
                                     int q_offset, int lse_row, const BwdStrides& st,
                                     cudaStream_t stream);

template <typename T>
static int launch_flash_bwd_wgmma_d(int d, const void* q, const void* k, const void* v,
                                    const void* out, const void* dout, void* dq, void* dk,
                                    void* dv, const float* lse, float* dsum, int b, int n_q,
                                    int n_kv, int s_q, int s_k, int causal, int window,
                                    int q_offset, int lse_row, const BwdStrides& st,
                                    cudaStream_t stream) {
  if (d == 64)
    return launch_flash_bwd_wgmma<T, 64>(q, k, v, out, dout, dq, dk, dv, lse, dsum, b, n_q, n_kv,
                                         s_q, s_k, causal, window, q_offset, lse_row, st, stream);
  if (d == 128)
    return launch_flash_bwd_wgmma<T, 128>(q, k, v, out, dout, dq, dk, dv, lse, dsum, b, n_q,
                                          n_kv, s_q, s_k, causal, window, q_offset, lse_row, st,
                                          stream);
  if (d == 256)
    return launch_flash_bwd_wgmma256<T>(q, k, v, out, dout, dq, dk, dv, lse, dsum, b, n_q, n_kv,
                                        s_q, s_k, causal, window, q_offset, lse_row, st, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernels at d = 256 (bfloat16 / float16: gemma3-4b's heads)
//
// A 64-key x 256 tile of both dK and dV would be 256 floats a thread of a
// warpgroup, so the dK/dV CTA splits its two warpgroups by role over the
// same 64 keys: warpgroup 0 owns dV (S^T = K Q^T, P^T, dV += P^T dO) and
// warpgroup 1 dK (dP^T = V dO^T, dS^T from P^T, dK += dS^T Q), 128 + 32
// floats a thread each. P^T crosses from warpgroup 0 to warpgroup 1 through
// shared memory as float32 in the accumulator's layout (thread t of one
// reads what thread t of the other wrote), under two named barriers: "full"
// (P^T written) and "free" (P^T read). The dQ CTA holds 128 query rows (64 a
// warpgroup, a 64 x 256 accumulator) and walks 32-key K and V tiles, so S,
// dP and dS take 16 floats each beside it.

constexpr int B2_SUB = 4;                   // 128-byte column blocks of a 256-wide row
constexpr int B2_TILE = B2_SUB * BW_BOX;    // 64 rows x 256: 32 KB
constexpr int B2_STAGES = 2;                // the dK/dV ring: Q and dO tiles
// dK/dV: K and V resident, the ring of Q and dO, P^T (128 threads x 32
// floats), each stage's lse and D, then the mbarriers
constexpr int B2_KV_RING = 2 * B2_TILE;
constexpr int B2_KV_PT = B2_KV_RING + 2 * B2_STAGES * B2_TILE;
constexpr int B2_KV_STATS = B2_KV_PT + 128 * 32 * 4;
constexpr int B2_KV_BAR = B2_KV_STATS + B2_STAGES * 512;
constexpr int B2_KV_SMEM = 1024 + B2_KV_BAR + 8 * (1 + 2 * B2_STAGES);  // + alignment slack
// dQ: Q and dO resident (128 rows each), 64-key K tiles in two slots and
// V tiles in one (the most 227 KB hold), then the mbarriers: Q's, each K
// slot's "full" and "empty", V's "full" and "empty"
constexpr int B2_DQ_BAR = 7 * B2_TILE;
constexpr int B2_DQ_SMEM = 1024 + B2_DQ_BAR + 8 * 7;
static_assert(B2_KV_SMEM <= 232448 && B2_DQ_SMEM <= 232448, "over the H100's 227 KB a block");
// named barriers of the dK/dV kernel (0 is __syncthreads'): P^T written, P^T read
constexpr int B2_PT_FULL = 1, B2_PT_FREE = 2;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(BW_THREADS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(BW_THREADS) : "memory");
}

// dK and dV of 64 keys of one kv head (warpgroup 0 dV, 1 dK), over every
// query head of its group
template <typename T>
static __global__ void __launch_bounds__(BW_THREADS, 1) fa_bwd_dkdv_wgmma256_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ dsum, T* __restrict__ dk,
    T* __restrict__ dv, int n_q, int n_kv, int s_q, int s_k, int causal, int window,
    int q_offset, int lse_row, float scale_log2, float scale, MapCoord cq, MapCoord ck,
    MapCoord cv, MapCoord cdo, BwdStrides st) {
  constexpr int SUB = B2_SUB, TILE = B2_TILE, STAGES = B2_STAGES, QB = BW_ROWS, KEYS = BW_ROWS;
  extern __shared__ unsigned char bw_smem[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 1024 bytes
  const uint32_t raw = smem_addr(bw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + TILE, q_s = base + B2_KV_RING;
  const uint32_t do_s = q_s + STAGES * TILE, stats = base + B2_KV_STATS;
  const uint32_t bar_kv = base + B2_KV_BAR;
  float* pt = reinterpret_cast<float*>(bw_smem + (base + B2_KV_PT - raw));
  const float* stats_p = reinterpret_cast<const float*>(bw_smem + (stats - raw));
  auto bar_f = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  // the key tile varies slowest across the grid: the CTAs that see the most
  // queries (causal: the first key tiles) start first, every head's together
  const int n0 = blockIdx.y * KEYS;
  const int kh = blockIdx.x, b = blockIdx.z, group = n_q / n_kv;
  // the queries that see any of these keys, [i_lo, i_hi), in tiles of QB
  const int k_last = min(n0 + KEYS, s_k) - 1;
  const int i_lo = causal ? max(0, n0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(s_q, k_last + window - q_offset) : s_q;
  const int m_first = (i_lo / QB) * QB;
  const int n_mt = i_hi > i_lo ? (i_hi - m_first + QB - 1) / QB : 0;
  const int n_iter = group * n_mt;  // steps of (query head, query tile)

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), BW_THREADS);  // every thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step it's Q and dO tiles and (1-d bulk copies) its 64 rows' lse and D
  auto issue = [&](int it) {
    const int s = it % STAGES, qh = kh * group + it / n_mt;
    const int m0 = m_first + (it % n_mt) * QB;
    mbar_expect_tx(bar_f(s), 2 * TILE + 512);
    for (int c = 0; c < SUB; ++c) {
      cq.load(q_s + s * TILE + c * BW_BOX, &tm_q, bar_f(s), c * 64, m0, qh, b);
      cdo.load(do_s + s * TILE + c * BW_BOX, &tm_do, bar_f(s), c * 64, m0, qh, b);
    }
    // rows up to lse_row (a multiple of 128) are allocated: past s_q they
    // are read and masked
    const long long row = ((long long)b * n_q + qh) * lse_row + m0;
    bulk_load(stats + s * 512, lse + row, 256, bar_f(s));
    bulk_load(stats + s * 512 + 256, dsum + row, 256, bar_f(s));
  };
  if (threadIdx.x == 0 && n_iter > 0) {
    mbar_expect_tx(bar_kv, 2 * TILE);
    for (int c = 0; c < SUB; ++c) {
      ck.load(k_s + c * BW_BOX, &tm_k, bar_kv, c * 64, n0, kh, b);
      cv.load(v_s + c * BW_BOX, &tm_v, bar_kv, c * 64, n0, kh, b);
    }
    for (int it = 0; it < min(STAGES, n_iter); ++it) issue(it);
  }

  const int wg = threadIdx.x / 128;  // 0: dV, 1: dK
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int key = n0 + warp * 16 + g;  // this thread's keys: key and key + 8
  // the first product's A operand: K (S^T = K Q^T) or V (dP^T = V dO^T)
  const uint32_t a_w = wg ? v_s : k_s;
  float* pt_t = pt + tid;
  float acc[SUB][32];  // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int c = 0; c < SUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  if (n_iter > 0) mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES, m0 = m_first + (it % n_mt) * QB;
    const uint32_t q_t = q_s + s * TILE, do_t = do_s + s * TILE;
    const float* lse_t = stats_p + s * 128;
    const float* dd_t = lse_t + 64;
    const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + QB, s_q) - 1;
    // every pair visible: no mask (the same for both warpgroups, which hold
    // the same keys); every step sees some pair, the query tiles being cut
    // to the keys' visible range
    const bool whole = m0 + QB <= s_q && n0 + KEYS <= s_k && (!causal || n0 + KEYS - 1 <= p_lo) &&
                       (window <= 0 || p_hi - n0 < window);
    mbar_wait(bar_f(s), (it / STAGES) & 1);
    // rows: the keys; columns: the tile's queries
    float x[32];
    const uint32_t b_t = wg ? do_t : q_t;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) Wgmma<64, T>::ss(x, kmajor(a_w, kk), kmajor(b_t, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if (wg == 0) {  // P^T = exp2(S^T scale_log2 - lse), to warpgroup 1
      if (it > 0) named_sync(B2_PT_FREE);  // the last step's P^T has been read
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(x[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (!whole && !fb_visible(m0 + 8 * j + 2 * t4 + (e & 1), key + 8 * (e >> 1), s_q,
                                    s_k, causal, window, q_offset))
            p = 0.f;
          x[4 * j + e] = p;
          pt_t[(4 * j + e) * 128] = p;
        }
      }
      named_arrive(B2_PT_FULL);
    } else {  // dS^T = P^T o (dP^T - D)
      named_sync(B2_PT_FULL);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dd_t + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = pt_t[(4 * j + e) * 128] * (x[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      named_arrive(B2_PT_FREE);
    }
    // P^T or dS^T as A operands: accumulator tiles 2 kk and 2 kk + 1 hold
    // queries [16 kk, 16 kk + 16); dV += P^T dO, dK += dS^T Q with dO and
    // Q read MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x2 = 0; x2 < 4; ++x2)
        a[kk][x2] = pack2<T>(x[8 * kk + 2 * x2], x[8 * kk + 2 * x2 + 1]);
    const uint32_t bm_t = wg ? q_t : do_t;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < SUB; ++c) Wgmma<64, T>::rs(acc[c], a[kk], mnmajor(bm_t, c, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < SUB; ++c) fence_regs(acc[c]);
    mbar_arrive(bar_e(s));
    // warpgroup 1 finishes a step last (its product waits for P^T), so its
    // first thread refills the stage
    if (threadIdx.x == 128 && it + STAGES < n_iter) {
      mbar_wait(bar_e(s), (it / STAGES) & 1);
      issue(it + STAGES);
    }
  }
  // every "free" arrival is waited for before the CTA ends
  if (wg == 0 && n_iter > 0) named_sync(B2_PT_FREE);

  T* dst = wg ? dk : dv;
  const int bi = wg ? BDK : BDV;
  const float mul = wg ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key + 8 * r;
    if (t >= s_k) continue;
    T* row = dst + b * st.sb[bi] + kh * st.sh[bi] + (long long)t * st.ss[bi];
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(row + c * 64 + 8 * j + 2 * t4) =
            pack2<T>(acc[c][4 * j + 2 * r] * mul, acc[c][4 * j + 2 * r + 1] * mul);
  }
}

// dQ of 128 query rows of one query head (64 a warpgroup), over 64-key
// tiles. K has two slots and V one: thread 0 refills K (i + 1) while S and
// dP (i) run, once both warpgroups have released K (i - 1), and V (i + 1)
// while dQ += dS K (i) runs, once both have finished dP (i).
template <typename T>
static __global__ void __launch_bounds__(BW_THREADS, 1) fa_bwd_dq_wgmma256_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ dsum, T* __restrict__ dq, int n_q,
    int n_kv, int s_q, int s_k, int causal, int window, int q_offset, int lse_row,
    float scale_log2, float scale, MapCoord cq, MapCoord ck, MapCoord cv, MapCoord cdo,
    BwdStrides st) {
  constexpr int SUB = B2_SUB, TILE = B2_TILE, BN = BW_ROWS;
  extern __shared__ unsigned char bw_smem[];
  const uint32_t raw = smem_addr(bw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + 2 * TILE, k_s = base + 4 * TILE;
  const uint32_t v_s = base + 6 * TILE, bar_q = base + B2_DQ_BAR;
  auto bar_fk = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_ek = [&](int s) { return bar_q + 8u * (3 + s); };
  const uint32_t bar_fv = bar_q + 40u, bar_ev = bar_q + 48u;

  // the longest rows first, every head's together
  const int n_mb = (s_q + 2 * BW_ROWS - 1) / (2 * BW_ROWS);
  const int m0 = (n_mb - 1 - blockIdx.y) * 2 * BW_ROWS;
  const int qh = blockIdx.x, b = blockIdx.z, kh = qh / (n_q / n_kv);
  // the keys any row of this CTA may see, in whole tiles
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + 2 * BW_ROWS, s_q) - 1;
  const int k_end = causal ? min(s_k, p_hi + 1) : s_k;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_begin = k_begin / BN;
  const int n_tiles = max(0, (k_end + BN - 1) / BN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_fk(s), 1);
      mbar_init(bar_ek(s), BW_THREADS);
    }
    mbar_init(bar_fv, 1);
    mbar_init(bar_ev, BW_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile i's K (into slot i % 2) or V, issued by thread 0
  auto issue = [&](const CUtensorMap* map, const MapCoord& co, uint32_t dst, uint32_t bar, int i) {
    mbar_expect_tx(bar, TILE);
    for (int c = 0; c < SUB; ++c)
      co.load(dst + c * BW_BOX, map, bar, c * 64, (t_begin + i) * BN, kh, b);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, 4 * TILE);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < SUB; ++c) {
        cq.load(q_s + w * TILE + c * BW_BOX, &tm_q, bar_q, c * 64, m0 + 64 * w, qh, b);
        cdo.load(do_s + w * TILE + c * BW_BOX, &tm_do, bar_q, c * 64, m0 + 64 * w, qh, b);
      }
    for (int i = 0; i < min(2, n_tiles); ++i) issue(&tm_k, ck, k_s + i * TILE, bar_fk(i), i);
    issue(&tm_v, cv, v_s, bar_fv, 0);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = m0 + 64 * wg;         // this warpgroup's first row
  const int row = r0 + warp * 16 + g;  // this thread's rows: row and row + 8
  const bool ok[2] = {row < s_q, row + 8 < s_q};
  // the warpgroup's positions, for the tests of a tile
  const int w_lo = q_offset + r0, w_hi = q_offset + min(r0 + 63, s_q - 1);
  // rows up to lse_row (a multiple of 128) are allocated: past s_q they are
  // read and masked
  const long long rb = ((long long)b * n_q + qh) * lse_row;
  const float lr[2] = {lse[rb + row], lse[rb + row + 8]};
  const float dd[2] = {dsum[rb + row], dsum[rb + row + 8]};
  const uint32_t q_w = q_s + wg * TILE, do_w = do_s + wg * TILE;
  float dq_acc[SUB][32];
#pragma unroll
  for (int c = 0; c < SUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[c][i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int ks = i % 2, n0 = (t_begin + i) * BN;
    const uint32_t k_t = k_s + ks * TILE;
    // every pair of the tile visible to this warpgroup's rows: no mask. A
    // tile none of whose pairs is visible runs too, its P masked to 0: a
    // branch around the products has ptxas serialize them (C7520)
    const bool whole = r0 + 64 <= s_q && n0 + BN <= s_k && (!causal || n0 + BN - 1 <= w_lo) &&
                       (window <= 0 || w_hi - n0 < window);
    // rows: this warpgroup's queries; columns: the tile's keys
    float sc[32], dp[32];
    // S and dP as two commit groups: a wait on V between products of one
    // group would have ptxas serialize every product (C7520)
    mbar_wait(bar_fk(ks), (i / 2) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) Wgmma<64, T>::ss(sc, kmajor(q_w, kk), kmajor(k_t, kk), kk > 0);
    wgmma_commit();
    mbar_wait(bar_fv, i & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) Wgmma<64, T>::ss(dp, kmajor(do_w, kk), kmajor(v_s, kk), kk > 0);
    wgmma_commit();
    // K (i + 1) into the slot of K (i - 1), once both warpgroups are done
    // with it
    if (threadIdx.x == 0 && i >= 1 && i + 1 < n_tiles) {
      mbar_wait(bar_ek(1 - ks), ((i - 1) / 2) & 1);
      issue(&tm_k, ck, k_s + (1 - ks) * TILE, bar_fk(1 - ks), i + 1);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(bar_ev);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lr[r]));
        if (!whole && !fb_visible(row + 8 * r, n0 + 8 * j + 2 * t4 + (e & 1), s_q, s_k, causal,
                                  window, q_offset))
          p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dd[r]);
      }
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) dsa[kk][x] = pack2<T>(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
    // dQ += dS K, K read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < SUB; ++c) Wgmma<64, T>::rs(dq_acc[c], dsa[kk], mnmajor(k_t, c, kk));
    wgmma_commit();
    // V (i + 1), once both warpgroups are done with V (i)
    if (threadIdx.x == 0 && i + 1 < n_tiles) {
      mbar_wait(bar_ev, i & 1);
      issue(&tm_v, cv, v_s, bar_fv, i + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < SUB; ++c) fence_regs(dq_acc[c]);
    mbar_arrive(bar_ek(ks));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    T* dqr = dq + b * st.sb[BDQ] + qh * st.sh[BDQ] + (long long)(row + 8 * r) * st.ss[BDQ];
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dqr + c * 64 + 8 * j + 2 * t4) =
            pack2<T>(dq_acc[c][4 * j + 2 * r] * scale, dq_acc[c][4 * j + 2 * r + 1] * scale);
  }
}

template <typename T>
static int launch_flash_bwd_wgmma256(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, void* dq, void* dk,
                                     void* dv, const float* lse, float* dsum, int b, int n_q,
                                     int n_kv, int s_q, int s_k, int causal, int window,
                                     int q_offset, int lse_row, const BwdStrides& st,
                                     cudaStream_t stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv, tdo;
  MapCoord cq, ck, cv, cdo;
  if (!encode_map(&tq, q, BF, 256, s_q, n_q, b, st.ss[BQ], st.sh[BQ], st.sb[BQ], BW_ROWS, &cq) ||
      !encode_map(&tk, k, BF, 256, s_k, n_kv, b, st.ss[BK], st.sh[BK], st.sb[BK], BW_ROWS, &ck) ||
      !encode_map(&tv, v, BF, 256, s_k, n_kv, b, st.ss[BV], st.sh[BV], st.sb[BV], BW_ROWS, &cv) ||
      !encode_map(&tdo, dout, BF, 256, s_q, n_q, b, st.ss[BDO], st.sh[BDO], st.sb[BDO], BW_ROWS,
                  &cdo))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(fa_bwd_dkdv_wgmma256_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, B2_KV_SMEM);
  cudaFuncSetAttribute(fa_bwd_dq_wgmma256_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       B2_DQ_SMEM);
  const float scale = softmax_scale(256), scale_log2 = softmax_scale(256) * LOG2E;
  fa_bwd_pre_kernel<T, 256><<<dim3(lse_row / 8, n_q, b), 256, 0, stream>>>(
      (const T*)out, (const T*)dout, dsum, n_q, s_q, lse_row, st);
  fa_bwd_dkdv_wgmma256_kernel<T>
      <<<dim3(n_kv, (s_k + BW_ROWS - 1) / BW_ROWS, b), BW_THREADS, B2_KV_SMEM, stream>>>(
          tq, tk, tv, tdo, lse, dsum, (T*)dk, (T*)dv, n_q, n_kv, s_q, s_k, causal, window,
          q_offset, lse_row, scale_log2, scale, cq, ck, cv, cdo, st);
  fa_bwd_dq_wgmma256_kernel<T>
      <<<dim3(n_q, (s_q + 2 * BW_ROWS - 1) / (2 * BW_ROWS), b), BW_THREADS, B2_DQ_SMEM,
         stream>>>(tq, tk, tv, tdo, lse, dsum, (T*)dq, n_q, n_kv, s_q, s_k, causal, window,
                   q_offset, lse_row, scale_log2, scale, cq, ck, cv, cdo, st);
  return 0;
}

}  // namespace ckv

// q, out, dout, dq (b, n_q, s_q, d); k, v, dk, dv (b, n_kv, s_k, d), all of
// one dtype, each with element strides (batch, head, position) and a
// contiguous head dim, rows 16-byte aligned; strides holds the 8 triples in
// the order q, k, v, out, dout, dq, dk, dv. lse and dsum: float32
// (b, n_q, s_q) with rows lse_row >= s_q floats apart. variant 0
// (cuda_core_f32: any of the three dtypes, d in {16, 32, 64, 128}): both are
// scratch, which the stats pass fills. variant 2 (wgmma: bfloat16/float16,
// d in {64, 128, 256}), with lse_row a multiple of 128: lse is the
// logsumexp the wgmma forward wrote (log2 units) and dsum scratch, rows past
// s_q included.
extern "C" int ckv_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* dsum, int b, int n_q,
                                       int n_kv, int s_q, int s_k, int d, int causal,
                                       int window, int q_offset, int lse_row,
                                       const long long* strides, int dtype, int variant,
                                       void* stream) {
  ckv::BwdStrides st;
  for (int t = 0; t < 8; ++t) {
    st.sb[t] = strides[3 * t];
    st.sh[t] = strides[3 * t + 1];
    st.ss[t] = strides[3 * t + 2];
  }
  cudaStream_t s = (cudaStream_t)stream;
  float *fl = (float*)lse, *fd = (float*)dsum;
  if (lse_row < s_q) return (int)cudaErrorInvalidValue;
  int rc;
  if (variant == 2) {
    if (lse_row % 128) return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case ckv::BF16:
        rc = ckv::launch_flash_bwd_wgmma_d<__nv_bfloat16>(d, q, k, v, out, dout, dq, dk, dv, fl,
                                                          fd, b, n_q, n_kv, s_q, s_k, causal,
                                                          window, q_offset, lse_row, st, s);
        break;
      case ckv::F16:
        rc = ckv::launch_flash_bwd_wgmma_d<__half>(d, q, k, v, out, dout, dq, dk, dv, fl, fd, b,
                                                   n_q, n_kv, s_q, s_k, causal, window, q_offset,
                                                   lse_row, st, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else if (variant == 0) {
    switch (dtype) {
      case ckv::F32:
        rc = ckv::launch_flash_bwd_d<float>(d, q, k, v, out, dout, dq, dk, dv, fl, fd, b, n_q,
                                            n_kv, s_q, s_k, causal, window, q_offset, lse_row,
                                            st, s);
        break;
      case ckv::BF16:
        rc = ckv::launch_flash_bwd_d<__nv_bfloat16>(d, q, k, v, out, dout, dq, dk, dv, fl, fd,
                                                    b, n_q, n_kv, s_q, s_k, causal, window,
                                                    q_offset, lse_row, st, s);
        break;
      case ckv::F16:
        rc = ckv::launch_flash_bwd_d<__half>(d, q, k, v, out, dout, dq, dk, dv, fl, fd, b, n_q,
                                             n_kv, s_q, s_k, causal, window, q_offset, lse_row,
                                             st, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
