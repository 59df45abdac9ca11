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
// Three kernels, one after another on the caller's stream:
//
// * stats: a CTA per (request, query head, 64 query rows) recomputes the
//   row max and sum over the visible key tiles (the forward's float32 online
//   softmax) into a float32 logsumexp, and D from the O and dO tiles;
// * dK/dV: a CTA per (request, kv head, 64 keys) holds its K and V tiles and
//   walks, for each query head of the group, the query tiles that see any of
//   its keys: P = exp(S - lse), dP, dS, then dV += P^T dO and dK += dS^T Q,
//   accumulated in float32 registers (4 keys x d / 16 columns a thread) and
//   written once;
// * dQ: a CTA per (request, query head, 64 query rows) walks the visible key
//   tiles: dQ += dS K.
//
// Every sum runs in a fixed order and each gradient element is written by
// one thread: no atomics, the same bits on every run. All arithmetic is
// float32 on the CUDA cores (the forward's 64 x 64 tiles and 4 x 4 scores a
// thread, common.cuh), with inputs of any float dtype widened as they are
// loaded and each gradient rounded once to its input's dtype.
//
// Bound on the H100 at qwen3-1.7b's training shape (b 1, 16 query heads over
// 8 kv heads, s 4096, d 128, causal): five products over the s^2 / 2
// visible pairs, 5 x 2 x 8.4e6 x 128 x 16 = 1.7e11 operations, 0.17 ms at the
// tensor cores' 989 TFLOP/s or 2.6 ms at the CUDA cores' 67 TFLOP/s in
// float32; ~100 MB of q, k, v, O, dO and the gradients, 0.03 ms. These
// kernels recompute S three times and P twice (eight products) on the CUDA
// cores, reading every operand from shared memory: simple and deterministic
// first. mma.sync or wgmma products, TMA loads and one pass for dK, dV and
// dQ are later work (ROADMAP queue 2).
#include "common.cuh"

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
    int n_kv, int s_q, int s_k, int causal, int window, int q_offset, float scale,
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
      const long long row = ((long long)b * n_q + qh) * s_q + m0 + r;
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
    int window, int q_offset, float scale, BwdStrides st) {
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
    const long long row0 = ((long long)b * n_q + qh) * s_q;
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
    int q_offset, float scale, BwdStrides st) {
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
  const long long row0 = ((long long)b * n_q + qh) * s_q;
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
                            int window, int q_offset, const BwdStrides& st,
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
      q_offset, scale, st);
  fa_bwd_dkdv_kernel<T, HD><<<dim3(n_kb, n_kv, b), NT, smem_dkdv, stream>>>(
      tq, tk, tv, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, n_q, n_kv, s_q, s_k, causal, window,
      q_offset, scale, st);
  fa_bwd_dq_kernel<T, HD><<<dim3(n_qb, n_q, b), NT, smem_dq, stream>>>(
      tq, tk, tv, (const T*)dout, lse, dsum, (T*)dq, n_q, n_kv, s_q, s_k, causal, window,
      q_offset, scale, st);
  return 0;
}

template <typename T>
static int launch_flash_bwd_d(int d, const void* q, const void* k, const void* v,
                              const void* out, const void* dout, void* dq, void* dk, void* dv,
                              float* lse, float* dsum, int b, int n_q, int n_kv, int s_q,
                              int s_k, int causal, int window, int q_offset,
                              const BwdStrides& st, cudaStream_t stream) {
#define CKV_FB_CASE(HD)                                                                      \
  case HD:                                                                                   \
    return launch_flash_bwd<T, HD>(q, k, v, out, dout, dq, dk, dv, lse, dsum, b, n_q, n_kv, \
                                   s_q, s_k, causal, window, q_offset, st, stream);
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

}  // namespace ckv

// q, out, dout, dq (b, n_q, s_q, d); k, v, dk, dv (b, n_kv, s_k, d), all of
// one dtype, each with element strides (batch, head, position) and a
// contiguous head dim, rows 16-byte aligned; strides holds the 8 triples in
// the order q, k, v, out, dout, dq, dk, dv. lse and dsum: float32 scratch of
// b * n_q * s_q each. d in {16, 32, 64, 128}.
extern "C" int ckv_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* dsum, int b, int n_q,
                                       int n_kv, int s_q, int s_k, int d, int causal,
                                       int window, int q_offset, const long long* strides,
                                       int dtype, void* stream) {
  ckv::BwdStrides st;
  for (int t = 0; t < 8; ++t) {
    st.sb[t] = strides[3 * t];
    st.sh[t] = strides[3 * t + 1];
    st.ss[t] = strides[3 * t + 2];
  }
  cudaStream_t s = (cudaStream_t)stream;
  float *fl = (float*)lse, *fd = (float*)dsum;
  int rc;
  switch (dtype) {
    case ckv::F32:
      rc = ckv::launch_flash_bwd_d<float>(d, q, k, v, out, dout, dq, dk, dv, fl, fd, b, n_q,
                                          n_kv, s_q, s_k, causal, window, q_offset, st, s);
      break;
    case ckv::BF16:
      rc = ckv::launch_flash_bwd_d<__nv_bfloat16>(d, q, k, v, out, dout, dq, dk, dv, fl, fd, b,
                                                  n_q, n_kv, s_q, s_k, causal, window, q_offset,
                                                  st, s);
      break;
    case ckv::F16:
      rc = ckv::launch_flash_bwd_d<__half>(d, q, k, v, out, dout, dq, dk, dv, fl, fd, b, n_q,
                                           n_kv, s_q, s_k, causal, window, q_offset, st, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
