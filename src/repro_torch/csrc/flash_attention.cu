// flash_attention: causal (optionally sliding-window) GQA attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (_flash_kernel): query i at position q_offset + i attends
// to key t if t <= q_offset + i (causal) and q_offset + i - t < window
// (window > 0), by a tiled online softmax with float32 scores, running
// max/sum and accumulator; the output is rounded once to q's dtype. Any
// s_q, s_k (the TPU kernel asserted whole blocks) and any group n_q / n_kv
// (hymba's is 5). Key tiles that the causal mask or the window removes
// entirely are skipped. Tensors come with (batch, head, position) strides
// and a contiguous head dim, so the model's (b, s, n, d) projections are read
// in place, and the output is written with the strides the caller gives.
//
// Two kernels, by dtype:
//
// * bfloat16 / float16 (the model path): one CTA of 4 warps per (request,
//   query head, 64 query rows); each warp owns 16 rows. Q K^T and P V run on
//   the tensor cores as mma.sync m16n8k16 with float32 accumulation, the
//   operands fed by ldmatrix from padded shared-memory tiles (row stride
//   d + 8 elements: the eight rows of an 8 x 8 matrix fall on distinct
//   banks). The scores, the online softmax and the output stay in registers
//   in the mma accumulator layout; P is rounded to the input dtype as the A
//   operand of P V (the TPU kernel kept P in float32: here the output differs
//   from a float32 P by about one ulp of the output dtype). K and V tiles
//   arrive by cp.async, V's load overlapping Q K^T and the softmax.
// * float32: the same work on the CUDA cores in float32 (64 x 64 tiles,
//   4 x 4 scores per thread, common.cuh), so a float32 model keeps float32
//   scores and products.
//
// Bound on the H100 at the hybrid prefill (25 query heads over 5 kv heads,
// s = 4160, d = 64, bfloat16): 4 x 25 x 64 x 4160 x 4161 / 2 = 5.5e10
// operations of products, ~0.056 ms at 989 TFLOP/s, against ~9.6 MB of
// Q, K, V and output (~0.003 ms): operations bound it. This first version
// uses mma.sync (no wgmma, no TMA) and reloads each K/V tile once per query
// head of its group.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace ckv {

constexpr int FA_BM = 64;  // query rows per CTA (16 per warp)
constexpr int FA_BN = 64;  // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] * b[16x8], float32 accumulation
template <typename T>
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats as one register of two 16-bit values, the first in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy; a false predicate fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + 64) of a (positions, HD) slab with row stride `ss` into a
// shared tile of row stride HD + 8; rows at or past `n_rows` are zeros
template <typename T, int HD>
__device__ __forceinline__ void tile_async(T* dst, const T* src, long long ss, int r0,
                                           int n_rows) {
  constexpr int VPR = HD / 8, LD = HD + 8;
  for (int i = threadIdx.x; i < FA_BM * VPR; i += blockDim.x) {
    int r = i / VPR, c = (i % VPR) * 8;
    bool ok = r0 + r < n_rows;
    cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * ss + c : src, ok);
  }
}

// Rows are the CTA's query positions, keys one 64-key tile per step.
template <typename T, int HD>
static __global__ void __launch_bounds__(128) flash_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    int n_q, int n_kv, int s_q, int s_k, int causal, int window, int q_offset, float scale_log2,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss) {
  constexpr int LD = HD + 8, KT = HD / 16, NT8 = FA_BN / 8, DT8 = HD / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* qs = reinterpret_cast<T*>(fa_smem);  // [64][LD]
  T* ks = qs + FA_BM * LD;                // [64][LD]
  T* vs = ks + FA_BN * LD;                // [64][LD]
  const int n_mb = (s_q + FA_BM - 1) / FA_BM;
  const int m0 = (n_mb - 1 - blockIdx.x) * FA_BM;  // the longest rows first
  const int qh = blockIdx.y, b = blockIdx.z, kh = qh / (n_q / n_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const T* qb = q + b * q_sb + qh * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // the keys any row of this CTA may see
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + FA_BM, s_q) - 1;
  const int k_end = causal ? min(s_k, p_hi + 1) : s_k;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int kb_begin = k_begin / FA_BN, kb_end = (k_end + FA_BN - 1) / FA_BN;

  tile_async<T, HD>(qs, qb, q_ss, m0, s_q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + kk * 16 +
                        8 * (lane / 16));

  float o[DT8][4];
#pragma unroll
  for (int j = 0; j < DT8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {CKV_NEG_INF, CKV_NEG_INF}, l_run[2] = {0.f, 0.f};
  const int row = m0 + warp * 16 + g;  // this thread's rows: row and row + 8
  const bool ok[2] = {row < s_q, row + 8 < s_q};
  const int pos[2] = {q_offset + row, q_offset + row + 8};

  for (int kbi = kb_begin; kbi < kb_end; ++kbi) {
    const int n0 = kbi * FA_BN;
    __syncthreads();  // every warp is done with the previous K and V tiles
    tile_async<T, HD>(ks, kb, k_ss, n0, s_k);
    cp_async_commit();
    tile_async<T, HD>(vs, vb, v_ss, n0, s_k);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    float sc[NT8][4];
#pragma unroll
    for (int j = 0; j < NT8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < NT8 / 2; ++j2) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (j2 * 16 + (lane % 8) + 8 * (lane / 16)) * LD + kk * 16 +
                        8 * ((lane / 8) % 2));
        mma16816<T>(sc[2 * j2], qf[kk], bf[0], bf[1]);
        mma16816<T>(sc[2 * j2 + 1], qf[kk], bf[2], bf[3]);
      }

    // mask and scale (scores in log2 units), then the online softmax per row
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, t = n0 + j * 8 + 2 * t4 + (e & 1);
        const bool vis = ok[r] && t < s_k && (!causal || t <= pos[r]) &&
                         (window <= 0 || pos[r] - t < window);
        sc[j][e] = vis ? sc[j][e] * scale_log2 : CKV_NEG_INF;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = CKV_NEG_INF;
#pragma unroll
      for (int j = 0; j < NT8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[j][e] = CKV_MASKED(sc[j][e]) ? 0.f : exp2f(sc[j][e] - m_new);
          sum += sc[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < DT8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                              pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                              pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + d2 * 16 +
                              8 * (lane / 16));
        mma16816<T>(o[2 * d2], pa, vf[0], vf[1]);
        mma16816<T>(o[2 * d2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    T* orow = out + b * o_sb + qh * o_sh + (long long)(row + 8 * r) * o_ss;
#pragma unroll
    for (int j = 0; j < DT8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t4) =
          pack2<T>(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// float32: 256 threads, 64 rows x 64 keys per step, 4 x 4 scores and a
// 4-row x 8-column block of the output per thread (d <= 128).
static __global__ void __launch_bounds__(NT) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int n_q, int n_kv, int s_q, int s_k, int d, int causal, int window,
    int q_offset, float scale, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss) {
  extern __shared__ float smem[];
  const int ld = tile_ld(d);
  constexpr int LP = TK + 4;
  float* qs = smem;          // [TR][ld]
  float* ks = qs + TR * ld;  // [TK][ld]
  float* vs = ks + TK * ld;  // [TK][ld]
  float* ps = vs + TK * ld;  // [TR][LP]
  const int n_mb = (s_q + TR - 1) / TR;
  const int m0 = (n_mb - 1 - blockIdx.x) * TR;
  const int qh = blockIdx.y, b = blockIdx.z, kh = qh / (n_q / n_kv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* qb = q + b * q_sb + qh * q_sh;
  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + TR, s_q) - 1;
  const int k_end = causal ? min(s_k, p_hi + 1) : s_k;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  load_tile<float>(qs, TR, d, [&](int rr) -> const float* {
    return m0 + rr < s_q ? qb + (m0 + rr) * q_ss : nullptr;
  });
  bool ok[4];
  int pos[4];
  float m_run[4], l_run[4], alpha[4];
  float4 o[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ok[i] = m0 + ty + 16 * i < s_q;
    pos[i] = q_offset + m0 + ty + 16 * i;
    m_run[i] = CKV_NEG_INF, l_run[i] = 0.f;
    o[i][0] = o[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int n0 = (k_begin / TK) * TK; n0 < k_end; n0 += TK) {
    __syncthreads();
    auto key_row = [&](const float* base, long long ss) {
      return [=](int kk) -> const float* { return n0 + kk < s_k ? base + (n0 + kk) * ss : nullptr; };
    };
    load_tile<float>(ks, TK, d, key_row(kb, k_ss));
    load_tile<float>(vs, TK, d, key_row(vb, v_ss));
    __syncthreads();
    float sc[4][4];
    tile_scores(qs, ks, d, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int t = n0 + tx + 16 * j;
        bool vis = ok[i] && t < s_k && (!causal || t <= pos[i]) &&
                   (window <= 0 || pos[i] - t < window);
        sc[i][j] = vis ? sc[i][j] * scale : CKV_NEG_INF;
      }
    online_softmax(sc, m_run, l_run, alpha);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * LP + tx + 16 * j] = sc[i][j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        o[i][c].x *= alpha[i];
        o[i][c].y *= alpha[i];
        o[i][c].z *= alpha[i];
        o[i][c].w *= alpha[i];
      }
    for (int kk = 0; kk < TK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int x = tx * 4 + 64 * c;
        if (x >= d) break;
        float4 vv = *reinterpret_cast<const float4*>(vs + kk * ld + x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c].x = fmaf(p[i], vv.x, o[i][c].x);
          o[i][c].y = fmaf(p[i], vv.y, o[i][c].y);
          o[i][c].z = fmaf(p[i], vv.z, o[i][c].z);
          o[i][c].w = fmaf(p[i], vv.w, o[i][c].w);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!ok[i]) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    float* orow = out + b * o_sb + qh * o_sh + (long long)(m0 + ty + 16 * i) * o_ss;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int x = tx * 4 + 64 * c;
      if (x < d)
        *reinterpret_cast<float4*>(orow + x) =
            make_float4(o[i][c].x * inv, o[i][c].y * inv, o[i][c].z * inv, o[i][c].w * inv);
    }
  }
}

template <typename T, int HD>
static void launch_flash_tc(const void* q, const void* k, const void* v, void* out, int b,
                            int n_q, int n_kv, int s_q, int s_k, int causal, int window,
                            int q_offset, const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 3 * FA_BM * (HD + 8);
  cudaFuncSetAttribute(flash_tc_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((s_q + FA_BM - 1) / FA_BM, n_q, b);
  flash_tc_kernel<T, HD><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, n_q, n_kv, s_q, s_k, causal, window,
      q_offset, softmax_scale(HD) * LOG2E, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
}

template <typename T>
static int launch_flash_16(const void* q, const void* k, const void* v, void* out, int b,
                           int n_q, int n_kv, int s_q, int s_k, int d, int causal, int window,
                           int q_offset, const long long* st, cudaStream_t stream) {
  switch (d) {
    case 16:
      launch_flash_tc<T, 16>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset, st,
                             stream);
      break;
    case 32:
      launch_flash_tc<T, 32>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset, st,
                             stream);
      break;
    case 64:
      launch_flash_tc<T, 64>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset, st,
                             stream);
      break;
    case 128:
      launch_flash_tc<T, 128>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset,
                              st, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace ckv

// q/out (b, n_q, s_q, d), k/v (b, n_kv, s_k, d) in dtype, each with element
// strides (batch, head, position) and a contiguous head dim; rows 16-byte
// aligned. bfloat16/float16 take d in {16, 32, 64, 128}; float32 any
// multiple of 4 up to 128.
extern "C" int ckv_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                   int n_q, int n_kv, int s_q, int s_k, int d, int causal,
                                   int window, int q_offset, long long q_sb, long long q_sh,
                                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, int dtype,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  int rc = 0;
  switch (dtype) {
    case ckv::F32: {
      if (d % 4 || d > 128) return (int)cudaErrorInvalidValue;
      const int ld = ckv::tile_ld(d);
      const size_t smem = sizeof(float) * (3 * ckv::TR * ld + ckv::TR * (ckv::TK + 4));
      cudaFuncSetAttribute(ckv::flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      dim3 grid((s_q + ckv::TR - 1) / ckv::TR, n_q, b);
      ckv::flash_f32_kernel<<<grid, ckv::NT, smem, st>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)out, n_q, n_kv, s_q, s_k, d,
          causal, window, q_offset, ckv::softmax_scale(d), q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
          v_sb, v_sh, v_ss, o_sb, o_sh, o_ss);
      break;
    }
    case ckv::BF16:
      rc = ckv::launch_flash_16<__nv_bfloat16>(q, k, v, out, b, n_q, n_kv, s_q, s_k, d, causal,
                                               window, q_offset, strides, st);
      break;
    case ckv::F16:
      rc = ckv::launch_flash_16<__half>(q, k, v, out, b, n_q, n_kv, s_q, s_k, d, causal, window,
                                        q_offset, strides, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
