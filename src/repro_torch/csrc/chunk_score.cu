// chunk_score: ContiguousChunk importance (Eq. 1) for the identify step.
//
// Replaces the TPU kernel src/repro/kernels/chunk_score/kernel.py:chunk_score
// (_stats_kernel, _score_kernel). The JAX engine's identify step runs
// core/sparse_attention.py:probe_token_scores and a numpy reduceat; this
// kernel computes the same (m,) chunk scores on the card, so only m floats
// cross back to the host instead of n.
//
// Function: a_t = sum over query heads and suffix rows of softmax_t(q . k_t *
// d^-0.5) over all n prefix keys; A_j = sum of a_t over chunk j's c tokens.
//
// Four launches, no float atomics (top-k must be reproducible):
//   1. stats_split_kernel: one CTA per (64 query rows of one kv head — the
//      `group` query heads that share it —, key split) streams its split's
//      keys in 64-key tiles with an online max/denominator per row;
//   2. merge_stats_kernel: merges the splits' statistics in split order;
//   3. mass_pass_kernel (common.cuh): one CTA per (kv head, 64-key block)
//      sums the normalised probability of every row of that kv head per chunk;
//   4. reduce_heads_kernel: ordered sum over kv heads -> (m,).
// Any n is accepted: the ragged last key tile and the partial last chunk are
// masked (the TPU kernel asserted n % block_k == 0).
//
// Bound on the H100: at the main path's shape (28 query heads, 64 rows,
// 4096 keys, d = 128) the products are 2 x 1.9 GFLOP against ~5 MB of
// inputs. With float32 queries (every identify past layer 0) the products
// must run in float32 on the CUDA cores (67 TFLOP/s), so operations bound it
// (~0.03 ms for one product pass); with bfloat16 queries the bytes would.
// The design keeps each thread's 4 x 4 scores in registers and splits the
// keys across CTAs so that the 7 x 4 row tiles fill the 132 SMs.
#include "common.cuh"

namespace ckv {

// Partial row statistics of one key split. Row r of kv head h is query
// head h * group + r / s at position r % s; its statistics go to
// [split][h * group * s + r].
template <typename TQ>
static __global__ void __launch_bounds__(NT) stats_split_kernel(
    const TQ* __restrict__ q, const __half* __restrict__ k, float* __restrict__ m_part,
    float* __restrict__ l_part, int s, int n_q, int n_kv, int n, int d, int keys_per_split,
    float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(d);
  float* qs = smem;          // [TR][ld]
  float* ks = qs + TR * ld;  // [TK][ld]
  const int h = blockIdx.y, r0 = blockIdx.x * TR, sp = blockIdx.z, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int group = n_q / n_kv, rows = group * s;
  const int t_begin = sp * keys_per_split, t_end = min(n, t_begin + keys_per_split);
  load_tile<TQ>(qs, TR, d, [&](int rr) -> const TQ* {
    int r = r0 + rr;
    return r < rows ? q + ((size_t)(r % s) * n_q + h * group + r / s) * d : nullptr;
  });
  float m_run[4], l_run[4], alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = CKV_NEG_INF, l_run[i] = 0.f;
  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();
    load_tile<__half>(ks, TK, d, [&](int kk) -> const __half* {
      int t = t0 + kk;
      return t < t_end ? k + ((size_t)t * n_kv + h) * d : nullptr;
    });
    __syncthreads();
    float sc[4][4];
    tile_scores(qs, ks, d, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[i][j] = t0 + tx + 16 * j < t_end ? sc[i][j] * scale : CKV_NEG_INF;
    online_softmax(sc, m_run, l_run, alpha);
  }
  if (tx == 0) {
    const size_t base = (size_t)sp * n_q * s + (size_t)h * rows;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = r0 + ty + 16 * i;
      if (r < rows) {
        m_part[base + r] = m_run[i];
        l_part[base + r] = l_run[i];
      }
    }
  }
}

static __global__ void merge_stats_kernel(const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          float* __restrict__ m_stat, float* __restrict__ l_stat,
                                          int n_rows, int n_split) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_rows) merge_stats(m_part, l_part, n_split, n_rows, r, m_stat + r, l_stat + r);
}

template <typename TQ>
static cudaError_t launch_chunk_score(const void* q, const void* k, float* out, float* m_stat,
                                      float* l_stat, float* m_part, float* l_part, float* partial,
                                      int s, int n_q, int n_kv, int n, int d, int c,
                                      int keys_per_split, cudaStream_t st) {
  const int rows = (n_q / n_kv) * s, n_split = (n + keys_per_split - 1) / keys_per_split;
  const size_t smem = sizeof(float) * (TR + TK) * tile_ld(d);
  cudaFuncSetAttribute(stats_split_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((rows + TR - 1) / TR, n_kv, n_split);
  stats_split_kernel<TQ><<<grid, NT, smem, st>>>((const TQ*)q, (const __half*)k, m_part, l_part,
                                                  s, n_q, n_kv, n, d, keys_per_split,
                                                  softmax_scale(d));
  merge_stats_kernel<<<(n_q * s + 255) / 256, 256, 0, st>>>(m_part, l_part, m_stat, l_stat,
                                                             n_q * s, n_split);
  return launch_mass<TQ>(q, (const __half*)k, m_stat, l_stat, partial, out, s, n_q, n_kv, n, d,
                         c, (n + c - 1) / c, st);
}

}  // namespace ckv

extern "C" const char* ckv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (s, n_q, d) in q_dtype; k (n, n_kv, d) float16; out (ceil(n / c),) float32.
// Scratch (float32): m_stat, l_stat (n_q * s); m_part, l_part
// (ceil(n / keys_per_split) * n_q * s); partial (n_kv * ceil(n / c)).
// keys_per_split is a multiple of 64; d a multiple of 4, at most 128.
extern "C" int ckv_chunk_score(const void* q, const void* k, float* out, float* m_stat,
                               float* l_stat, float* m_part, float* l_part, float* partial, int s,
                               int n_q, int n_kv, int n, int d, int c, int keys_per_split,
                               int q_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (q_dtype) {
    case ckv::F32:
      return (int)ckv::launch_chunk_score<float>(q, k, out, m_stat, l_stat, m_part, l_part,
                                                 partial, s, n_q, n_kv, n, d, c, keys_per_split,
                                                 st);
    case ckv::BF16:
      return (int)ckv::launch_chunk_score<__nv_bfloat16>(q, k, out, m_stat, l_stat, m_part,
                                                         l_part, partial, s, n_q, n_kv, n, d, c,
                                                         keys_per_split, st);
    case ckv::F16:
      return (int)ckv::launch_chunk_score<__half>(q, k, out, m_stat, l_stat, m_part, l_part,
                                                  partial, s, n_q, n_kv, n, d, c, keys_per_split,
                                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
