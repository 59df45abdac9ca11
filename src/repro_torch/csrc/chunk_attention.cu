// chunk_attention: all of Re-Prefill part B's attention in one call.
//
// Replaces the TPU kernel src/repro/kernels/chunk_attention/kernel.py:
// chunk_attention (_chunk_attn_kernel) together with the causal suffix
// partial and merge of chunk_attention/ops.py, i.e. the function the engine
// runs as core/sparse_attention.py:reprefill_attention: the suffix queries
// attend to the gathered selected chunks (fully visible; `n_valid` chunks, a
// prefix of the bucket) and, causally, to the suffix itself, under one
// float32 softmax. Output is float32, the dtype jnp's concatenation of
// float16 chunks with bfloat16/float32 suffix KV promotes to.
//
// It also returns A_j by the engine's definition
// (sparse_attention.py:65-67): the probability over [chunks ; suffix] landing
// on chunk j, summed over heads, queries and the chunk's tokens — not the
// per-head normalisation over chunks of chunk_attention/ops.py:58-60. That
// needs each row's final max and denominator, so a second pass over the chunk
// keys (mass_pass_kernel in common.cuh) sums exp(s - m) / l per (kv head,
// chunk) and an ordered reduce over kv heads gives (nb,), with no atomics.
//
// Layout of the work (flash-decoding): one CTA per (64 query rows of one kv
// head, key split) serves the `group` query heads of that kv head, so each
// chunk tile is read once per kv head and row tile (the Pallas grid read it
// once per query head). Each CTA streams its split's keys — chunk keys, then
// suffix keys — in 64-key tiles with an online softmax, keeping a 4 x 4
// block of scores and a 4-row x 8-column block of the output per thread in
// registers; merge_split_kernel combines the splits in split order.
//
// Bound on the H100 at the main path's shape (28 query heads, 64 suffix
// rows, 64 chunks of 16 tokens, d = 128): ~2 MB of float16 chunks and about
// 1 MB of suffix KV, queries and output, against 4 x 28 x 128 x 67616 =
// 0.97 GFLOP of products (QK and PV; the suffix is causal). With float32
// queries (every layer after the first) the products run on the float32 CUDA
// cores and the operations bound it. No tensor cores yet (no wgmma, no TMA).
#include "common.cuh"

namespace ckv {

// Rows of kv head h in this kernel: r = pos * group + gi (position-major, so
// a 64-row tile spans few positions and the causal mask prunes suffix
// tiles). Partials go to [split][h][r].
template <typename TQ>
static __global__ void __launch_bounds__(NT) attn_split_kernel(
    const TQ* __restrict__ q, const __half* __restrict__ k_sel, const __half* __restrict__ v_sel,
    const TQ* __restrict__ k_suf, const TQ* __restrict__ v_suf, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int s, int n_q, int n_kv, int n_pre,
    int d, int keys_per_split, float scale) {
  extern __shared__ float smem[];
  const int ld = tile_ld(d);
  float* qs = smem;            // [TR][ld]
  float* ks = qs + TR * ld;    // [TK][ld]
  float* vs = ks + TK * ld;    // [TK][ld]
  float* ps = vs + TK * ld;    // [TR][TK + 4]
  constexpr int LP = TK + 4;
  const int h = blockIdx.y, r0 = blockIdx.x * TR, sp = blockIdx.z, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int group = n_q / n_kv, rows = group * s;
  const int T = n_pre + s;
  const int t_begin = sp * keys_per_split, t_end = min(T, t_begin + keys_per_split);
  // the last suffix key any row of this tile may see
  const int last_pos = min(s - 1, (min(r0 + TR, rows) - 1) / group);
  load_tile<TQ>(qs, TR, d, [&](int rr) -> const TQ* {
    int r = r0 + rr;
    return r < rows ? q + ((size_t)(r / group) * n_q + h * group + r % group) * d : nullptr;
  });
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = r0 + ty + 16 * i;
    pos[i] = r < rows ? r / group : -1;  // -1: no such row, every key masked
  }
  float m_run[4], l_run[4], alpha[4];
  float4 o[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = CKV_NEG_INF, l_run[i] = 0.f;
    o[i][0] = o[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int t0 = t_begin; t0 < t_end && t0 <= n_pre + last_pos; t0 += TK) {
    __syncthreads();
    // chunk keys (float16) then suffix keys (q's dtype); past t_end, zeros
    const int n_chunk_rows = max(0, min(TK, min(n_pre, t_end) - t0));
    auto chunk_row = [&](const __half* base) {
      return [=](int kk) -> const __half* { return base + ((size_t)(t0 + kk) * n_kv + h) * d; };
    };
    auto suffix_row = [&](const TQ* base) {
      return [=](int kk) -> const TQ* {
        int t = t0 + kk;
        return t < t_end ? base + ((size_t)(t - n_pre) * n_kv + h) * d : nullptr;
      };
    };
    load_rows<__half>(ks, ld, 0, n_chunk_rows, d, chunk_row(k_sel));
    load_rows<__half>(vs, ld, 0, n_chunk_rows, d, chunk_row(v_sel));
    load_rows<TQ>(ks, ld, n_chunk_rows, TK, d, suffix_row(k_suf));
    load_rows<TQ>(vs, ld, n_chunk_rows, TK, d, suffix_row(v_suf));
    __syncthreads();
    float sc[4][4];
    tile_scores(qs, ks, d, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int t = t0 + tx + 16 * j;
        bool visible = pos[i] >= 0 && t < t_end && (t < n_pre || t - n_pre <= pos[i]);
        sc[i][j] = visible ? sc[i][j] * scale : CKV_NEG_INF;
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
        float4 v = *reinterpret_cast<const float4*>(vs + kk * ld + x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c].x = fmaf(p[i], v.x, o[i][c].x);
          o[i][c].y = fmaf(p[i], v.y, o[i][c].y);
          o[i][c].z = fmaf(p[i], v.z, o[i][c].z);
          o[i][c].w = fmaf(p[i], v.w, o[i][c].w);
        }
      }
    }
  }
  const size_t base = ((size_t)sp * n_kv + h) * rows;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    if (tx == 0) {
      m_part[base + r] = m_run[i];
      l_part[base + r] = l_run[i];
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int x = tx * 4 + 64 * c;
      if (x < d) *reinterpret_cast<float4*>(o_part + (base + r) * d + x) = o[i][c];
    }
  }
}

// One CTA per (kv head, row): merge the splits in split order into the
// float32 output and the row's final statistics, stored where the mass pass
// reads them (query head qh at position pos -> qh * s + pos).
static __global__ void merge_split_kernel(const float* __restrict__ o_part,
                                          const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          float* __restrict__ out, float* __restrict__ m_stat,
                                          float* __restrict__ l_stat, int s, int n_q, int n_kv,
                                          int d, int n_split) {
  const int group = n_q / n_kv, rows = group * s;
  const int h = blockIdx.y, r = blockIdx.x;
  const size_t stride = (size_t)n_kv * rows, idx = (size_t)h * rows + r;
  float m, l;
  merge_stats(m_part, l_part, n_split, stride, idx, &m, &l);
  const int pos = r / group, qh = h * group + r % group;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int x = threadIdx.x; x < d; x += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      acc += o_part[(sp * stride + idx) * d + x] * expf(m_part[sp * stride + idx] - m);
    out[((size_t)pos * n_q + qh) * d + x] = acc * inv;
  }
  if (threadIdx.x == 0) {
    m_stat[qh * s + pos] = m;
    l_stat[qh * s + pos] = l;
  }
}

template <typename TQ>
static void launch_chunk_attention(const void* q, const void* k_sel, const void* v_sel,
                                   const void* k_suf, const void* v_suf, float* out, float* mass,
                                   float* m_stat, float* l_stat, float* o_part, float* m_part,
                                   float* l_part, float* partial, int s, int n_q, int n_kv,
                                   int nb, int c, int n_valid, int d, int keys_per_split,
                                   cudaStream_t st) {
  const int rows = (n_q / n_kv) * s, n_pre = n_valid * c;
  const int n_split = (n_pre + s + keys_per_split - 1) / keys_per_split;
  const size_t smem = sizeof(float) * (TR * tile_ld(d) + 2 * TK * tile_ld(d) + TR * (TK + 4));
  cudaFuncSetAttribute(attn_split_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((rows + TR - 1) / TR, n_kv, n_split);
  attn_split_kernel<TQ><<<grid, NT, smem, st>>>(
      (const TQ*)q, (const __half*)k_sel, (const __half*)v_sel, (const TQ*)k_suf,
      (const TQ*)v_suf, o_part, m_part, l_part, s, n_q, n_kv, n_pre, d, keys_per_split,
      softmax_scale(d));
  merge_split_kernel<<<dim3(rows, n_kv), 128, 0, st>>>(o_part, m_part, l_part, out, m_stat,
                                                       l_stat, s, n_q, n_kv, d, n_split);
  launch_mass<TQ>(q, (const __half*)k_sel, m_stat, l_stat, partial, mass, s, n_q, n_kv, n_pre,
                  d, c, nb, st);
}

}  // namespace ckv

// q (s, n_q, d), k_suf/v_suf (s, n_kv, d) in q_dtype; k_sel/v_sel (nb, c, n_kv, d) float16
// with the first n_valid chunks valid; out (s, n_q, d) float32; mass (nb,) float32.
// Scratch (float32), with S = ceil((n_valid * c + s) / keys_per_split):
// m_stat, l_stat (n_q * s); o_part (S * n_q * s * d); m_part, l_part (S * n_q * s);
// partial (n_kv * n_valid). keys_per_split is a multiple of 64.
extern "C" int ckv_chunk_attention(const void* q, const void* k_sel, const void* v_sel,
                                   const void* k_suf, const void* v_suf, float* out, float* mass,
                                   float* m_stat, float* l_stat, float* o_part, float* m_part,
                                   float* l_part, float* partial, int s, int n_q, int n_kv,
                                   int nb, int c, int n_valid, int d, int keys_per_split,
                                   int q_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (q_dtype) {
    case ckv::F32:
      ckv::launch_chunk_attention<float>(q, k_sel, v_sel, k_suf, v_suf, out, mass, m_stat, l_stat,
                                         o_part, m_part, l_part, partial, s, n_q, n_kv, nb, c,
                                         n_valid, d, keys_per_split, st);
      break;
    case ckv::BF16:
      ckv::launch_chunk_attention<__nv_bfloat16>(q, k_sel, v_sel, k_suf, v_suf, out, mass, m_stat,
                                                 l_stat, o_part, m_part, l_part, partial, s, n_q,
                                                 n_kv, nb, c, n_valid, d, keys_per_split, st);
      break;
    case ckv::F16:
      ckv::launch_chunk_attention<__half>(q, k_sel, v_sel, k_suf, v_suf, out, mass, m_stat,
                                          l_stat, o_part, m_part, l_part, partial, s, n_q, n_kv,
                                          nb, c, n_valid, d, keys_per_split, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
