// decode_attention: one decode position per request over its paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention (_decode_kernel). q (b, n_q, d) attends over the pages a
// page table names in a (b, n_pages, page, n_kv, d) pool; `lengths` masks
// the partial last page, and pad slots (table < 0) are skipped: they carry
// exactly zero mass and leave the real pages' output and mass bit-identical
// to a call without them (a masked key adds an exact 0 to every sum). It
// returns the output in q's dtype and the per-page probability mass
// (b, n_q, n_active), normalised by each head's final denominator — the
// attention-guided cache's decode-time A_j.
//
// Layout of the work (flash-decoding): one CTA per (request, kv head, split
// of the page table) serves the `group` query heads of that kv head over up
// to 64 keys (whole pages), under a float32 softmax. Each split writes its
// unnormalised output, max and denominator and each page's raw mass with the
// max it was taken at; merge_pages_kernel combines the splits in split order
// and rescales the per-page mass once. The pool is read in place through the
// table: at b = 1 the request's pool buffer is passed as is, with no
// pad-and-stack copy.
//
// Bound on the H100: decode attention is bytes-bound. At the main path's
// shape (69 pages of 16 tokens, 4 kv heads, d = 128, bfloat16) it must read
// ~1.1 MB of K/V, ~0.3 us at 3.35 TB/s, against ~15 MFLOP. Splitting the
// pages gives 18 x 4 CTAs at b = 1 where one CTA per kv head gave 4; each
// split is one load of its pages and one pass over them, so the time is the
// latency of a few dependent steps rather than bandwidth.
#include "common.cuh"

namespace ckv {

constexpr int DA_KEYS = 64;

template <typename T>
static __global__ void __launch_bounds__(256) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ table, const int* __restrict__ lengths, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, float* __restrict__ mass,
    float* __restrict__ m_at, int b_total, int n_q, int n_kv, int n_pages, int page,
    int n_active, int d, float scale) {
  extern __shared__ float smem[];
  const int G = n_q / n_kv;
  float* qs = smem;                     // [G][d]
  float* ks = qs + G * d;               // [DA_KEYS][d + 1]
  float* vs = ks + DA_KEYS * (d + 1);   // [DA_KEYS][d]
  float* ss = vs + DA_KEYS * d;         // [G][DA_KEYS]
  float* os = ss + G * DA_KEYS;         // [G][d]
  float* ms = os + G * d;               // [G]
  float* ls = ms + G;                   // [G]
  float* as = ls + G;                   // [G]
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int* tbl = table + (size_t)b * n_active;
  const size_t row0 = (size_t)b * n_q + (size_t)h * G;  // first query row of this CTA
  for (int i = tid; i < G * d; i += blockDim.x) {
    qs[i] = to_f32(q[row0 * d + i]);
    os[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    ms[g] = CKV_NEG_INF;
    ls[g] = 0.f;
  }
  const int spt = DA_KEYS / page;  // pages per tile = pages per split
  const int tk = spt * page;       // keys per tile
  {
    const int j0 = sp * spt;
    __syncthreads();
    auto pool_row = [&](const T* pool) {
      return [=](int kk) -> const T* {
        int j = j0 + kk / page, ti = kk % page;
        int p = j < n_active ? tbl[j] : -1;
        return p >= 0 && p < n_pages && j * page + ti < len
                   ? pool + ((((size_t)b * n_pages + p) * page + ti) * n_kv + h) * d
                   : nullptr;
      };
    };
    load_rows<T>(ks, d + 1, 0, tk, d, pool_row(k_pool));
    load_rows<T>(vs, d, 0, tk, d, pool_row(v_pool));
    __syncthreads();
    for (int i = tid; i < G * DA_KEYS; i += blockDim.x) {
      int g = i / DA_KEYS, kk = i % DA_KEYS, j = j0 + kk / page, ti = kk % page;
      float sc = CKV_NEG_INF;
      if (kk < tk && j < n_active) {
        int p = tbl[j];
        if (p >= 0 && p < n_pages && j * page + ti < len) {
          const float* qr = qs + g * d;
          const float* kr = ks + kk * (d + 1);
          float dot = 0.f;
          for (int x = 0; x < d; ++x) dot = fmaf(qr[x], kr[x], dot);
          sc = dot * scale;
        }
      }
      ss[i] = sc;
    }
    __syncthreads();
    for (int g = warp; g < G; g += blockDim.x / 32) {
      float v0 = ss[g * DA_KEYS + lane], v1 = ss[g * DA_KEYS + lane + 32];
      float m_old = ms[g];
      float m_new = fmaxf(m_old, warp_max(fmaxf(v0, v1)));
      float p0 = CKV_MASKED(v0) ? 0.f : expf(v0 - m_new);
      float p1 = CKV_MASKED(v1) ? 0.f : expf(v1 - m_new);
      float psum = warp_sum(p0 + p1);
      ss[g * DA_KEYS + lane] = p0;
      ss[g * DA_KEYS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * spt; i += blockDim.x) {
      int g = i / spt, sl = i % spt, j = j0 + sl;
      if (j < n_active) {
        const float* pr = ss + g * DA_KEYS + sl * page;
        float raw = 0.f;
        for (int ti = 0; ti < page; ++ti) raw += pr[ti];
        mass[(row0 + g) * n_active + j] = raw;
        m_at[(row0 + g) * n_active + j] = ms[g];
      }
    }
    for (int i = tid; i < G * d; i += blockDim.x) {
      int g = i / d, x = i % d;
      const float* pr = ss + g * DA_KEYS;
      float acc = os[i] * as[g];
      for (int kk = 0; kk < tk; ++kk) acc = fmaf(pr[kk], vs[kk * d + x], acc);
      os[i] = acc;
    }
  }
  // partials of this split: [sp][b][qh] (+ d for the output)
  const size_t prow = (size_t)sp * b_total * n_q + row0;
  for (int i = tid; i < G * d; i += blockDim.x) o_part[prow * d + i] = os[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_part[prow + g] = ms[g];
    l_part[prow + g] = ls[g];
  }
}

// One CTA per (request, query head): merge the splits in split order into the
// output (q's dtype) and rescale each page's raw mass by the final max and
// denominator; pad slots get exactly 0.
template <typename T>
static __global__ void merge_pages_kernel(const float* __restrict__ o_part,
                                          const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          const int* __restrict__ table, T* __restrict__ out,
                                          float* __restrict__ mass, const float* __restrict__ m_at,
                                          int b_total, int n_q, int n_pages, int n_active, int d,
                                          int n_split) {
  const size_t row = (size_t)blockIdx.y * n_q + blockIdx.x;  // (b, qh)
  const size_t stride = (size_t)b_total * n_q;
  float m, l;
  merge_stats(m_part, l_part, n_split, stride, row, &m, &l);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int x = threadIdx.x; x < d; x += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      acc += o_part[(sp * stride + row) * d + x] * expf(m_part[sp * stride + row] - m);
    out[row * d + x] = from_f32<T>(acc * inv);
  }
  const int* tbl = table + (size_t)blockIdx.y * n_active;
  for (int j = threadIdx.x; j < n_active; j += blockDim.x) {
    size_t o = row * n_active + j;
    mass[o] = (tbl[j] < 0 || tbl[j] >= n_pages) ? 0.f : mass[o] * expf(m_at[o] - m) * inv;
  }
}

template <typename T>
static void launch_decode(const void* q, const void* k_pool, const void* v_pool,
                          const int* table, const int* lengths, void* out, float* mass,
                          float* m_at, float* o_part, float* m_part, float* l_part, int b,
                          int n_q, int n_kv, int n_pages, int page, int n_active, int d,
                          cudaStream_t st) {
  const int G = n_q / n_kv, spt = DA_KEYS / page;
  const int n_split = (n_active + spt - 1) / spt;
  const size_t smem = sizeof(float) *
      (G * d + DA_KEYS * (d + 1) + DA_KEYS * d + G * DA_KEYS + G * d + 3 * G);
  cudaFuncSetAttribute(decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  decode_split_kernel<T><<<dim3(n_kv, b, n_split), 256, smem, st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, table, lengths, o_part, m_part, l_part,
      mass, m_at, b, n_q, n_kv, n_pages, page, n_active, d, softmax_scale(d));
  merge_pages_kernel<T><<<dim3(n_q, b), 128, 0, st>>>(o_part, m_part, l_part, table, (T*)out,
                                                      mass, m_at, b, n_q, n_pages, n_active, d,
                                                      n_split);
}

}  // namespace ckv

// q (b, n_q, d), k_pool/v_pool (b, n_pages, page, n_kv, d) and out (b, n_q, d) in dtype;
// table (b, n_active) int32, lengths (b,) int32; mass (b, n_q, n_active) float32.
// Scratch (float32), with S = ceil(n_active / (64 / page)) splits: m_at
// (b, n_q, n_active); o_part (S, b, n_q, d); m_part, l_part (S, b, n_q).
extern "C" int ckv_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                    const int* table, const int* lengths, void* out, float* mass,
                                    float* m_at, float* o_part, float* m_part, float* l_part,
                                    int b, int n_q, int n_kv, int n_pages, int page,
                                    int n_active, int d, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case ckv::F32:
      ckv::launch_decode<float>(q, k_pool, v_pool, table, lengths, out, mass, m_at, o_part,
                                m_part, l_part, b, n_q, n_kv, n_pages, page, n_active, d, st);
      break;
    case ckv::BF16:
      ckv::launch_decode<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, mass, m_at, o_part,
                                m_part, l_part, b, n_q, n_kv, n_pages, page, n_active, d, st);
      break;
    case ckv::F16:
      ckv::launch_decode<__half>(q, k_pool, v_pool, table, lengths, out, mass, m_at, o_part,
                                m_part, l_part, b, n_q, n_kv, n_pages, page, n_active, d, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
