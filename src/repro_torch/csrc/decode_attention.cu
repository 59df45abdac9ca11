// decode_attention: one decode position per request over its paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention (_decode_kernel). q (b, n_q, d) attends over the pages a
// page table names in a (b, n_pages, page, n_kv, d) pool; `lengths` masks
// the partial last page, and pad slots (table < 0) are skipped: they carry
// exactly zero mass and leave the real pages' output and mass bit-identical
// to a call without them (a masked key adds an exact 0 to every sum). It
// returns the output in q's dtype and the per-page probability mass
// (b, n_q, n_active), normalised by each head's final max and denominator —
// the attention-guided cache's decode-time A_j.
//
// Two forms share one kernel body, templated on how a request's pages are
// addressed: the stacked form reads request b's pages out of one
// (b, n_pages, page, n_kv, d) pool; the pools form (the TPU package's
// decode_attention_pools, src/repro/kernels/decode_attention/ops.py:38, which
// pads and stacks b per-request buffers before the kernel) reads them
// straight out of b separate (n_pages_b, page, n_kv, d) buffers through a
// device block of b K and b V base pointers and b page counts, so a batched
// decode step copies no pool byte. A page index at or past a request's own
// page count is masked like a pad slot and read nowhere. The split layout
// depends on n_active and page only, so the pools form is bit-identical to
// the stacked form on the zero-padded stack at the same table width.
//
// Bound on the H100: bytes. At the main path's shape (69 pages of 16 tokens,
// 4 kv heads, d = 128, bfloat16) it must read ~1.1 MB of K/V, ~0.3 us at
// 3.35 TB/s, against ~15 MFLOP. What it costs in practice is latency: the
// chain of dependent steps from the first load to the last store, and the
// launch.
//
// Layout of the work: one launch. One CTA of 256 threads per (request, kv
// head, split of `pps` whole pages, at most 64 keys) serves the `group` query
// heads of that kv head:
//   - one round trip: its K and V rows straight from the pool, with the
//     query rows, by 16-byte cp.async (zero-filled where masked);
//   - the scores on the tensor cores, one 8-key tile per warp: mma.sync
//     m16n8k16 in q's 16-bit type with the group's rows padded to 16 (the
//     products are exact in float32, only the order of the sums differs),
//     or for float32 inputs m16n8k8 with split-TF32 operands (common.cuh);
//   - the split's softmax, each page's raw mass, and P V in float32 on the
//     CUDA cores, four columns per thread;
//   - its unnormalised output, max and denominator to scratch.
// The last CTA of the (request, kv head) to finish (last_to_arrive) merges
// the splits: it starts every load of the merge before it reduces any, then
// takes the max over splits, the denominator as a fixed lane-strided tree,
// the output in split order, and each page's mass rescaled by
// exp(m_split - m) / l. The order of every sum is fixed by the split layout,
// never by which CTA finished last, so two runs are bit-identical. `pps`
// depends on the page size only, so a pad slot appended to the table adds at
// most a split of zeros and never moves a split boundary.
#include "common.cuh"

namespace ckv {

constexpr int DA_NT = 256;  // threads per CTA
constexpr int DA_WARPS = DA_NT / 32;
constexpr int DA_MAX_KEYS = 64;  // keys per split: one 8-key n-tile per warp
constexpr int DA_SB = 24;        // splits per batch of merge loads

// shared-memory row stride, in elements, of q and key rows (conflict-free
// fragment loads; the 8 columns past d are zero where a k-step reads them)
template <typename T>
__host__ __device__ __forceinline__ int da_ld(int d) {
  return sizeof(T) == 4 ? d + 4 : d + 8;
}

// scores of query rows [16 mt, 16 mt + 16) against keys [8 nt, 8 nt + 8):
// c0 (row g, key 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
template <typename T>
__device__ __forceinline__ void score_tile(const T* qs, const T* ks, int d, int mt, int nt,
                                           int g, int t, float c[4]) {
  const int ld = da_ld<T>(d);
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const T* qa = qs + (mt * 16 + g) * ld;
  const T* kb = ks + (nt * 8 + g) * ld;
  if constexpr (sizeof(T) == 2) {  // 16-bit products are exact in float32
    for (int k0 = 0; k0 < d; k0 += 16) {
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(qa + k0 + 2 * t),
                             *reinterpret_cast<const uint32_t*>(qa + 8 * ld + k0 + 2 * t),
                             *reinterpret_cast<const uint32_t*>(qa + k0 + 2 * t + 8),
                             *reinterpret_cast<const uint32_t*>(qa + 8 * ld + k0 + 2 * t + 8)};
      mma_16816<T>(c, a, *reinterpret_cast<const uint32_t*>(kb + k0 + 2 * t),
                   *reinterpret_cast<const uint32_t*>(kb + k0 + 2 * t + 8));
    }
  } else {  // float32: split-TF32, q_lo k_hi + q_hi k_lo + q_hi k_hi
    for (int k0 = 0; k0 < d; k0 += 8) {
      uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
      tf32_split(qa[k0 + t], ah[0], al[0]);
      tf32_split(qa[8 * ld + k0 + t], ah[1], al[1]);
      tf32_split(qa[k0 + t + 4], ah[2], al[2]);
      tf32_split(qa[8 * ld + k0 + t + 4], ah[3], al[3]);
      tf32_split(kb[k0 + t], bh0, bl0);
      tf32_split(kb[k0 + t + 4], bh1, bl1);
      mma_tf32(c, al, bh0, bh1);
      mma_tf32(c, ah, bl0, bl1);
      mma_tf32(c, ah, bh0, bh1);
    }
  }
}

// four consecutive elements (8- or 16-byte aligned) as float32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
  return make_float4(to_f32(v[0]), to_f32(v[1]), to_f32(v[2]), to_f32(v[3]));
}

// POOLS: pool_ptrs holds [b K base pointers | b V base pointers | b page
// counts] and k_pool / v_pool are unused; else request b's pages are the b-th
// (n_pages, page, n_kv, d) slice of k_pool / v_pool.
template <typename T, bool POOLS>
static __global__ void __launch_bounds__(DA_NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const long long* __restrict__ pool_ptrs, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ mass,
    float* __restrict__ o_part, float* __restrict__ m_part, float* __restrict__ l_part,
    int* __restrict__ counters, int b_total, int n_q, int n_kv,
    int n_pages, int page, int n_active, int d, int pps, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = n_q / n_kv, QR = (G + 15) / 16 * 16, nk = pps * page, per_row = d / VEC;
  const int nk8 = (nk + 7) / 8 * 8;  // key rows the score tiles read
  const int ld = da_ld<T>(d);
  T* qs = reinterpret_cast<T*>(smem_raw);                // [QR][ld], rows >= G zero
  T* ks = qs + QR * ld;                                  // [nk8][ld]
  T* vs = ks + nk8 * ld;                                 // [nk8][ld]
  float* ps = reinterpret_cast<float*>(vs + nk8 * ld);   // [G][nk]
  float* ms = ps + G * nk;                               // [G]
  float* ls = ms + G;                                    // [G]
  int* flag = reinterpret_cast<int*>(ls + G);
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n_split = gridDim.z;
  const int len = lengths[b];
  const int* tbl = table + (size_t)b * n_active;
  const size_t row0 = (size_t)b * n_q + (size_t)h * G;  // first query row of this CTA
  const int j0 = sp * pps;                               // first page slot of the split
  // this request's K and V pages and their count
  const T* kb;
  const T* vb;
  int np_b;
  if constexpr (POOLS) {
    kb = reinterpret_cast<const T*>(pool_ptrs[b]);
    vb = reinterpret_cast<const T*>(pool_ptrs[b_total + b]);
    np_b = (int)pool_ptrs[2 * b_total + b];
  } else {
    const size_t per_request = (size_t)n_pages * page * n_kv * d;
    kb = k_pool + b * per_request;
    vb = v_pool + b * per_request;
    np_b = n_pages;
  }

  // the offset of key kk of this split in the request's pages, or ~0 where
  // it is masked
  auto key_row = [&](int kk) -> size_t {
    const int j = j0 + kk / page, ti = kk % page;
    const int p = j < n_active ? tbl[j] : -1;
    return kk < nk && p >= 0 && p < np_b && j * page + ti < len
               ? (((size_t)p * page + ti) * n_kv + h) * d
               : ~(size_t)0;
  };
  // one round trip: K and V rows from the pool, the query rows, zeros elsewhere
  for (int i = tid; i < nk8 * per_row; i += DA_NT) {
    const int kk = i / per_row, e = (i % per_row) * VEC;
    const size_t r = key_row(kk);
    const bool ok = r != ~(size_t)0;
    cp_async16_zfill(ks + kk * ld + e, ok ? kb + r + e : q, ok);
    cp_async16_zfill(vs + kk * ld + e, ok ? vb + r + e : q, ok);
  }
  for (int i = tid; i < QR * per_row; i += DA_NT) {
    const int gq = i / per_row, e = (i % per_row) * VEC;
    cp_async16_zfill(qs + gq * ld + e, gq < G ? q + (row0 + gq) * d + e : q, gq < G);
  }
  if (sizeof(T) == 2 && d % 16)  // the half k-step past d reads 8 zero columns
    for (int r = tid; r < QR + nk8; r += DA_NT)
      *reinterpret_cast<uint4*>((r < QR ? qs + r * ld : ks + (r - QR) * ld) + d) =
          make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait_all();
  __syncthreads();

  // scores on the tensor cores: warp w takes keys [8 w, 8 w + 8)
  for (int nt = warp; nt * 8 < nk; nt += DA_WARPS) {
    const size_t r0 = key_row(nt * 8 + 2 * t), r1 = key_row(nt * 8 + 2 * t + 1);
    for (int mt = 0; mt < QR / 16; ++mt) {
      float c[4];
      score_tile<T>(qs, ks, d, mt, nt, g, t, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gq = mt * 16 + g + 8 * (i / 2), kk = nt * 8 + 2 * t + i % 2;
        const bool vis = (i % 2 ? r1 : r0) != ~(size_t)0;
        if (gq < G && kk < nk) ps[gq * nk + kk] = vis ? c[i] * scale : CKV_NEG_INF;
      }
    }
  }
  __syncthreads();

  // the split's softmax, one warp per query head: nk <= 64, two keys a lane
  constexpr int KPL = DA_MAX_KEYS / 32;
  for (int gq = warp; gq < G; gq += DA_WARPS) {
    float* pr = ps + gq * nk;
    float v[KPL], m = CKV_NEG_INF, l = 0.f;
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      v[u] = lane + 32 * u < nk ? pr[lane + 32 * u] : CKV_NEG_INF;
      m = fmaxf(m, v[u]);
    }
    m = warp_max(m);
#pragma unroll
    for (int u = 0; u < KPL; ++u) {
      v[u] = CKV_MASKED(v[u]) ? 0.f : expf(v[u] - m);
      l += v[u];
      if (lane + 32 * u < nk) pr[lane + 32 * u] = v[u];
    }
    l = warp_sum(l);
    if (lane == 0) {
      ms[gq] = m;
      ls[gq] = l;
    }
  }
  __syncthreads();

  // each page's raw mass (taken at the split's max)
  for (int i = tid; i < G * pps; i += DA_NT) {
    const int gq = i / pps, sl = i % pps, j = j0 + sl;
    if (j < n_active) {
      const float* pr = ps + gq * nk + sl * page;
      float raw = 0.f;
      for (int ti = 0; ti < page; ++ti) raw += pr[ti];
      mass[(row0 + gq) * n_active + j] = raw;
    }
  }
  // P V on the CUDA cores, float32: one (query head, 4 columns) per item
  const size_t prow = (size_t)sp * b_total * n_q + row0;
  const int d4 = d / 4;
  for (int i = tid; i < G * d4; i += DA_NT) {
    const int gq = i / d4, c0 = (i % d4) * 4;
    const float* pr = ps + gq * nk;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kk = 0; kk < nk; ++kk) {
      const float p = pr[kk];
      const float4 v = load4(vs + kk * ld + c0);
      acc.x = fmaf(p, v.x, acc.x);
      acc.y = fmaf(p, v.y, acc.y);
      acc.z = fmaf(p, v.z, acc.z);
      acc.w = fmaf(p, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(o_part + (prow + gq) * d + c0) = acc;
  }
  for (int gq = tid; gq < G; gq += DA_NT) {
    m_part[prow + gq] = ms[gq];
    l_part[prow + gq] = ls[gq];
  }

  if (!last_to_arrive(counters + (size_t)b * n_kv + h, n_split, flag)) return;

  // merge. Every load the first batch needs is started before the statistics
  // are reduced, so at the main path's shape the merge is one round trip.
  const size_t stride = (size_t)b_total * n_q;
  const int item = tid < G * d4 ? tid : G * d4 - 1;  // this thread's first output item
  const int ig = item / d4, ic = (item % d4) * 4;
  float4 ov[DA_SB];
  float om[DA_SB];
#pragma unroll
  for (int u = 0; u < DA_SB; ++u) {
    const size_t o = (size_t)min(u, n_split - 1) * stride + row0 + ig;
    ov[u] = __ldcg(reinterpret_cast<const float4*>(o_part + o * d + ic));
    om[u] = __ldcg(m_part + o);
  }
  constexpr int MB = 8;  // page-mass items per thread per batch
  float pr[MB], pw[MB];
#pragma unroll
  for (int u = 0; u < MB; ++u) {
    const int i = min(u * DA_NT + tid, G * n_active - 1);
    const int gq = i / n_active, j = i % n_active;
    pr[u] = __ldcg(mass + (row0 + gq) * n_active + j);
    pw[u] = __ldcg(m_part + (j / pps) * stride + row0 + gq);
  }
  // the final max and denominator per query head: lane-strided, then a fixed tree
  for (int gq = warp; gq < G; gq += DA_WARPS) {
    const size_t at = row0 + gq;
    float m0 = CKV_NEG_INF, l0 = 0.f, m1 = CKV_NEG_INF, l1 = 0.f;
    if (lane < n_split) {
      m0 = __ldcg(m_part + lane * stride + at);
      l0 = __ldcg(l_part + lane * stride + at);
    }
    if (lane + 32 < n_split) {
      m1 = __ldcg(m_part + (lane + 32) * stride + at);
      l1 = __ldcg(l_part + (lane + 32) * stride + at);
    }
    float m = fmaxf(m0, m1);
    for (int s = lane + 64; s < n_split; s += 32) m = fmaxf(m, __ldcg(m_part + s * stride + at));
    m = warp_max(m);
    float l = l0 * expf(m0 - m) + l1 * expf(m1 - m);
    for (int s = lane + 64; s < n_split; s += 32)
      l += __ldcg(l_part + s * stride + at) * expf(__ldcg(m_part + s * stride + at) - m);
    l = warp_sum(l);
    if (lane == 0) {
      ms[gq] = m;
      ls[gq] = 1.f / fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  // the output, splits in order
  for (int it = tid; it < G * d4; it += DA_NT) {
    const int gq = it / d4, c0 = (it % d4) * 4;
    const float m = ms[gq];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += DA_SB) {
      if (s0 > 0 || it != tid) {  // past the prefetched batch: load this one
#pragma unroll
        for (int u = 0; u < DA_SB; ++u) {
          const size_t o = (size_t)min(s0 + u, n_split - 1) * stride + row0 + gq;
          ov[u] = __ldcg(reinterpret_cast<const float4*>(o_part + o * d + c0));
          om[u] = __ldcg(m_part + o);
        }
      }
#pragma unroll
      for (int u = 0; u < DA_SB; ++u) {
        if (s0 + u >= n_split) break;
        const float w = expf(om[u] - m);
        acc.x = fmaf(ov[u].x, w, acc.x);
        acc.y = fmaf(ov[u].y, w, acc.y);
        acc.z = fmaf(ov[u].z, w, acc.z);
        acc.w = fmaf(ov[u].w, w, acc.w);
      }
    }
    const float inv = ls[gq];
    T* dst = out + (row0 + gq) * d + c0;
    dst[0] = from_f32<T>(acc.x * inv);
    dst[1] = from_f32<T>(acc.y * inv);
    dst[2] = from_f32<T>(acc.z * inv);
    dst[3] = from_f32<T>(acc.w * inv);
  }
  // each page's mass at the final max and denominator; pad slots exactly 0
  for (int i0 = 0; i0 < G * n_active; i0 += MB * DA_NT) {
    if (i0 > 0) {
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        const int i = min(i0 + u * DA_NT + tid, G * n_active - 1);
        const int gq = i / n_active, j = i % n_active;
        pr[u] = __ldcg(mass + (row0 + gq) * n_active + j);
        pw[u] = __ldcg(m_part + (j / pps) * stride + row0 + gq);
      }
    }
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const int i = i0 + u * DA_NT + tid;
      if (i >= G * n_active) break;
      const int gq = i / n_active, j = i % n_active, p = tbl[j];
      mass[(row0 + gq) * n_active + j] =
          (p < 0 || p >= np_b) ? 0.f : pr[u] * expf(pw[u] - ms[gq]) * ls[gq];
    }
  }
}

inline size_t decode_smem(int G, int d, int nk, size_t elem) {
  const int QR = (G + 15) / 16 * 16, ld = elem == 4 ? d + 4 : d + 8;
  return elem * (size_t)(QR + 2 * ((nk + 7) / 8 * 8)) * ld + sizeof(float) * (G * nk + 2 * G + 4);
}

// Pages per split: as many whole pages as fit DA_MAX_KEYS, at least one.
// It depends on the page size only, never on n_active.
inline int decode_pps(int page) { return std::max(1, DA_MAX_KEYS / page); }

inline size_t decode_work_floats(int b, int n_q, int n_active, int page, int d) {
  const int pps = decode_pps(page), n_split = (n_active + pps - 1) / pps;
  return (size_t)n_split * b * n_q * (d + 2);
}

template <typename T, bool POOLS>
static int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                         const long long* pool_ptrs, const int* table, const int* lengths,
                         void* out, float* mass, float* work, long long work_floats,
                         int* counters, int b, int n_q, int n_kv, int n_pages, int page,
                         int n_active, int d, cudaStream_t st) {
  if (page < 1 || page > DA_MAX_KEYS || n_active < 1 || n_kv < 1 || n_q % n_kv || d % 8 ||
      d > 128 || n_q / n_kv > 32)
    return (int)cudaErrorInvalidValue;
  if (work_floats < 0 || (size_t)work_floats < decode_work_floats(b, n_q, n_active, page, d))
    return (int)cudaErrorInvalidValue;
  const int G = n_q / n_kv, pps = decode_pps(page), nk = pps * page;
  static OncePerDevice smem_opt_in;  // at the largest shape taken
  const cudaError_t attr = smem_opt_in([] {
    return cudaFuncSetAttribute(decode_kernel<T, POOLS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)decode_smem(32, 128, DA_MAX_KEYS, sizeof(T)));
  });
  if (attr != cudaSuccess) return (int)attr;
  const int n_split = (n_active + pps - 1) / pps;
  const size_t rows = (size_t)n_split * b * n_q;
  float* o_part = work;
  float* m_part = o_part + rows * d;
  float* l_part = m_part + rows;
  decode_kernel<T, POOLS><<<dim3(n_kv, b, n_split), DA_NT, decode_smem(G, d, nk, sizeof(T)), st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, pool_ptrs, table, lengths, (T*)out, mass,
      o_part, m_part, l_part, counters, b, n_q, n_kv, n_pages, page, n_active, d, pps,
      softmax_scale(d));
  return (int)cudaGetLastError();
}

template <bool POOLS>
static int dispatch_decode(const void* q, const void* k_pool, const void* v_pool,
                           const long long* pool_ptrs, const int* table, const int* lengths,
                           void* out, float* mass, float* work, long long work_floats,
                           int* counters, int b, int n_q, int n_kv, int n_pages, int page,
                           int n_active, int d, int dtype, cudaStream_t st) {
  switch (dtype) {
    case F32:
      return launch_decode<float, POOLS>(q, k_pool, v_pool, pool_ptrs, table, lengths, out, mass,
                                         work, work_floats, counters, b, n_q, n_kv, n_pages,
                                         page, n_active, d, st);
    case BF16:
      return launch_decode<__nv_bfloat16, POOLS>(q, k_pool, v_pool, pool_ptrs, table, lengths,
                                                 out, mass, work, work_floats, counters, b, n_q,
                                                 n_kv, n_pages, page, n_active, d, st);
    case F16:
      return launch_decode<__half, POOLS>(q, k_pool, v_pool, pool_ptrs, table, lengths, out,
                                          mass, work, work_floats, counters, b, n_q, n_kv,
                                          n_pages, page, n_active, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ckv

// The float32 scratch one ckv_decode_attention or ckv_decode_attention_pools
// call needs (its split layout is chosen here and nowhere else).
extern "C" long long ckv_decode_attention_work_floats(int b, int n_q, int n_active, int page,
                                                      int d) {
  if (page < 1 || n_active < 1) return -1;
  return (long long)ckv::decode_work_floats(b, n_q, n_active, page, d);
}

// q (b, n_q, d), k_pool/v_pool (b, n_pages, page, n_kv, d) and out (b, n_q, d) in dtype;
// table (b, n_active) int32, lengths (b,) int32; mass (b, n_q, n_active) float32.
// Splits of max(1, 64 / page) whole pages. work: float32 scratch of
// work_floats >= ckv_decode_attention_work_floats(...) (cudaErrorInvalidValue
// otherwise); counters: b * n_kv int32, zero before the launch and zero again
// after it.
extern "C" int ckv_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                    const int* table, const int* lengths, void* out, float* mass,
                                    float* work, long long work_floats, int* counters, int b,
                                    int n_q, int n_kv, int n_pages, int page, int n_active, int d,
                                    int dtype, void* stream) {
  return ckv::dispatch_decode<false>(q, k_pool, v_pool, nullptr, table, lengths, out, mass, work,
                                     work_floats, counters, b, n_q, n_kv, n_pages, page,
                                     n_active, d, dtype, (cudaStream_t)stream);
}

// The pools form: pool_ptrs is a device block of 3 b int64 — request i's K
// buffer, its V buffer (each (n_pages_i, page, n_kv, d) in dtype) and
// n_pages_i; everything else as ckv_decode_attention.
extern "C" int ckv_decode_attention_pools(const void* q, const long long* pool_ptrs,
                                          const int* table, const int* lengths, void* out,
                                          float* mass, float* work, long long work_floats,
                                          int* counters, int b, int n_q, int n_kv, int page,
                                          int n_active, int d, int dtype, void* stream) {
  return ckv::dispatch_decode<true>(q, nullptr, nullptr, pool_ptrs, table, lengths, out, mass,
                                    work, work_floats, counters, b, n_q, n_kv, 0, page, n_active,
                                    d, dtype, (cudaStream_t)stream);
}
