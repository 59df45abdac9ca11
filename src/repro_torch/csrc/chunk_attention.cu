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
// per-head normalisation over chunks of chunk_attention/ops.py:58-60.
//
// Two forms share one kernel body, templated on how a chunk is addressed.
// The gathered form reads chunk j at k_sel + j c n_kv d. The indexed form
// (the TPU kernel's read by index: its scalar-prefetched chunk_idx index
// maps, kernel.py:99-100) runs b members in one launch, member i reading
// chunk j at pool + chunk_idx[i, j] c n_kv d out of one (m, c, n_kv, d)
// pool; a CTA loads the indices of the chunk tiles it covers into shared
// memory once, and only indices below the member's n_valid are read, so a
// pad slot's address is never formed. Each member takes the split layout a
// gathered call on its own chunks would (it depends on the member's shape
// and n_valid, never on b), its own scratch and its own last-CTA counter, so
// it sums in the same order and equals that call bit for bit. The gathered
// form is the indexed one at b = 1 with chunk_idx = arange(nb).
//
// Bound on the H100 at the main path's shape (28 query heads, 64 suffix
// rows, 64 chunks of 16 tokens, d = 128, float32 queries): ~2 MB of float16
// chunks and ~1 MB of suffix KV, queries and output (1.25 us at 3.35 TB/s)
// against 0.97 GFLOP of products (QK and PV; the suffix is causal), which
// the split-TF32 form below doubles or triples: ~2 GFLOP at the 495 TFLOP/s
// TF32 rate is ~4 us.
//
// Products: mma.sync m16n8k8 in TF32 with split operands. float16 and
// bfloat16 values are exact in TF32; a float32 value x is hi + lo, both TF32
// (common.cuh: tf32_split), and a product keeps every term but lo * lo:
//   float32 q . float16 chunk key       q_lo k + q_hi k              (2)
//   float32 q . float32 suffix key      q_lo k_hi + q_hi k_lo + q_hi k_hi (3)
//   bfloat16 q . either key             q k                          (1)
//   P . float16 / bfloat16 V            p_lo v + p_hi v              (2)
//   P . float32 suffix V                p_lo v_hi + p_hi v_lo + p_hi v_hi (3)
// The dropped lo * lo term and the residual of the split are below 2^-22 of
// each product, so the results stay within the plain version's 1e-5.
// ref.chunk_attention_split_ref repeats this arithmetic in plain torch.
//
// Layout of the work: two kernels. Rows of kv head h are r = pos * group +
// gi (position-major, so a 64-row tile spans few positions and the causal
// mask prunes suffix tiles).
//   - chunk_attn_kernel: one CTA of 4 warps per (64-row tile, member and kv
//     head, split of the key tiles); a warp owns 16 rows. Key tiles are 64 keys:
//     chunk tiles hold whole chunks (64 / c of them), then the suffix tiles.
//     The query rows and each tile's K and V are copied with cp.async, the
//     float16 chunk tiles double-buffered (the next tile's copy runs under
//     this tile's products); chunks stay float16 in shared memory. The
//     scores, an online softmax and P V run in registers, the score
//     fragment feeding P V directly (its two key columns per lane are taken
//     as the A fragment's k and k + 4, and V's rows are read in the same
//     order). For each (row, chunk) the CTA stores the chunk's raw
//     probability mass with the row's running max it was taken at, so no
//     second pass over the chunks is needed. d = 128 and d = 256
//     (gemma3-4b's heads) are compiled with their loops unrolled; other d up
//     to 128 take a generic instance. At d = 256 a thread's output fragment
//     is 128 floats and the tiles take ~197 KB (float32 queries), so that
//     instance runs one CTA a SM with up to 255 registers a thread.
//   - chunk_merge_kernel: one CTA per (16 rows, kv head, member) merges the
//     splits in split order into the output and the rows' per-chunk mass,
//     and the member's last CTA to finish sums those in a fixed order into
//     its A_j.
// No float atomics: two runs are bit-identical.
#include "common.cuh"

namespace ckv {

constexpr int CA_NT = 128;  // threads per CTA: 4 warps of 16 rows
constexpr int CA_ROWS = 64;
constexpr int CA_KEYS = 64;
constexpr int CA_MERGE_ROWS = 16;  // rows per CTA of the merge kernel
constexpr int CA_MERGE_NT = 256;
// the attention kernel's launch bounds: CTAs a SM (~103 KB at d 128, ~197 KB at 256)
__host__ __device__ constexpr int ca_ctas_per_sm(int d) { return d > 128 ? 1 : 2; }
// the output fragment's 8-column tiles a thread holds: HD = 0 (d at run time) up to 128
__host__ __device__ constexpr int ca_out_tiles(int HD) { return HD > 128 ? HD / 8 : 16; }
constexpr int CA_SMEM_MAX = 232448;  // what a CTA may opt in to on the H100

// shared-memory row stride, in elements, of a tile of T (conflict-free
// fragment loads)
template <typename T>
__host__ __device__ __forceinline__ int kv_ld(int d) {
  return sizeof(T) == 4 ? d + 4 : d + 8;
}

// Shared memory: the query tile in q's dtype, then a key region holding two
// float16 K/V buffers (double-buffered chunk tiles) or one float32 suffix
// K/V buffer, which fits in the same bytes.
__host__ __device__ constexpr size_t ca_q_bytes(int d, int tq_size) {
  return (size_t)CA_ROWS * (tq_size == 4 ? d + 4 : d + 8) * tq_size;
}
__host__ __device__ constexpr size_t ca_buf_bytes(int d) {  // one float16 K/V buffer
  return 2 * (size_t)CA_KEYS * (d + 8) * 2;
}
__host__ __device__ constexpr size_t ca_smem(int d, int tq_size) {
  return ca_q_bytes(d, tq_size) + 2 * ca_buf_bytes(d);
}
// the indexed form's chunk indices in shared memory, past the K/V buffers
constexpr int CA_IDX_CAP = 8192;

// One member's split layout: key tiles of bk = 64 / c * c chunk keys (n_ct
// of them) then ceil(s / 64) suffix tiles, tps key tiles per split over
// n_split splits, `splits` being as many as fill every SM of the device
// with ca_ctas_per_sm(d) CTAs in one wave for one member. It depends on the
// member's own shape and n_valid only, so a member of an indexed call and a
// gathered call on its chunks split alike.
struct CaMember {
  int n_valid, n_ct, tps, n_split;
};

__host__ __device__ __forceinline__ CaMember ca_member(int n_valid, int s, int c, int splits) {
  CaMember M;
  const int bk = (CA_KEYS / c) * c;
  M.n_valid = n_valid;
  M.n_ct = (n_valid * c + bk - 1) / bk;
  const int n_tiles = M.n_ct + (s + CA_KEYS - 1) / CA_KEYS;
  M.tps = (n_tiles + splits - 1) / splits;
  M.n_split = (n_tiles + M.tps - 1) / M.tps;
  return M;
}

// A member's float32 scratch: split partials (output, max, denominator),
// then the raw per-(row, chunk) mass, the max per (row, chunk tile) it was
// taken at, and the merge CTAs' partial A_j.
struct CaScratch {
  float *o_part, *m_part, *l_part, *raw, *m_at, *partial;
};

__host__ __device__ __forceinline__ size_t ca_member_floats(int n_split, int n_valid, int n_ct,
                                                            int n_kv, int rows, int n_mp, int d) {
  return (size_t)n_split * n_kv * rows * (d + 2) + (size_t)n_kv * rows * (n_valid + n_ct) +
         (size_t)n_kv * n_mp * n_valid;
}

__host__ __device__ __forceinline__ CaScratch ca_scratch(float* base, const CaMember& M, int n_kv,
                                                         int rows, int d) {
  CaScratch S;
  const size_t part_rows = (size_t)M.n_split * n_kv * rows;
  S.o_part = base;
  S.m_part = S.o_part + part_rows * d;
  S.l_part = S.m_part + part_rows;
  S.raw = S.l_part + part_rows;
  S.m_at = S.raw + (size_t)n_kv * rows * M.n_valid;
  S.partial = S.m_at + (size_t)n_kv * rows * M.n_ct;
  return S;
}

// member i's n_valid: the gathered form's scalar, or the indexed form's
// n_valid[i] clamped to [0, nb]
__device__ __forceinline__ int member_n_valid(const int* n_valid_of, int i, int n_valid, int nb) {
  return n_valid_of ? min(max(__ldg(n_valid_of + i), 0), nb) : n_valid;
}

// cp.async rows [t0, t0 + 64) of a (rows, n_kv, d) tensor's head h into a
// tile of row stride kv_ld<T>(d); rows at or past t0 + n are zeros
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src, size_t row_stride, int t0,
                                                int n, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = d / VEC, ld = kv_ld<T>(d);
  for (int i = threadIdx.x; i < CA_KEYS * per_row; i += CA_NT) {
    const int kk = i / per_row, e = (i % per_row) * VEC;
    const bool ok = kk < n;
    cp_async16_zfill(dst + kk * ld + e, ok ? src + (size_t)(t0 + kk) * row_stride + e : src, ok);
  }
}

// copy_rows_async of chunk keys [t0, t0 + 64): the gathered form reads key t
// at row t of src; the indexed form reads it at token t % c of chunk
// sidx[t / c - j0] of a pool of c-token chunks. Only keys below t0 + n (all
// of valid chunks) form an address.
template <bool INDEXED>
__device__ __forceinline__ void copy_chunk_rows_async(__half* dst, const __half* src,
                                                      size_t row_stride, int t0, int n, int d,
                                                      int c, const int* sidx, int j0) {
  if constexpr (!INDEXED) {
    copy_rows_async<__half>(dst, src, row_stride, t0, n, d);
  } else {
    constexpr int VEC = 8;
    const int per_row = d / VEC, ld = kv_ld<__half>(d);
    for (int i = threadIdx.x; i < CA_KEYS * per_row; i += CA_NT) {
      const int kk = i / per_row, e = (i % per_row) * VEC;
      const bool ok = kk < n;
      const __half* from = src;
      if (ok) {
        const int key = t0 + kk, j = key / c;
        from = src + ((size_t)sidx[j - j0] * c + (key - j * c)) * row_stride + e;
      }
      cp_async16_zfill(dst + kk * ld + e, from, ok);
    }
  }
}

__device__ __forceinline__ uint32_t exact_tf32(float x) { return __float_as_uint(x); }

// sc[nt] = Q (this warp's 16 rows) . K[8 nt .. 8 nt + 7]^T. HD > 0 fixes d at
// compile time; HD = 0 takes d at run time.
template <int HD, typename TQ, typename KT>
__device__ __forceinline__ void tile_scores_tc(const TQ* qs, const KT* ks, int d, int g, int t,
                                               float sc[8][4]) {
  constexpr bool Q_SPLIT = sizeof(TQ) == 4;
  const int D = HD ? HD : d, ldq = kv_ld<TQ>(D), ldk = kv_ld<KT>(D);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < D; k0 += 8) {
    const TQ* q0 = qs + g * ldq + k0 + t;
    const float af[4] = {to_f32(q0[0]), to_f32(q0[8 * ldq]), to_f32(q0[4]),
                         to_f32(q0[8 * ldq + 4])};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (Q_SPLIT) tf32_split(af[i], ah[i], al[i]);
      else ah[i] = exact_tf32(af[i]);
    }
    float bf[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const KT* kr = ks + (nt * 8 + g) * ldk + k0 + t;
      bf[nt][0] = to_f32(kr[0]);
      bf[nt][1] = to_f32(kr[4]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (sizeof(KT) == 4) {  // float32 suffix key against a float32 query
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(bf[nt][0], bh0, bl0);
        tf32_split(bf[nt][1], bh1, bl1);
        mma_tf32(sc[nt], al, bh0, bh1);
        mma_tf32(sc[nt], ah, bl0, bl1);
        mma_tf32(sc[nt], ah, bh0, bh1);
      } else if (Q_SPLIT) {
        mma_tf32(sc[nt], al, exact_tf32(bf[nt][0]), exact_tf32(bf[nt][1]));
        mma_tf32(sc[nt], ah, exact_tf32(bf[nt][0]), exact_tf32(bf[nt][1]));
      } else {
        mma_tf32(sc[nt], ah, exact_tf32(bf[nt][0]), exact_tf32(bf[nt][1]));
      }
    }
  }
}

// o += P (this warp's 16 rows x the tile's 64 keys) . V
template <int HD, typename VT>
__device__ __forceinline__ void tile_pv_tc(const float p[8][4], const VT* vs, int d, int g, int t,
                                           float o[ca_out_tiles(HD)][4]) {
  constexpr int ODT = ca_out_tiles(HD);
  const int D = HD ? HD : d, ldv = kv_ld<VT>(D);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    // key 2t of the score fragment is the A fragment's column t, key 2t + 1 its t + 4
    uint32_t ph[4], pl[4];
    tf32_split(p[nt][0], ph[0], pl[0]);
    tf32_split(p[nt][2], ph[1], pl[1]);
    tf32_split(p[nt][1], ph[2], pl[2]);
    tf32_split(p[nt][3], ph[3], pl[3]);
    const VT* v0 = vs + (nt * 8 + 2 * t) * ldv + g;
#pragma unroll
    for (int dt = 0; dt < ODT; ++dt) {
      if (HD ? dt >= HD / 8 : dt * 8 >= d) break;
      const float b0 = to_f32(v0[dt * 8]), b1 = to_f32(v0[ldv + dt * 8]);
      if (sizeof(VT) == 4) {
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(b0, bh0, bl0);
        tf32_split(b1, bh1, bl1);
        mma_tf32(o[dt], pl, bh0, bh1);
        mma_tf32(o[dt], ph, bl0, bl1);
        mma_tf32(o[dt], ph, bh0, bh1);
      } else {
        mma_tf32(o[dt], pl, exact_tf32(b0), exact_tf32(b1));
        mma_tf32(o[dt], ph, exact_tf32(b0), exact_tf32(b1));
      }
    }
  }
}

// The attention pass: one CTA per (64-row tile, member and kv head, split of
// the key tiles). Stores the split's unnormalised output, max and
// denominator per row, and per (row, chunk) the raw mass with, per (row,
// chunk tile), the max it was taken at, into the member's scratch at work +
// member * member_floats. A CTA past its member's own splits exits.
template <int HD, typename TQ, bool INDEXED>
static __global__ void __launch_bounds__(CA_NT, ca_ctas_per_sm(HD)) chunk_attn_kernel(
    const TQ* __restrict__ q, const __half* __restrict__ k_sel, const __half* __restrict__ v_sel,
    const TQ* __restrict__ k_suf, const TQ* __restrict__ v_suf, const int* __restrict__ chunk_idx,
    const int* __restrict__ n_valid_of, float* __restrict__ work, size_t member_floats, int s,
    int n_q, int n_kv, int nb, int c, int n_valid_all, int d_rt, int splits, float scale) {
  constexpr bool WIDE_SUFFIX = sizeof(TQ) == 4;  // a float32 suffix tile takes both buffers
  constexpr int ODT = ca_out_tiles(HD);
  const int d = HD ? HD : d_rt;
  const int mem = blockIdx.y / n_kv, h = blockIdx.y % n_kv, rt = blockIdx.x, sp = blockIdx.z;
  const CaMember M = ca_member(member_n_valid(n_valid_of, mem, n_valid_all, nb), s, c, splits);
  if (sp >= M.n_split) return;
  const int G = n_q / n_kv, rows = G * s, r0 = rt * CA_ROWS;
  const CaScratch S = ca_scratch(work + mem * member_floats, M, n_kv, rows, d);
  float* __restrict__ raw = S.raw;
  float* __restrict__ m_at = S.m_at;
  q += (size_t)mem * s * n_q * d;
  k_suf += (size_t)mem * s * n_kv * d;
  v_suf += (size_t)mem * s * n_kv * d;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TQ* qs = reinterpret_cast<TQ*>(smem_raw);  // [64][kv_ld<TQ>(d)]
  unsigned char* kv = smem_raw + ca_q_bytes(d, sizeof(TQ));
  const size_t buf_bytes = ca_buf_bytes(d);
  int* sidx = reinterpret_cast<int*>(kv + 2 * buf_bytes);  // the indexed form's chunk indices

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n_valid = M.n_valid, n_ct = M.n_ct, tps = M.tps;
  const int n_pre = n_valid * c, cpt = CA_KEYS / c, bk = cpt * c;
  // the last suffix key any row of this tile sees: later suffix tiles are skipped
  const int last_pos = min(s - 1, (min(r0 + CA_ROWS, rows) - 1) / G);
  const int n_tiles = n_ct + last_pos / CA_KEYS + 1;
  const int tile_lo = sp * tps, tile_hi = min(n_tiles, tile_lo + tps);
  // the chunks of this CTA's chunk tiles: [j_lo, j_hi)
  const int j_lo = min(tile_lo * cpt, n_valid), j_hi = min(min(tile_hi, n_ct) * cpt, n_valid);
  int row[2], pos[2];  // this lane's rows (g and g + 8 of its warp); pos -1: no such row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + warp * 16 + g + 8 * i;
    pos[i] = row[i] < rows ? row[i] / G : -1;
  }
  int col_chunk[8][2];  // chunk (within a chunk tile) of each score column this lane holds
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) col_chunk[nt][e] = (nt * 8 + 2 * t + e) / c;

  // K and V of a tile into buffer `buf` (a float32 suffix tile: buffer 0, both halves)
  auto fetch = [&](int tile, int buf) {
    unsigned char* base = kv + buf * buf_bytes;
    if (tile < n_ct) {
      const int t0 = tile * bk, n = min(bk, n_pre - t0);
      copy_chunk_rows_async<INDEXED>((__half*)base, k_sel + (size_t)h * d, (size_t)n_kv * d, t0,
                                     n, d, c, sidx, j_lo);
      copy_chunk_rows_async<INDEXED>((__half*)(base + buf_bytes / 2), v_sel + (size_t)h * d,
                                     (size_t)n_kv * d, t0, n, d, c, sidx, j_lo);
    } else {
      const int t0 = (tile - n_ct) * CA_KEYS, n = min(CA_KEYS, s - t0);
      const size_t half = WIDE_SUFFIX ? buf_bytes : buf_bytes / 2;
      copy_rows_async<TQ>((TQ*)base, k_suf + (size_t)h * d, (size_t)n_kv * d, t0, n, d);
      copy_rows_async<TQ>((TQ*)(base + half), v_suf + (size_t)h * d, (size_t)n_kv * d, t0, n, d);
    }
    cp_async_commit_group();
  };
  auto fits_half = [&](int tile) { return tile < n_ct || !WIDE_SUFFIX; };

  // the query rows and the first tile in one round trip
  {
    constexpr int VEC = 16 / sizeof(TQ);
    const int per_row = d / VEC, ldq = kv_ld<TQ>(d);
    for (int i = tid; i < CA_ROWS * per_row; i += CA_NT) {
      const int rr = i / per_row, e = (i % per_row) * VEC, r = r0 + rr;
      const bool ok = r < rows;
      cp_async16_zfill(qs + rr * ldq + e,
                       ok ? q + ((size_t)(r / G) * n_q + h * G + r % G) * d + e : q, ok);
    }
  }
  if (INDEXED) {  // the member's indices of this CTA's chunks, one load each
    const int* row_idx = chunk_idx + (size_t)mem * nb;
    for (int j = j_lo + tid; j < j_hi; j += CA_NT) sidx[j - j_lo] = __ldg(row_idx + j);
    __syncthreads();
  }
  int buf = 0;
  if (tile_lo < tile_hi) fetch(tile_lo, 0);
  const TQ* qw = qs + warp * 16 * kv_ld<TQ>(d);

  float o[ODT][4], m_run[2] = {CKV_NEG_INF, CKV_NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < ODT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const bool chunk = tile < n_ct;
    const int t0 = chunk ? tile * bk : (tile - n_ct) * CA_KEYS;
    const int nk = chunk ? min(bk, n_pre - t0) : min(CA_KEYS, s - t0);
    // prefetch the next tile into the other buffer where both fit beside each other
    const bool prefetch = tile + 1 < tile_hi && fits_half(tile) && fits_half(tile + 1);
    if (prefetch) {
      fetch(tile + 1, buf ^ 1);
      cp_async_wait_groups<1>();
    } else {
      cp_async_wait_groups<0>();
    }
    __syncthreads();
    const unsigned char* kb = kv + buf * buf_bytes;
    float sc[8][4];
    if (chunk)
      tile_scores_tc<HD, TQ, __half>(qw, (const __half*)kb, d, g, t, sc);
    else
      tile_scores_tc<HD, TQ, TQ>(qw, (const TQ*)kb, d, g, t, sc);
    // mask, scale, online softmax; sc becomes exp(s - m_new), 0 where masked
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = CKV_NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const bool vis = pos[i] >= 0 && col < nk && (chunk || t0 + col <= pos[i]);
          float& x = sc[nt][2 * i + e];
          x = vis ? x * scale : CKV_NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * i + e];
          x = CKV_MASKED(x) ? 0.f : expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
    }
#pragma unroll
    for (int dt = 0; dt < ODT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    if (chunk) {  // each (row, chunk)'s raw mass, taken at the row's max after this tile
      const int j0 = t0 / c, n_ch = min(cpt, n_valid - j0);
      for (int ch = 0; ch < n_ch; ++ch) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col_chunk[nt][e] == ch) v += sc[nt][2 * i + e];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0 && pos[i] >= 0) raw[((size_t)h * rows + row[i]) * n_valid + j0 + ch] = v;
        }
      }
      if (t == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (pos[i] >= 0) m_at[((size_t)h * rows + row[i]) * n_ct + tile] = m_run[i];
      tile_pv_tc<HD, __half>(sc, (const __half*)(kb + buf_bytes / 2), d, g, t, o);
    } else {
      tile_pv_tc<HD, TQ>(sc, (const TQ*)(kb + (WIDE_SUFFIX ? buf_bytes : buf_bytes / 2)), d, g,
                         t, o);
    }
    __syncthreads();  // every reader of this buffer is done before it is refilled
    if (tile + 1 < tile_hi && !prefetch) fetch(tile + 1, 0);
    buf = prefetch ? buf ^ 1 : 0;
  }

  cp_async_wait_all();  // a split past this tile's last visible key loaded only q
  // this split's partials: [split][kv head][row]
  const size_t base = ((size_t)sp * n_kv + h) * rows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] < 0) continue;
    float* dst = S.o_part + (base + row[i]) * d + 2 * t;
#pragma unroll
    for (int dt = 0; dt < ODT; ++dt) {
      if (HD ? dt >= HD / 8 : dt * 8 >= d) break;
      *reinterpret_cast<float2*>(dst + dt * 8) = make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
    }
    if (t == 0) {
      S.m_part[base + row[i]] = m_run[i];
      S.l_part[base + row[i]] = l_run[i];
    }
  }
}

// The merge: one CTA per (16 rows, kv head, member). It merges the member's
// splits in split order into the output rows and sums the rows' mass on each
// chunk (rows in order, each rescaled from the max its raw mass was taken at
// to its final max and denominator); the member's last CTA to finish (its
// own counter) sums those partial masses, in the order of (kv head, 16
// rows), into its A_j. Every load the first batch needs (statistics,
// outputs, raw masses) is started before any is used, so at the main path's
// shape the CTA's own work is one round trip.
static __global__ void __launch_bounds__(CA_MERGE_NT) chunk_merge_kernel(
    float* __restrict__ work, size_t member_floats, const int* __restrict__ n_valid_of,
    int* __restrict__ counters, float* __restrict__ out, float* __restrict__ mass, int s,
    int n_q, int n_kv, int nb, int c, int n_valid_all, int d, int splits) {
  constexpr int SB = 12;  // splits per batch (the main path has 9)
  constexpr int RK = 2;   // output rows per thread per pass
  constexpr int R = CA_MERGE_ROWS;
  __shared__ float m_fin[R], inv_l[R], fin[CA_MERGE_NT];
  __shared__ int flag;
  const int tid = threadIdx.x, h = blockIdx.y, part = blockIdx.x, mem = blockIdx.z;
  const int G = n_q / n_kv, rows = G * s, r0 = part * R;
  const int n_rows = min(R, rows - r0);
  const CaMember M = ca_member(member_n_valid(n_valid_of, mem, n_valid_all, nb), s, c, splits);
  const CaScratch S = ca_scratch(work + mem * member_floats, M, n_kv, rows, d);
  const float* __restrict__ o_part = S.o_part;
  const float* __restrict__ m_part = S.m_part;
  const float* __restrict__ l_part = S.l_part;
  const float* __restrict__ raw = S.raw;
  const float* __restrict__ m_at = S.m_at;
  float* __restrict__ partial = S.partial;
  int* __restrict__ counter = counters + mem;
  out += (size_t)mem * s * n_q * d;
  mass += (size_t)mem * nb;
  const int n_valid = M.n_valid, n_split = M.n_split, cpt = CA_KEYS / c, n_ct = M.n_ct;
  const size_t stride = (size_t)n_kv * rows, hrow = (size_t)h * rows + r0;
  // output items: column group tid % d4 of rows tid / d4 + k * rstep
  const int d4 = d / 4, x4 = (tid % d4) * 4, rstep = CA_MERGE_NT / d4, rr0 = tid / d4;
  auto out_row = [&](int k) { return min(rr0 + k * rstep, n_rows - 1); };
  // start loading: the first batch of this thread's outputs, its chunk's raw masses,
  // and (threads < 16) its row's statistics
  float4 v[RK][SB];
  float w[RK][SB];
#pragma unroll
  for (int k = 0; k < RK; ++k)
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const size_t o2 = min(u, n_split - 1) * stride + hrow + out_row(k);
      v[k][u] = __ldcg(reinterpret_cast<const float4*>(o_part + o2 * d + x4));
      w[k][u] = __ldcg(m_part + o2);
    }
  const int jm = min(tid, max(n_valid, 1) - 1);
  float rw[R], ma[R];
  if (n_valid > 0)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const size_t at = hrow + min(k, n_rows - 1);
      rw[k] = __ldcg(raw + at * n_valid + jm);
      ma[k] = __ldcg(m_at + at * n_ct + jm / cpt);
    }
  if (tid < n_rows) {  // final max and 1 / denominator of row r0 + tid
    const size_t at = hrow + tid;
    float mm[SB], ll[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const size_t o2 = min(u, n_split - 1) * stride + at;
      mm[u] = __ldcg(m_part + o2);
      ll[u] = __ldcg(l_part + o2);
    }
    float m = CKV_NEG_INF, l = 0.f;
#pragma unroll
    for (int u = 0; u < SB; ++u) m = fmaxf(m, mm[u]);  // the max: order-free
    for (int x = SB; x < n_split; ++x) m = fmaxf(m, __ldcg(m_part + x * stride + at));
#pragma unroll
    for (int u = 0; u < SB; ++u)
      if (u < n_split) l += ll[u] * expf(mm[u] - m);
    for (int x = SB; x < n_split; ++x)
      l += __ldcg(l_part + x * stride + at) * expf(__ldcg(m_part + x * stride + at) - m);
    m_fin[tid] = m;
    inv_l[tid] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // the output, splits in order
  for (int base = 0; base < n_rows; base += RK * rstep) {
    float4 acc[RK];
#pragma unroll
    for (int k = 0; k < RK; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x0 = 0; x0 < n_split; x0 += SB) {
      if (x0 > 0 || base > 0) {  // past the batch started above
#pragma unroll
        for (int k = 0; k < RK; ++k)
#pragma unroll
          for (int u = 0; u < SB; ++u) {
            const size_t o2 = min(x0 + u, n_split - 1) * stride + hrow +
                              min(base + rr0 + k * rstep, n_rows - 1);
            v[k][u] = __ldcg(reinterpret_cast<const float4*>(o_part + o2 * d + x4));
            w[k][u] = __ldcg(m_part + o2);
          }
      }
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        const float m = m_fin[min(base + rr0 + k * rstep, n_rows - 1)];
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          if (x0 + u >= n_split) break;
          const float wk = expf(w[k][u] - m);
          acc[k].x = fmaf(v[k][u].x, wk, acc[k].x);
          acc[k].y = fmaf(v[k][u].y, wk, acc[k].y);
          acc[k].z = fmaf(v[k][u].z, wk, acc[k].z);
          acc[k].w = fmaf(v[k][u].w, wk, acc[k].w);
        }
      }
    }
    if (tid < rstep * d4)
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        const int rr = base + rr0 + k * rstep, r = r0 + rr;
        if (rr >= n_rows) break;
        const float inv = inv_l[rr];
        *reinterpret_cast<float4*>(out + ((size_t)(r / G) * n_q + h * G + r % G) * d + x4) =
            make_float4(acc[k].x * inv, acc[k].y * inv, acc[k].z * inv, acc[k].w * inv);
      }
  }
  // these rows' mass on each chunk j, rows in order
  for (int j = tid; j < n_valid; j += CA_MERGE_NT) {
    if (j != tid)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const size_t at = hrow + min(k, n_rows - 1);
        rw[k] = __ldcg(raw + at * n_valid + j);
        ma[k] = __ldcg(m_at + at * n_ct + j / cpt);
      }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k >= n_rows) break;
      acc += rw[k] * expf(ma[k] - m_fin[k]) * inv_l[k];
    }
    partial[((size_t)h * gridDim.x + part) * n_valid + j] = acc;
  }
  const int n_parts = n_kv * gridDim.x;
  if (!last_to_arrive(counter, n_parts, &flag)) return;

  // A_j = the parts' masses summed in part order. tpc threads share a chunk:
  // each sums a contiguous run of parts, then the runs are added in order.
  int tpc = 1;
  while (tpc * 2 <= CA_MERGE_NT / max(1, nb) && tpc < 16) tpc *= 2;
  const int per = (n_parts + tpc - 1) / tpc;
  for (int j0 = 0; j0 < nb; j0 += CA_MERGE_NT / tpc) {
    const int j = j0 + tid / tpc, run = tid % tpc;
    float a = 0.f;
    if (j < min(nb, n_valid)) {
      const int x_end = min(n_parts, run * per + per);
      for (int x0 = run * per; x0 < x_end; x0 += 32) {
        float pv[32];
#pragma unroll
        for (int u = 0; u < 32; ++u)
          pv[u] = __ldcg(partial + (size_t)min(x0 + u, x_end - 1) * n_valid + j);
#pragma unroll
        for (int u = 0; u < 32; ++u)
          if (x0 + u < x_end) a += pv[u];
      }
    }
    fin[tid] = a;
    __syncthreads();
    if (run == 0 && j < nb) {
      float tot = 0.f;
      for (int k = 0; k < tpc; ++k) tot += fin[tid + k];
      mass[j] = tot;
    }
    __syncthreads();
  }
}

template <int HD, typename TQ, bool INDEXED>
static cudaError_t launch_attn(dim3 grid, size_t smem, cudaStream_t st, const void* q,
                               const void* k_sel, const void* v_sel, const void* k_suf,
                               const void* v_suf, const int* chunk_idx, const int* n_valid_of,
                               float* work, size_t member_floats, int s, int n_q, int n_kv,
                               int nb, int c, int n_valid, int d, int splits) {
  // at the instance's largest d (and index block), as far as a CTA may have
  constexpr size_t max_smem = std::min<size_t>(
      ca_smem(HD > 128 ? HD : 128, sizeof(TQ)) + (INDEXED ? CA_IDX_CAP * sizeof(int) : 0),
      CA_SMEM_MAX);
  if (smem > max_smem) return cudaErrorInvalidValue;
  static OncePerDevice smem_opt_in;
  const cudaError_t attr = smem_opt_in([] {
    return cudaFuncSetAttribute(chunk_attn_kernel<HD, TQ, INDEXED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
  });
  if (attr != cudaSuccess) return attr;
  chunk_attn_kernel<HD, TQ, INDEXED><<<grid, CA_NT, smem, st>>>(
      (const TQ*)q, (const __half*)k_sel, (const __half*)v_sel, (const TQ*)k_suf,
      (const TQ*)v_suf, chunk_idx, n_valid_of, work, member_floats, s, n_q, n_kv, nb, c,
      n_valid, d, splits, softmax_scale(d));
  return cudaGetLastError();
}

// The work of one call: rows = n_q / n_kv * s per kv head in n_rt tiles of
// 64 and n_mp merge CTAs of 16; `splits` (ca_member) from the current
// device's SMs; the launch's grid.z and each member's float32 scratch. A
// gathered call takes the layout of its own n_valid. An indexed call's
// members may have any n_valid up to nb: grid.z and the scratch each member
// is given cover them all (no member has more than min(splits, its tiles)
// splits, nor more chunks or chunk tiles than at n_valid = nb), and every
// member's CTA past its own splits exits.
struct CaLayout {
  int rows, n_rt, n_mp, splits, n_z, idx_ints;
  size_t member_floats;
};

static cudaError_t ca_layout(int s, int n_q, int n_kv, int c, int n_valid, int d, bool any_valid,
                             CaLayout* L) {
  if (d % 8 || (d > 128 && d != 256) || d < 8 || c < 1 || c > CA_KEYS || s < 1 || n_kv < 1 || n_q % n_kv ||
      n_valid < 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  L->rows = (n_q / n_kv) * s;
  L->n_rt = (L->rows + CA_ROWS - 1) / CA_ROWS;
  L->n_mp = (L->rows + CA_MERGE_ROWS - 1) / CA_MERGE_ROWS;  // merge CTAs per kv head
  L->splits = std::max(1, ca_ctas_per_sm(d) * sms / (L->n_rt * n_kv));
  const CaMember M = ca_member(n_valid, s, c, L->splits);
  const int n_tiles = M.n_ct + (s + CA_KEYS - 1) / CA_KEYS;
  L->n_z = any_valid ? std::min(L->splits, n_tiles) : M.n_split;
  L->idx_ints = any_valid ? M.tps * (CA_KEYS / c) : 0;
  // rounded to 4 floats: the next member's split partials start 16-byte
  // aligned, as the merge's float4 reads of them need
  L->member_floats =
      (ca_member_floats(L->n_z, n_valid, M.n_ct, n_kv, L->rows, L->n_mp, d) + 3) / 4 * 4;
  return cudaSuccess;
}

// b members: q (b, s, n_q, d) and k_suf/v_suf (b, s, n_kv, d); the gathered
// form (chunk_idx null) reads b = 1's chunks from k_sel/v_sel, the indexed
// one from the pool through chunk_idx (b, nb) and n_valid_of (b,).
template <typename TQ, bool INDEXED>
static int launch_chunk_attention(const void* q, const void* k_sel, const void* v_sel,
                                  const void* k_suf, const void* v_suf, const int* chunk_idx,
                                  const int* n_valid_of, float* out, float* mass, float* work,
                                  long long work_floats, int* counters, int b, int s, int n_q,
                                  int n_kv, int nb, int c, int n_valid, int d, cudaStream_t st) {
  CaLayout L;
  cudaError_t e = ca_layout(s, n_q, n_kv, c, n_valid, d, INDEXED, &L);
  if (e != cudaSuccess) return (int)e;
  if (b < 1 || b > 65535 / n_kv || n_valid > nb || work_floats < 0 ||
      (size_t)work_floats < (size_t)b * L.member_floats || L.idx_ints > CA_IDX_CAP)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ca_smem(d, sizeof(TQ)) + (size_t)L.idx_ints * sizeof(int);
  const dim3 grid(L.n_rt, n_kv * b, L.n_z);
  auto attn = [&](auto fn) {
    return fn(grid, smem, st, q, k_sel, v_sel, k_suf, v_suf, chunk_idx, n_valid_of, work,
              L.member_floats, s, n_q, n_kv, nb, c, n_valid, d, L.splits);
  };
  e = d == 256   ? attn(launch_attn<256, TQ, INDEXED>)
      : d == 128 ? attn(launch_attn<128, TQ, INDEXED>)
                 : attn(launch_attn<0, TQ, INDEXED>);
  if (e != cudaSuccess) return (int)e;
  chunk_merge_kernel<<<dim3(L.n_mp, n_kv, b), CA_MERGE_NT, 0, st>>>(
      work, L.member_floats, n_valid_of, counters, out, mass, s, n_q, n_kv, nb, c, n_valid, d,
      L.splits);
  return (int)cudaGetLastError();
}

template <bool INDEXED>
static int dispatch_chunk_attention(const void* q, const void* k_sel, const void* v_sel,
                                    const void* k_suf, const void* v_suf, const int* chunk_idx,
                                    const int* n_valid_of, float* out, float* mass, float* work,
                                    long long work_floats, int* counters, int b, int s, int n_q,
                                    int n_kv, int nb, int c, int n_valid, int d, int q_dtype,
                                    cudaStream_t st) {
  switch (q_dtype) {
    case F32:
      return launch_chunk_attention<float, INDEXED>(q, k_sel, v_sel, k_suf, v_suf, chunk_idx,
                                                    n_valid_of, out, mass, work, work_floats,
                                                    counters, b, s, n_q, n_kv, nb, c, n_valid, d,
                                                    st);
    case BF16:
      return launch_chunk_attention<__nv_bfloat16, INDEXED>(
          q, k_sel, v_sel, k_suf, v_suf, chunk_idx, n_valid_of, out, mass, work, work_floats,
          counters, b, s, n_q, n_kv, nb, c, n_valid, d, st);
    case F16:
      return launch_chunk_attention<__half, INDEXED>(q, k_sel, v_sel, k_suf, v_suf, chunk_idx,
                                                     n_valid_of, out, mass, work, work_floats,
                                                     counters, b, s, n_q, n_kv, nb, c, n_valid,
                                                     d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ckv

// The float32 scratch one ckv_chunk_attention call needs on the current
// device (its split layout is chosen here and nowhere else), or -1 for a
// shape it does not take or a CUDA error.
extern "C" long long ckv_chunk_attention_work_floats(int s, int n_q, int n_kv, int c,
                                                     int n_valid, int d) {
  ckv::CaLayout L;
  if (ckv::ca_layout(s, n_q, n_kv, c, n_valid, d, false, &L) != cudaSuccess) return -1;
  return (long long)L.member_floats;
}

// The float32 scratch one ckv_chunk_attention_indexed call of b members
// with n_sel index slots each needs on the current device, or -1.
extern "C" long long ckv_chunk_attention_indexed_work_floats(int b, int s, int n_q, int n_kv,
                                                             int c, int n_sel, int d) {
  ckv::CaLayout L;
  if (b < 1 || ckv::ca_layout(s, n_q, n_kv, c, n_sel, d, true, &L) != cudaSuccess) return -1;
  return (long long)(b * L.member_floats);
}

// q (s, n_q, d), k_suf/v_suf (s, n_kv, d) in q_dtype; k_sel/v_sel (nb, c, n_kv, d) float16
// with the first n_valid chunks valid; out (s, n_q, d) float32; mass (nb,) float32.
// d: a multiple of 8 up to 128, or 256.
// work: float32 scratch of work_floats >= ckv_chunk_attention_work_floats(...)
// (cudaErrorInvalidValue otherwise); counters: one int32, zero before the
// launch and zero again after it.
extern "C" int ckv_chunk_attention(const void* q, const void* k_sel, const void* v_sel,
                                   const void* k_suf, const void* v_suf, float* out, float* mass,
                                   float* work, long long work_floats, int* counters, int s,
                                   int n_q, int n_kv, int nb, int c, int n_valid, int d,
                                   int q_dtype, void* stream) {
  return ckv::dispatch_chunk_attention<false>(q, k_sel, v_sel, k_suf, v_suf, nullptr, nullptr,
                                              out, mass, work, work_floats, counters, 1, s, n_q,
                                              n_kv, nb, c, n_valid, d, q_dtype,
                                              (cudaStream_t)stream);
}

// The indexed form over b members: q (b, s, n_q, d), k_suf/v_suf (b, s, n_kv, d) in q_dtype;
// k_pool/v_pool (m, c, n_kv, d) float16; chunk_idx (b, n_sel) int32 in [0, m), of which
// member i reads the first n_valid[i] (n_valid (b,) int32, clamped to [0, n_sel]); out
// (b, s, n_q, d) float32; mass (b, n_sel) float32, 0 past n_valid[i]. work: float32 scratch
// of work_floats >= ckv_chunk_attention_indexed_work_floats(...); counters: b int32, zero
// before the launch and zero again after it.
extern "C" int ckv_chunk_attention_indexed(const void* q, const void* k_pool, const void* v_pool,
                                           const void* k_suf, const void* v_suf,
                                           const int* chunk_idx, const int* n_valid, float* out,
                                           float* mass, float* work, long long work_floats,
                                           int* counters, int b, int s, int n_q, int n_kv,
                                           int n_sel, int c, int d, int q_dtype, void* stream) {
  return ckv::dispatch_chunk_attention<true>(q, k_pool, v_pool, k_suf, v_suf, chunk_idx, n_valid,
                                             out, mass, work, work_floats, counters, b, s, n_q,
                                             n_kv, n_sel, c, n_sel, d, q_dtype,
                                             (cudaStream_t)stream);
}
