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
// Bound on the H100 at the main path's shape (28 query heads, 64 rows, 4096
// keys, d = 128): q . k is 1.88 GFLOP against ~5 MB of inputs. With float32
// queries (every identify past layer 0) the products run as two split terms
// on the tensor cores: 3.76 GFLOP, ~3.8 us at the 989 TFLOP/s float16 rate
// (~7.6 us at TF32's 495), so operations bound it; the bytes take ~1.5 us.
//
// Products: mma.sync m16n8k16 in float16 with float32 accumulation, the
// keys as they are stored. Each query row is first scaled by a power of two
// so that its largest |q| lies in [2^14, 2^15) (exact; the logits are scaled
// back by the inverse power), then split into hi + lo, both float16
// (hi = rn(x), lo = rn(x - hi)): a product keeps q_lo k + q_hi k, exact
// products summed in float32, and the split's residual is below 2^-22 of
// each element (or 2^-39 of the row's largest, where lo is subnormal), as
// for a split-TF32 pair, inside the plain version's 1e-5. bfloat16 and
// float16 queries take one product (hi alone; exact wherever the scaled
// value is a normal float16). Split-TF32 m16n8k8 products instead take
// twice the mma instructions, and every warp converts each key element to
// TF32: in the same kernel otherwise, the split pass took 0.032 ms against
// 0.018 ms (H100 80GB HBM3, 700 W; scripts/chunk_score_variants.py as of
// commit 2d48249, which patched a copy of this file). The
// softmax runs in log2 units (ex2.approx of logit * log2 e).
// ref.chunk_score_split_ref repeats this arithmetic and the split
// decomposition below in plain torch.
//
// Two launches, no float atomics (top-k must be reproducible):
//   1. chunk_score_kernel: one CTA of 4 warps per (64 rows of one kv head —
//      the `group` query heads that share it, position-major —, split of the
//      key tiles). A warp owns 16 rows, whose split query fragments stay in
//      registers for the whole split; key tiles hold whole chunks (64 / c of
//      them) and are copied with cp.async, double-buffered, as float16 with a
//      row stride that makes each lane's 16-byte fragment load conflict-free;
//      the loaded words are the B fragments as they are. The contraction over
//      d is permuted (lane t reads d = 8t .. 8t + 7 of each 32-wide group,
//      and the A fragments follow), which changes the order of no sum the
//      tests can see beyond rounding. Each row keeps its running max and
//      denominator; each (row, chunk) mass is taken once, at the row's running
//      max after its tile, into shared memory, and at the split's end rescaled
//      to the split's final max and written out with the row's (max,
//      denominator). Three CTAs share an SM, so one wave takes ~5 key tiles a
//      split at the main path's shape (364 CTAs).
//   2. chunk_score_merge_kernel: one CTA per (32 rows, kv head) merges its
//      rows' split statistics in split order, scales each mass by
//      2^(m_split - m_r) / max(l_r, 1e-30) and sums its rows in order per
//      chunk; the last CTA to finish (an int32 arrival counter) sums those
//      partials, kv head by kv head and rows in order, into the (m,) output.
// Any n is accepted: the ragged last key tile and the partial last chunk are
// masked (the TPU kernel asserted n % block_k == 0); d is any width up to 256
// (zero-padded to 128, or past 128 to 256, in registers and shared memory), c
// up to 64. A d that
// is not a multiple of 8 (IMPRESS's partial keys, the first d / 8 dims of a
// head narrower than 64) leaves its rows off 16-byte boundaries, so q and the
// keys are then read element by element; every other d takes 16-byte loads.
// d = 128 and d = 256 (gemma3-4b's heads) with c = 16 (the main path) are
// compiled with their chunk loop unrolled; other shapes take a generic
// instance of their padded width. At 256 the split query fragments are 128
// registers a thread, so that instance runs two CTAs a SM (255 registers)
// and its key tiles take 72 KB of shared memory.
#include "common.cuh"

namespace ckv {

constexpr int CS_NT = 128;  // threads per CTA: 4 warps of 16 rows
constexpr int CS_ROWS = 64;
constexpr int CS_KEYS = 64;
constexpr int CS_CPS_MAX = 128;    // chunks per split held in shared memory
// head dims are zero-padded to DP = 128, or 256 past 128; key rows are DP + 32
// halves apart (320 or 576 bytes, both 64 mod 128: conflict-free fragments)
__host__ __device__ constexpr int cs_kld(int DP) { return DP + 32; }
__host__ __device__ constexpr int cs_dp(int d) { return d > 128 ? 256 : 128; }
// split-kernel CTAs a SM: at most 168 registers a thread at DP 128, 255 at 256
__host__ __device__ constexpr int cs_ctas_per_sm(int DP) { return DP > 128 ? 2 : 3; }
constexpr int CS_MERGE_ROWS = 32;  // rows per CTA of the merge kernel
constexpr int CS_MERGE_NT = 256;

// Shared memory of the split kernel: two float16 key buffers, then per row
// the split's raw chunk masses [64][cps], the max each tile's masses were
// taken at [64][tps], and the row's final max [64].
__host__ __device__ __forceinline__ size_t cs_smem(int cps, int tps, int DP) {
  return 2 * (size_t)CS_KEYS * cs_kld(DP) * sizeof(__half) +
         sizeof(float) * (size_t)CS_ROWS * (cps + tps + 1);
}

__device__ __forceinline__ float cs_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A pair of float32 values as float16 hi + lo words (the lower column in the
// lower half, as mma fragments hold them)
__device__ __forceinline__ void f16_split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const __half2 l = __floats2half2_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The contraction order of a 32-wide group of d: in k-step u (0, 1) of the
// group, mma column slots 2t, 2t + 1 hold d = 8t + 4u, 8t + 4u + 1 and slots
// 2t + 8, 2t + 9 hold d = 8t + 4u + 2, 8t + 4u + 3, so a lane's 8
// consecutive elements feed both k-steps.
template <typename TQ>
__device__ __forceinline__ void load8(const TQ* src, float v[8]) {
  if (sizeof(TQ) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    const TQ* e = reinterpret_cast<const TQ*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = to_f32(e[i]);
  }
}

// FAST: d = DP and c = 16 fixed at compile time; otherwise d (at most DP)
// and c are read at run time (d's padding groups skipped, chunks found per
// column).
template <typename TQ, int DP, bool FAST>
static __global__ void __launch_bounds__(CS_NT, cs_ctas_per_sm(DP)) chunk_score_kernel(
    const TQ* __restrict__ q, const __half* __restrict__ k, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ raw, int s, int n_q, int n_kv, int n,
    int d_rt, int c_rt, int tps, float scale2) {
  constexpr bool Q_SPLIT = sizeof(TQ) == 4;
  constexpr int KLD = cs_kld(DP), NG = DP / 32;  // key row stride; 32-wide d groups
  const int d = FAST ? DP : d_rt, c = FAST ? 16 : c_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __half* kbuf = reinterpret_cast<__half*>(smem_raw);  // [2][64][KLD]
  const int cpt = CS_KEYS / c, bk = cpt * c, cps = tps * cpt;
  float* raw_s = reinterpret_cast<float*>(smem_raw + 2 * CS_KEYS * KLD * sizeof(__half));
  float* m_at_s = raw_s + CS_ROWS * cps;  // [64][tps]
  float* m_fin_s = m_at_s + CS_ROWS * tps;  // [64]

  const int rt = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int G = n_q / n_kv, rows = G * s, r0 = rt * CS_ROWS;
  const int m = (n + c - 1) / c, n_tiles = (n + bk - 1) / bk;
  const int tile_lo = sp * tps, tile_hi = min(n_tiles, tile_lo + tps);

  // rows of a d that is not a multiple of 8 are not 16-byte aligned
  const bool vec = FAST || d % 8 == 0;
  // keys [t0, t0 + nk) of kv head h into buffer `buf`; zeros past nk and past d
  auto fetch = [&](int tile, int buf) {
    __half* dst = kbuf + buf * CS_KEYS * KLD;
    const int t0 = tile * bk, nk = min(bk, n - t0);
    for (int i = tid; i < CS_KEYS * (DP / 8); i += CS_NT) {
      const int kk = i / (DP / 8), e = (i % (DP / 8)) * 8;
      const __half* src = k + ((size_t)(t0 + kk) * n_kv + h) * d + e;
      if (vec) {
        const bool ok = kk < nk && e < d;
        cp_async16_zfill(dst + kk * KLD + e, ok ? src : k, ok);
      } else {  // element loads, stored as one 16-byte word (visible after the barrier)
        __align__(16) __half w[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) w[x] = kk < nk && e + x < d ? src[x] : __float2half(0.f);
        *reinterpret_cast<uint4*>(dst + kk * KLD + e) = *reinterpret_cast<const uint4*>(w);
      }
    }
    cp_async_commit_group();
  };
  fetch(tile_lo, 0);

  // this lane's rows (g and g + 8 of its warp), each scaled by a power of two
  // (its largest |q| to [2^14, 2^15)), as float16 hi + lo A fragments;
  // row_scale[i] turns a product back into a logit in log2 units
  int lrow[2];
  float row_scale[2];
  uint32_t qh[NG][2][4], ql[NG][2][4];  // [d group][k-step][fragment register]
  {
    float v[2][NG][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] = warp * 16 + g + 8 * i;
      const int r = r0 + lrow[i];
      const TQ* src = q + ((size_t)(r / G) * n_q + h * G + r % G) * d + 8 * t;
      float mx = 0.f;
#pragma unroll
      for (int gr = 0; gr < NG; ++gr) {
        if (r < rows && 32 * gr + 8 * t < d && vec) {
          load8<TQ>(src + 32 * gr, v[i][gr]);
        } else if (r < rows && 32 * gr + 8 * t < d) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[i][gr][e] = 32 * gr + 8 * t + e < d ? to_f32(src[32 * gr + e]) : 0.f;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][gr][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[i][gr][e]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // the biased exponent E of the row's largest |q|: scale by 2^(141 - E)
      // and back by 2^(E - 141), both normal for E in [15, 254]
      const int E = min(254, max(15, (int)((__float_as_uint(mx) >> 23) & 0xff)));
      const float up = __uint_as_float((uint32_t)(268 - E) << 23);
      row_scale[i] = scale2 * __uint_as_float((uint32_t)(E - 14) << 23);
#pragma unroll
      for (int gr = 0; gr < NG; ++gr)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][gr][e] *= up;
    }
#pragma unroll
    for (int gr = 0; gr < NG; ++gr)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // a0 (row g), a1 (row g + 8): slots 2t, 2t + 1; a2, a3: slots 2t + 8, 2t + 9
        f16_split(v[0][gr][4 * u], v[0][gr][4 * u + 1], qh[gr][u][0], ql[gr][u][0]);
        f16_split(v[1][gr][4 * u], v[1][gr][4 * u + 1], qh[gr][u][1], ql[gr][u][1]);
        f16_split(v[0][gr][4 * u + 2], v[0][gr][4 * u + 3], qh[gr][u][2], ql[gr][u][2]);
        f16_split(v[1][gr][4 * u + 2], v[1][gr][4 * u + 3], qh[gr][u][3], ql[gr][u][3]);
      }
  }
  const int n_grp = FAST ? NG : (d + 31) / 32;

  float m_run[2] = {CKV_NEG_INF, CKV_NEG_INF}, l_run[2] = {0.f, 0.f};
  int buf = 0;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    if (tile + 1 < tile_hi) {
      fetch(tile + 1, buf ^ 1);
      cp_async_wait_groups<1>();
    } else {
      cp_async_wait_groups<0>();
    }
    __syncthreads();
    const __half* kb = kbuf + buf * CS_KEYS * KLD;
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int gr = 0; gr < NG; ++gr) {
      if (!FAST && gr >= n_grp) break;
      uint4 kw[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        kw[nt] = *reinterpret_cast<const uint4*>(kb + (nt * 8 + g) * KLD + 32 * gr + 8 * t);
      // the 8 n-tiles' products are independent: each k-step and term starts
      // all 8 before the next depends on them
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (Q_SPLIT)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_16816<__half>(sc[nt], ql[gr][u], u ? kw[nt].z : kw[nt].x,
                              u ? kw[nt].w : kw[nt].y);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_16816<__half>(sc[nt], qh[gr][u], u ? kw[nt].z : kw[nt].x,
                            u ? kw[nt].w : kw[nt].y);
      }
    }
    // online softmax in log2 units: sc becomes 2^(s - m_new), 0 past the
    // tile's last key. Only a ragged last tile is masked; the max is taken on
    // the products (scaling by row_scale > 0 keeps their order) and the
    // scaling folded into the exponent's fma
    const int t0 = tile * bk, nk = min(bk, n - t0);
    if (nk < CS_KEYS)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (nt * 8 + 2 * t + (x & 1) >= nk) sc[nt][x] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * i], sc[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx * row_scale[i]);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * i + e];
          x = cs_exp2(fmaf(x, row_scale[i], -m_new));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[i] = l_run[i] * cs_exp2(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
    }
    // each (row, chunk)'s mass at the row's max after this tile
    const int j0 = t0 / c, n_ch = min(cpt, m - j0), slot = (tile - tile_lo) * cpt;
    if (FAST) {  // chunk ch is score columns 16 ch .. 16 ch + 15: n-tiles 2 ch and 2 ch + 1
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = (sc[2 * ch][2 * i] + sc[2 * ch][2 * i + 1]) +
                    (sc[2 * ch + 1][2 * i] + sc[2 * ch + 1][2 * i + 1]);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == ch && ch < n_ch) raw_s[lrow[i] * cps + slot + ch] = v;
        }
    } else {
      for (int ch = 0; ch < n_ch; ++ch)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if ((nt * 8 + 2 * t + e) / c == ch) v += sc[nt][2 * i + e];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == (ch & 3)) raw_s[lrow[i] * cps + slot + ch] = v;
        }
    }
    if (t == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) m_at_s[lrow[i] * tps + tile - tile_lo] = m_run[i];
    __syncthreads();  // every reader of this buffer is done before it is refilled
    buf ^= 1;
  }

  // the split's statistics, and its masses rescaled to the split's final max:
  // each warp writes its own 16 rows
  const size_t stat = ((size_t)sp * n_kv + h) * rows;
  if (t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_fin_s[lrow[i]] = m_run[i];
      const int r = r0 + lrow[i];
      if (r < rows) {
        m_part[stat + r] = m_run[i];
        l_part[stat + r] = l_run[i];
      }
    }
  __syncwarp();
  const int n_cs = min(cps, m - tile_lo * cpt);
  for (int ch = lane; ch < n_cs; ch += 32)
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {  // unguarded loads: no round trip per row
      const int lr = warp * 16 + rr, r = r0 + lr;
      const float v = raw_s[lr * cps + ch] * cs_exp2(m_at_s[lr * tps + ch / cpt] - m_fin_s[lr]);
      if (r < rows) raw[((size_t)h * rows + r) * m + tile_lo * cpt + ch] = v;
    }
}

// The merge: one CTA per (32 rows, kv head). Row r's final max and
// denominator merge its splits in split order; its mass on chunk j (taken at
// the max of j's split) is scaled by 2^(m_split - m_r) / max(l_r, 1e-30)
// (maxes in log2 units); the CTA sums its rows in order per chunk. The last
// CTA to finish sums the CTAs' partials, in the order (kv head, rows), into
// out. Every load of a stage is started before any is used: the first
// chunk's 32 masses and maxes with the statistics of up to 16 splits.
static __global__ void __launch_bounds__(CS_MERGE_NT) chunk_score_merge_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ raw, float* __restrict__ partial, int* __restrict__ counter,
    float* __restrict__ out, int rows, int n_kv, int m, int cps, int n_split) {
  constexpr int R = CS_MERGE_ROWS;
  __shared__ float m_fin[R], inv_l[R], fin[CS_MERGE_NT];
  __shared__ int flag;
  const int tid = threadIdx.x, h = blockIdx.y, part = blockIdx.x;
  const int r0 = part * R, n_rows = min(R, rows - r0);
  const size_t stride = (size_t)n_kv * rows, hrow = (size_t)h * rows + r0;
  // chunk j's masses and split maxes of these rows; the first chunk's are
  // loaded before the statistics, which they do not depend on
  float rw[R], ms[R];
  auto load_chunk = [&](int j) {
    const size_t sp_at = (size_t)(j / cps) * stride + hrow;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int kk = min(k, n_rows - 1);
      rw[k] = raw[(hrow + kk) * m + j];
      ms[k] = m_part[sp_at + kk];
    }
  };
  load_chunk(min(tid, m - 1));
  if (tid < n_rows) {
    constexpr int SB = 16;  // splits per batch of loads (the main path has 13)
    const size_t at = hrow + tid;
    float mm[SB], ll[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const size_t o = min(u, n_split - 1) * stride + at;
      mm[u] = m_part[o];
      ll[u] = l_part[o];
    }
    float mx = CKV_NEG_INF, l = 0.f;
#pragma unroll
    for (int u = 0; u < SB; ++u) mx = fmaxf(mx, mm[u]);  // the max: order-free
    for (int x = SB; x < n_split; ++x) mx = fmaxf(mx, m_part[x * stride + at]);
#pragma unroll
    for (int u = 0; u < SB; ++u) l += u < n_split ? ll[u] * cs_exp2(mm[u] - mx) : 0.f;
    for (int x = SB; x < n_split; ++x)
      l += l_part[x * stride + at] * cs_exp2(m_part[x * stride + at] - mx);
    m_fin[tid] = mx;
    inv_l[tid] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int j = tid; j < m; j += CS_MERGE_NT) {
    if (j != tid) load_chunk(j);
    // no branch between the loads and their uses: a guarded loop lets the
    // compiler sink each load to its use, one round trip per row
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float v = rw[k] * cs_exp2(ms[k] - m_fin[min(k, n_rows - 1)]) *
                      inv_l[min(k, n_rows - 1)];
      acc += k < n_rows ? v : 0.f;
    }
    partial[((size_t)h * gridDim.x + part) * m + j] = acc;
  }
  const int n_parts = n_kv * gridDim.x;
  if (!last_to_arrive(counter, n_parts, &flag)) return;

  // out[j] = the parts' partials summed in part order. tpc threads share a
  // chunk: each sums a contiguous run of parts, then the runs are added in order.
  int tpc = 1;
  while (tpc * 2 <= CS_MERGE_NT / m && tpc < 16) tpc *= 2;
  const int per = (n_parts + tpc - 1) / tpc;
  for (int j0 = 0; j0 < m; j0 += CS_MERGE_NT / tpc) {
    const int j = j0 + tid / tpc, run = tid % tpc;
    float a = 0.f;
    if (j < m) {
      const int x_end = min(n_parts, run * per + per);
      for (int x0 = run * per; x0 < x_end; x0 += 64) {  // the main path: 56 parts
        float pv[64];
#pragma unroll
        for (int u = 0; u < 64; ++u)
          pv[u] = __ldcg(partial + (size_t)min(x0 + u, x_end - 1) * m + j);
#pragma unroll
        for (int u = 0; u < 64; ++u) a += x0 + u < x_end ? pv[u] : 0.f;
      }
    }
    fin[tid] = a;
    __syncthreads();
    if (run == 0 && j < m) {
      float tot = 0.f;
      for (int x = 0; x < tpc; ++x) tot += fin[tid + x];
      out[j] = tot;
    }
    __syncthreads();
  }
}

// The work of one call: rows = n_q / n_kv * s per kv head in n_rt tiles of
// 64; key tiles of bk = 64 / c * c keys (n_tiles of them); as few tiles per
// split (tps) as fill every SM of the current device with cs_ctas_per_sm
// CTAs of d's padded width in one wave, at most CS_CPS_MAX chunks a split;
// and the float32 scratch those splits need.
struct CsLayout {
  int rows, n_rt, m, cpt, n_tiles, tps, n_split, n_mp;
  size_t work_floats;
};

static cudaError_t cs_layout(int s, int n_q, int n_kv, int n, int d, int c, CsLayout* L) {
  if (d > 256 || d < 1 || c < 1 || c > CS_KEYS || s < 1 || n < 1 || n_kv < 1 ||
      n_q % n_kv)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  L->rows = (n_q / n_kv) * s;
  L->n_rt = (L->rows + CS_ROWS - 1) / CS_ROWS;
  L->m = (n + c - 1) / c;
  L->cpt = CS_KEYS / c;
  L->n_tiles = (n + L->cpt * c - 1) / (L->cpt * c);
  const int splits = std::max(1, cs_ctas_per_sm(cs_dp(d)) * sms / (L->n_rt * n_kv));
  L->tps = std::min((L->n_tiles + splits - 1) / splits, std::max(1, CS_CPS_MAX / L->cpt));
  L->n_split = (L->n_tiles + L->tps - 1) / L->tps;
  L->n_mp = (L->rows + CS_MERGE_ROWS - 1) / CS_MERGE_ROWS;  // merge CTAs per kv head
  L->work_floats = 2 * (size_t)L->n_split * n_kv * L->rows + (size_t)n_kv * L->rows * L->m +
                   (size_t)n_kv * L->n_mp * L->m;
  return cudaSuccess;
}

template <typename TQ, int DP, bool FAST>
static cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q, const void* k,
                                float* m_part, float* l_part, float* raw, int s, int n_q,
                                int n_kv, int n, int d, int c, int tps, int cpt) {
  static OncePerDevice smem_opt_in;  // at the most chunks and tiles a split holds
  const cudaError_t attr = smem_opt_in([] {
    return cudaFuncSetAttribute(chunk_score_kernel<TQ, DP, FAST>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)cs_smem(CS_CPS_MAX, CS_CPS_MAX, DP));
  });
  if (attr != cudaSuccess) return attr;
  chunk_score_kernel<TQ, DP, FAST><<<grid, CS_NT, cs_smem(tps * cpt, tps, DP), st>>>(
      (const TQ*)q, (const __half*)k, m_part, l_part, raw, s, n_q, n_kv, n, d, c, tps,
      (float)(std::pow((double)d, -0.5) * 1.4426950408889634));
  return cudaGetLastError();
}

template <typename TQ>
static int launch_chunk_score(const void* q, const void* k, float* out, float* work,
                              long long work_floats, int* counters, int s, int n_q, int n_kv,
                              int n, int d, int c, cudaStream_t st) {
  CsLayout L;
  cudaError_t e = cs_layout(s, n_q, n_kv, n, d, c, &L);
  if (e != cudaSuccess) return (int)e;
  if (work_floats < 0 || (size_t)work_floats < L.work_floats) return (int)cudaErrorInvalidValue;
  const size_t stat = (size_t)L.n_split * n_kv * L.rows;
  float* m_part = work;
  float* l_part = m_part + stat;
  float* raw = l_part + stat;
  float* partial = raw + (size_t)n_kv * L.rows * L.m;
  const dim3 grid(L.n_rt, n_kv, L.n_split);
  auto split = [&](auto fn) {
    return fn(grid, st, q, k, m_part, l_part, raw, s, n_q, n_kv, n, d, c, L.tps, L.cpt);
  };
  if (d > 128)
    e = d == 256 && c == 16 ? split(launch_split<TQ, 256, true>)
                            : split(launch_split<TQ, 256, false>);
  else
    e = d == 128 && c == 16 ? split(launch_split<TQ, 128, true>)
                            : split(launch_split<TQ, 128, false>);
  if (e != cudaSuccess) return (int)e;
  chunk_score_merge_kernel<<<dim3(L.n_mp, n_kv), CS_MERGE_NT, 0, st>>>(
      m_part, l_part, raw, partial, counters, out, L.rows, n_kv, L.m, L.tps * L.cpt, L.n_split);
  return (int)cudaGetLastError();
}

}  // namespace ckv

extern "C" const char* ckv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The float32 scratch one ckv_chunk_score call needs on the current device
// (its split layout is chosen here and nowhere else), or -1 for a shape it
// does not take or a CUDA error.
extern "C" long long ckv_chunk_score_work_floats(int s, int n_q, int n_kv, int n, int d, int c) {
  ckv::CsLayout L;
  if (ckv::cs_layout(s, n_q, n_kv, n, d, c, &L) != cudaSuccess) return -1;
  return (long long)L.work_floats;
}

// q (s, n_q, d) in q_dtype; k (n, n_kv, d) float16; out (ceil(n / c),) float32.
// work: float32 scratch of work_floats >= ckv_chunk_score_work_floats(...)
// (cudaErrorInvalidValue otherwise); counters: one int32, zero before the
// launch and zero again after it. d at most 256; c <= 64.
extern "C" int ckv_chunk_score(const void* q, const void* k, float* out, float* work,
                               long long work_floats, int* counters, int s, int n_q, int n_kv,
                               int n, int d, int c, int q_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (q_dtype) {
    case ckv::F32:
      return ckv::launch_chunk_score<float>(q, k, out, work, work_floats, counters, s, n_q,
                                            n_kv, n, d, c, st);
    case ckv::BF16:
      return ckv::launch_chunk_score<__nv_bfloat16>(q, k, out, work, work_floats, counters, s,
                                                    n_q, n_kv, n, d, c, st);
    case ckv::F16:
      return ckv::launch_chunk_score<__half>(q, k, out, work, work_floats, counters, s, n_q,
                                             n_kv, n, d, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
