// flash_attention: causal (optionally sliding-window) GQA attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (_flash_kernel): query i at position q_offset + i attends
// to key t if t <= q_offset + i (causal) and q_offset + i - t < window
// (window > 0), by a tiled online softmax with float32 scores, running
// max/sum and accumulator; the output is rounded once to q's dtype. Any
// s_q, s_k (the TPU kernel asserted whole blocks) and any group n_q / n_kv
// (hymba's is 5). Key tiles that the causal mask or the window removes
// entirely are skipped, and the CTAs with the longest rows start first.
// Tensors come with (batch, head, position) strides and a contiguous head
// dim, so the model's (b, s, n, d) projections are read in place, and the
// output is written with the strides the caller gives.
//
// Three kernels; the wrapper (kernels/flash_attention/ops.py) picks one by
// dtype and head dim:
//
// * wgmma (bfloat16 / float16, d in {64, 128, 256}: every model the port
//   runs). At d 64 / 128 a CTA of three warpgroups owns 128 query rows of one
//   (request, query head). Warpgroup 2 is the producer: one thread issues TMA
//   loads (cp.async.bulk.tensor, 128-byte swizzle) of the Q tile once and then of
//   128-key K and V tiles into a ring of shared-memory stages (3 for d = 64,
//   2 for d = 128), each guarded by mbarriers: "full" (one per K and one
//   per V tile, completed by the copy's byte count) and "empty" (released by
//   the 256 consumer threads). setmaxnreg hands the producer's registers to
//   the consumers. Warpgroups 0 and 1 each own 64 query rows; per key tile
//   they run Q K^T as wgmma m64n128k16 with both operands read from shared
//   memory through descriptors, the online softmax on the accumulator
//   registers (the mask only on a tile that crosses the causal, window or
//   sequence edge; the scale folded into one fma before each ex2), then
//   P V as wgmma m64n64k16 per 64 columns of d, with P (rounded to the
//   input dtype) taken straight from the score registers as the A operand
//   and V read MN-major (the transpose bit). While a tile is multiplied the
//   next K and V tiles are in flight. The tensor maps are encoded on the
//   host per launch (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint so the library needs no -lcuda) over the
//   strided (d, position, head, batch) view; the copy fills rows past s
//   with zeros. Given an lse pointer (training: FlashAttentionFn), the
//   epilogue also writes each row's logsumexp, m + log2 l in the log2 units
//   of its scores, for the backward (flash_attention_bwd.cu); serving
//   passes none, and the output is the same bits either way. The TMA and
//   mbarrier helpers live in hopper.cuh, shared with the backward. Tried
//   on the H100 and slower (PERF.md): issuing Q K^T (i)
//   with P V (i - 1) so that the softmax runs under a product, with or
//   without named-barrier turns between the warpgroups, and 64-key tiles:
//   ptxas kept every build to the launch bound's 168 registers per thread,
//   though setmaxnreg grants the consumers 240 at run time, and spilled
//   the orders that hold two tiles' scores.
//   At d = 256 (gemma3-4b) a warpgroup's 64 x 256 output is 128 floats a
//   thread, which beside a 128-key tile's 64 scores would not fit those 168
//   registers: the d-256 instance has two warpgroups and no producer (256
//   threads, up to 255 registers a thread; it uses 205, no spill), and
//   64-key tiles (32 scores a thread) in two stages beside Q: 64 KB of Q and
//   2 x 64 KB of K and V, one CTA an SM. Thread 0 issues the copies: it
//   refills the stage of tile i - 1 while its own Q K^T (i) is in flight,
//   so neither warpgroup waits at the end of a tile for the other (a refill
//   at the end of each tile made it 10 % slower). Q K^T runs as 16
//   m64n64k16 products over d and P V as four m64n64k16 per 16 keys; its
//   grid puts the head fastest, so the CTAs with the longest rows start
//   first for every head at once. A masked score is tested before it is
//   scaled: scale_log2 is 0.090 at d = 256, so -1e30 scaled lies above
//   CKV_MASKED's -1e29.
// * mma_sync (bfloat16 / float16, d in {16, 32}: the tests' small heads,
//   which the 128-byte swizzled tiles do not take; the first tensor-core
//   version): one CTA of 4 warps per 64 query rows; mma.sync m16n8k16 fed
//   by ldmatrix from padded tiles, K and V by cp.async, one 64-key tile per
//   step. P is rounded to the input dtype as the A operand of P V in both
//   tensor-core kernels (the TPU kernel kept P in float32: the output
//   differs from a float32 P by about one ulp of the output dtype).
// * float32: the same work on the CUDA cores in float32 (64 x 64 tiles,
//   4 x 4 scores per thread, common.cuh), so a float32 model keeps float32
//   scores and products; d up to 128, or 256 in an instance that holds
//   twice the output columns a thread (217 KB of shared memory).
//
// Bound on the H100 at the hybrid prefill (25 query heads over 5 kv heads,
// s = 4160, d = 64, bfloat16): 4 x 25 x 64 x 4160 x 4161 / 2 = 5.5e10
// operations of products, ~0.056 ms at 989 TFLOP/s; one exp2 per visible
// score, 2.2e8, ~0.052 ms at the special-function units' 16 per clock per
// SM (132 SMs at 1.98 GHz); ~9.6 MB of Q, K, V and output, ~0.003 ms. So
// the products and the exponentials bound it about equally. The mma_sync
// kernel took 0.48 ms there: one pipeline stage whose every key tile
// waited out a full load after a barrier, pre-Hopper products, and
// 64-key steps; the wgmma kernel removes all three (0.19 ms). What holds it
// back now: a warpgroup's softmax and its products take turns instead of
// overlapping, and each K/V tile is read once per query head of its group
// (5 for hymba), from L2.
//
// At gemma3-4b's shape (8 query heads over 4, s 4096, d 256, causal) the
// products are 4 x 8 x 256 x 4096 x 4097 / 2 = 6.9e10 operations, 0.0695
// ms at 989 TFLOP/s (0.030 ms with window 1024); the exponentials (0.016
// ms) and the bytes (0.015 ms) bound it less. The d-256 instance runs at about
// twice that bound (PERF.md). What holds it back: a warpgroup's softmax
// and its products still take turns (issuing Q K^T (i + 1) before P V (i),
// so that the softmax runs under a product, had ptxas serialize every
// product, C7514, and ran 1.65x slower); Q K^T reads both operands from
// shared memory, 4 KB per m64n64k16, which is the SM's 128 bytes a clock at
// the tensor cores' full rate; and the diagonal tiles of the causal mask
// compute their masked half.
#include <cstdint>
#include <type_traits>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace ckv {

constexpr int FA_BM = 64;  // query rows per CTA (16 per warp)
constexpr int FA_BN = 64;  // keys per tile

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

  tile_async<T, HD, FA_BM>(qs, qb, q_ss, m0, s_q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q's A fragments, in registers for the whole CTA
  const T* q_frag = qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);

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
    tile_async<T, HD, FA_BM>(ks, kb, k_ss, n0, s_k);
    cp_async_commit();
    tile_async<T, HD, FA_BM>(vs, vb, v_ss, n0, s_k);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    float sc[NT8][4];
#pragma unroll
    for (int j = 0; j < NT8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NT8 / 2; ++j2) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (j2 * 16 + (lane % 8) + 8 * (lane / 16)) * LD + kk * 16 +
                        8 * ((lane / 8) % 2));
        mma16816<T>(sc[2 * j2], qf[kk], bf[0], bf[1]);
        mma16816<T>(sc[2 * j2 + 1], qf[kk], bf[2], bf[3]);
      }
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
// 4-row x 4 OC-column block of the output per thread (d <= 64 OC).
template <int OC>
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
  float4 o[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ok[i] = m0 + ty + 16 * i < s_q;
    pos[i] = q_offset + m0 + ty + 16 * i;
    m_run[i] = CKV_NEG_INF, l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
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
      for (int c = 0; c < OC; ++c) {
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
      for (int c = 0; c < OC; ++c) {
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
    for (int c = 0; c < OC; ++c) {
      int x = tx * 4 + 64 * c;
      if (x < d)
        *reinterpret_cast<float4*>(orow + x) =
            make_float4(o[i][c].x * inv, o[i][c].y * inv, o[i][c].z * inv, o[i][c].w * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel (d in {64, 128})

constexpr int WG_BM = 128;  // query rows per CTA: two consumer warpgroups of 64
// two consumer warpgroups, then the producer warpgroup (one thread of it
// issues the copies; setmaxnreg hands its registers to the consumers)
constexpr int WG_THREADS = 384;
constexpr int WG_BN = 128;  // keys per tile

template <int HD>
struct WgCfg {
  static constexpr int STAGES = HD == 64 ? 3 : 2;  // what shared memory holds
  static constexpr int SUB = HD / 64;  // 128-byte column blocks of a row
  static constexpr int Q_BLOCK = 64 * 128;      // bytes of 64 rows x 64 columns
  static constexpr int KV_BLOCK = WG_BN * 128;  // bytes of 128 rows x 64 columns
  static constexpr int Q_BYTES = 2 * SUB * Q_BLOCK;
  static constexpr int KV_BYTES = SUB * KV_BLOCK;  // one K (or V) tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);  // + alignment slack
};

// LSE: the instance that also writes each row's logsumexp (training); the
// serving instance compiles without that store, which the 168-register
// kernel otherwise pays for in its main loop's code (PERF.md)
template <typename T, int HD, bool LSE>
static __global__ void __launch_bounds__(WG_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int n_q, int n_kv, int s_q,
    int s_k, int causal, int window, int q_offset, float scale_log2, MapCoord cq, MapCoord ckv,
    long long o_sb, long long o_sh, long long o_ss, float* __restrict__ lse, int lse_row) {
  using C = WgCfg<HD>;
  constexpr int BN = WG_BN, STAGES = C::STAGES, SUB = C::SUB;
  extern __shared__ unsigned char wg_smem[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 1024 bytes
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::Q_BYTES, v_s = k_s + STAGES * C::KV_BYTES;
  const uint32_t bar_q = base + C::BAR_OFF;
  auto bar_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bar_q + 8u * (1 + STAGES + st); };
  auto bar_e = [&](int st) { return bar_q + 8u * (1 + 2 * STAGES + st); };

  const int n_mb = (s_q + WG_BM - 1) / WG_BM;
  const int m0 = (n_mb - 1 - blockIdx.x) * WG_BM;  // the longest rows first
  const int qh = blockIdx.y, b = blockIdx.z, kh = qh / (n_q / n_kv);
  // the keys any row of this CTA may see, in whole tiles
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + WG_BM, s_q) - 1;
  const int k_end = causal ? min(s_k, p_hi + 1) : s_k;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_begin = k_begin / BN;
  const int n_tiles = max(0, (k_end + BN - 1) / BN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_e(st), 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < SUB; ++c)
          cq.load(q_s + (w * SUB + c) * C::Q_BLOCK, &tm_q, bar_q, c * 64, m0 + 64 * w, qh, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, n0 = (t_begin + i) * BN;
        if (i >= STAGES) mbar_wait(bar_e(st), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(bar_k(st), C::KV_BYTES);
        for (int c = 0; c < SUB; ++c)
          ckv.load(k_s + st * C::KV_BYTES + c * C::KV_BLOCK, &tm_k, bar_k(st), c * 64, n0, kh, b);
        mbar_expect_tx(bar_v(st), C::KV_BYTES);
        for (int c = 0; c < SUB; ++c)
          ckv.load(v_s + st * C::KV_BYTES + c * C::KV_BLOCK, &tm_v, bar_v(st), c * 64, n0, kh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    constexpr int NS = BN / 2;  // score registers per thread
    constexpr int NO = 32;      // output registers per thread per 64 columns
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = m0 + 64 * wg;  // this warpgroup's first row
    const int row = r0 + warp * 16 + g;  // this thread's rows: row and row + 8
    const bool ok[2] = {row < s_q, row + 8 < s_q};
    const int pos[2] = {q_offset + row, q_offset + row + 8};
    // the warpgroup's positions, for the test of a tile that needs no mask
    const int w_lo = q_offset + r0, w_hi = q_offset + min(r0 + 63, s_q - 1);

    float o[SUB][NO];
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int i = 0; i < NO; ++i) o[c][i] = 0.f;
    // m_run in log2 units (scaled scores), l_run the rows' sums
    float m_run[2] = {CKV_NEG_INF, CKV_NEG_INF}, l_run[2] = {0.f, 0.f};
    const uint32_t q_w = q_s + wg * SUB * C::Q_BLOCK;
    mbar_wait(bar_q, 0);

    // per key tile: Q K^T, the online softmax, then P V; the next tiles'
    // copies are in flight meanwhile
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, n0 = (t_begin + i) * BN;
      const uint32_t par = (i / STAGES) & 1;
      const uint32_t k_t = k_s + st * C::KV_BYTES, v_t = v_s + st * C::KV_BYTES;
      float sc[NS];
      mbar_wait(bar_k(st), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // 16 columns (32 bytes) at a time inside a 128-byte swizzled row
        const uint32_t off = (kk % 4) * 32u;
        Wgmma<BN, T>::ss(sc, sw128_desc(q_w + (kk / 4) * C::Q_BLOCK + off, 16, 1024),
                         sw128_desc(k_t + (kk / 4) * C::KV_BLOCK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask only a tile that crosses an edge; scores stay unscaled here
      const bool whole = n0 + BN <= s_k && (!causal || n0 + BN - 1 <= w_lo) &&
                         (window <= 0 || w_hi - n0 < window);
      if (!whole) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int r = (j >> 1) & 1, t = n0 + (j / 4) * 8 + 2 * t4 + (j & 1);
          const bool vis = ok[r] && t < s_k && (!causal || t <= pos[r]) &&
                           (window <= 0 || pos[r] - t < window);
          if (!vis) sc[j] = CKV_NEG_INF;
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = CKV_NEG_INF;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * scale_log2);
        alpha[r] = fast_exp2(m_run[r] - m_new);
        // a row with no visible key yet subtracts 0: its masked scores,
        // -1e30 scaled, still give 0
        const float m_use = CKV_MASKED(m_new) ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            float& x = sc[4 * j + e];
            x = fast_exp2(fmaf(x, scale_log2, -m_use));
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = m_new;
      }
#pragma unroll
      for (int c = 0; c < SUB; ++c)
#pragma unroll
        for (int i2 = 0; i2 < NO; ++i2) o[c][i2] *= alpha[(i2 >> 1) & 1];
      // P in the A-operand layout: score tiles 2 kk and 2 kk + 1 hold keys
      // [16 kk, 16 kk + 16)
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      mbar_wait(bar_v(st), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < SUB; ++c)
          // keys [16 kk, 16 kk + 16) are two 1024-byte groups of 8 rows; one
          // 64-column block per product, so the leading offset is unused
          Wgmma<64, T>::rs(o[c], pa[kk], sw128_desc(v_t + c * C::KV_BLOCK + kk * 2048, 1024, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < SUB; ++c) fence_regs(o[c]);
      mbar_arrive(bar_e(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!ok[r]) continue;
      const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
      T* orow = out + b * o_sb + qh * o_sh + (long long)(row + 8 * r) * o_ss;
#pragma unroll
      for (int c = 0; c < SUB; ++c)
#pragma unroll
        for (int j = 0; j < NO / 4; ++j)
          *reinterpret_cast<uint32_t*>(orow + c * 64 + j * 8 + 2 * t4) =
              pack2<T>(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
      // the row's logsumexp for the backward, log2 units of the scaled
      // scores: P = exp2(scale_log2 s - lse); 0 for a row that sees no key
      if constexpr (LSE)
        if (t4 == 0)
          lse[((long long)b * n_q + qh) * lse_row + row + 8 * r] =
              l_run[r] > 0.f ? m_run[r] + log2f(l_run[r]) : 0.f;
    }
  }
}

template <typename T, int HD>
static int launch_flash_wgmma(const void* q, const void* k, const void* v, void* out, int b,
                              int n_q, int n_kv, int s_q, int s_k, int causal, int window,
                              int q_offset, const long long* st, float* lse, int lse_row,
                              cudaStream_t stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  MapCoord cq, ck, cv;
  if (!encode_map(&tq, q, BF, HD, s_q, n_q, b, st[2], st[1], st[0], 64, &cq) ||
      !encode_map(&tk, k, BF, HD, s_k, n_kv, b, st[5], st[4], st[3], WG_BN, &ck) ||
      !encode_map(&tv, v, BF, HD, s_k, n_kv, b, st[8], st[7], st[6], WG_BN, &cv) ||
      ck.pos_inner != cv.pos_inner)
    return (int)cudaErrorInvalidValue;
  const int smem = WgCfg<HD>::SMEM;
  auto kernel = lse ? flash_wgmma_kernel<T, HD, true> : flash_wgmma_kernel<T, HD, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((s_q + WG_BM - 1) / WG_BM, n_q, b);
  kernel<<<grid, WG_THREADS, smem, stream>>>(tq, tk, tv, (T*)out, n_q, n_kv, s_q, s_k, causal,
                                             window, q_offset, softmax_scale(HD) * LOG2E, cq, ck,
                                             st[9], st[10], st[11], lse, lse_row);
  return 0;
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel at d = 256

constexpr int W2_BM = 128;       // query rows per CTA: two warpgroups of 64
constexpr int W2_THREADS = 256;  // two warpgroups; thread 0 also issues the copies
constexpr int W2_BN = 64;        // keys per tile
constexpr int W2_STAGES = 2;     // what shared memory holds beside Q
constexpr int W2_SUB = 4;        // 128-byte column blocks of a 256-wide row
constexpr int W2_BLOCK = 64 * 128;                 // bytes of 64 rows x 64 columns
constexpr int W2_Q_BYTES = 2 * W2_SUB * W2_BLOCK;  // both warpgroups' Q, 64 KB
constexpr int W2_KV_BYTES = W2_SUB * W2_BLOCK;     // one K (or V) tile, 32 KB
constexpr int W2_BAR = W2_Q_BYTES + 2 * W2_STAGES * W2_KV_BYTES;
constexpr int W2_SMEM = 1024 + W2_BAR + 8 * (1 + 3 * W2_STAGES);  // + alignment slack

// The d 64 / 128 kernel's work at d = 256: a warpgroup's 64 x 256 output
// is 128 floats a thread, so the key tiles hold 64 keys (32 scores a thread
// beside it), and no producer warpgroup caps the registers at 168 (the
// header): thread 0 issues the copies, refilling the stage of tile i - 1
// once both warpgroups have released it, while its own Q K^T (i) runs. The
// query tile varies slowest across the grid, so the CTAs with the longest
// rows start first for every head at once.
template <typename T, bool LSE>
static __global__ void __launch_bounds__(W2_THREADS, 1) flash_wgmma256_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int n_q, int n_kv, int s_q,
    int s_k, int causal, int window, int q_offset, float scale_log2, MapCoord cq, MapCoord ckv,
    long long o_sb, long long o_sh, long long o_ss, float* __restrict__ lse, int lse_row) {
  constexpr int BN = W2_BN, STAGES = W2_STAGES, SUB = W2_SUB, BLOCK = W2_BLOCK;
  extern __shared__ unsigned char wg_smem[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 1024 bytes
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + W2_Q_BYTES, v_s = k_s + STAGES * W2_KV_BYTES;
  const uint32_t bar_q = base + W2_BAR;
  auto bar_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bar_q + 8u * (1 + STAGES + st); };
  auto bar_e = [&](int st) { return bar_q + 8u * (1 + 2 * STAGES + st); };

  const int n_mb = (s_q + W2_BM - 1) / W2_BM;
  const int m0 = (n_mb - 1 - blockIdx.y) * W2_BM;  // the longest rows first
  const int qh = blockIdx.x, b = blockIdx.z, kh = qh / (n_q / n_kv);
  // the keys any row of this CTA may see, in whole tiles
  const int p_lo = q_offset + m0, p_hi = q_offset + min(m0 + W2_BM, s_q) - 1;
  const int k_end = causal ? min(s_k, p_hi + 1) : s_k;
  const int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int t_begin = k_begin / BN;
  const int n_tiles = max(0, (k_end + BN - 1) / BN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_e(st), W2_THREADS);  // every thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile i's K and V into stage i % STAGES, each on its own "full" barrier
  auto issue = [&](int i) {
    const int st = i % STAGES, n0 = (t_begin + i) * BN;
    mbar_expect_tx(bar_k(st), W2_KV_BYTES);
    for (int c = 0; c < SUB; ++c)
      ckv.load(k_s + st * W2_KV_BYTES + c * BLOCK, &tm_k, bar_k(st), c * 64, n0, kh, b);
    mbar_expect_tx(bar_v(st), W2_KV_BYTES);
    for (int c = 0; c < SUB; ++c)
      ckv.load(v_s + st * W2_KV_BYTES + c * BLOCK, &tm_v, bar_v(st), c * 64, n0, kh, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, W2_Q_BYTES);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < SUB; ++c)
        cq.load(q_s + (w * SUB + c) * BLOCK, &tm_q, bar_q, c * 64, m0 + 64 * w, qh, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) issue(i);
  }

  constexpr int NS = BN / 2;  // score registers per thread
  constexpr int NO = 32;      // output registers per thread per 64 columns
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = m0 + 64 * wg;         // this warpgroup's first row
  const int row = r0 + warp * 16 + g;  // this thread's rows: row and row + 8
  const bool ok[2] = {row < s_q, row + 8 < s_q};
  const int pos[2] = {q_offset + row, q_offset + row + 8};
  // the warpgroup's positions, for the test of a tile that needs no mask
  const int w_lo = q_offset + r0, w_hi = q_offset + min(r0 + 63, s_q - 1);

  float o[SUB][NO];
#pragma unroll
  for (int c = 0; c < SUB; ++c)
#pragma unroll
    for (int i = 0; i < NO; ++i) o[c][i] = 0.f;
  // m_run in log2 units (scaled scores), l_run the rows' sums
  float m_run[2] = {CKV_NEG_INF, CKV_NEG_INF}, l_run[2] = {0.f, 0.f};
  const uint32_t q_w = q_s + wg * SUB * BLOCK;
  mbar_wait(bar_q, 0);

  // per key tile: Q K^T, the online softmax, then P V; the next tile's
  // copies are in flight meanwhile
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES, n0 = (t_begin + i) * BN;
    const uint32_t par = (i / STAGES) & 1;
    const uint32_t k_t = k_s + st * W2_KV_BYTES, v_t = v_s + st * W2_KV_BYTES;
    float sc[NS];
    mbar_wait(bar_k(st), par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      // 16 columns (32 bytes) at a time inside a 128-byte swizzled row
      const uint32_t off = (kk % 4) * 32u;
      Wgmma<BN, T>::ss(sc, sw128_desc(q_w + (kk / 4) * BLOCK + off, 16, 1024),
                       sw128_desc(k_t + (kk / 4) * BLOCK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    // thread 0 refills the stage of tile i - 1 while Q K^T (i) runs, once
    // both warpgroups have released it
    if (threadIdx.x == 0 && i >= 1 && i - 1 + STAGES < n_tiles) {
      mbar_wait(bar_e((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      issue(i - 1 + STAGES);
    }
    wgmma_wait<0>();
    fence_regs(sc);

    // mask only a tile that crosses an edge; scores stay unscaled here
    const bool whole = n0 + BN <= s_k && (!causal || n0 + BN - 1 <= w_lo) &&
                       (window <= 0 || w_hi - n0 < window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = (j >> 1) & 1, t = n0 + (j / 4) * 8 + 2 * t4 + (j & 1);
        const bool vis = ok[r] && t < s_k && (!causal || t <= pos[r]) &&
                         (window <= 0 || pos[r] - t < window);
        if (!vis) sc[j] = CKV_NEG_INF;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = CKV_NEG_INF;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // masked is tested before the scale: at d = 256, -1e30 scaled by
      // scale_log2 (0.090) lies above CKV_MASKED's -1e29, so a tile that
      // hides every key of the row keeps the row's max
      const float m_new = CKV_MASKED(mx) ? m_run[r] : fmaxf(m_run[r], mx * scale_log2);
      alpha[r] = fast_exp2(m_run[r] - m_new);
      // a row with no visible key yet subtracts 0: its masked scores,
      // -1e30 scaled, still give 0
      const float m_use = CKV_MASKED(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float& x = sc[4 * j + e];
          x = fast_exp2(fmaf(x, scale_log2, -m_use));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int i2 = 0; i2 < NO; ++i2) o[c][i2] *= alpha[(i2 >> 1) & 1];
    // P in the A-operand layout: score tiles 2 kk and 2 kk + 1 hold keys
    // [16 kk, 16 kk + 16)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack2<T>(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    mbar_wait(bar_v(st), par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < SUB; ++c)
        // keys [16 kk, 16 kk + 16) are two 1024-byte groups of 8 rows; one
        // 64-column block per product, so the leading offset is unused
        Wgmma<64, T>::rs(o[c], pa[kk], sw128_desc(v_t + c * BLOCK + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < SUB; ++c) fence_regs(o[c]);
    mbar_arrive(bar_e(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    T* orow = out + b * o_sb + qh * o_sh + (long long)(row + 8 * r) * o_ss;
#pragma unroll
    for (int c = 0; c < SUB; ++c)
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<uint32_t*>(orow + c * 64 + j * 8 + 2 * t4) =
            pack2<T>(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
    // the row's logsumexp for the backward, log2 units of the scaled
    // scores: P = exp2(scale_log2 s - lse); 0 for a row that sees no key
    if constexpr (LSE)
      if (t4 == 0)
        lse[((long long)b * n_q + qh) * lse_row + row + 8 * r] =
            l_run[r] > 0.f ? m_run[r] + log2f(l_run[r]) : 0.f;
  }
}

template <typename T>
static int launch_flash_wgmma256(const void* q, const void* k, const void* v, void* out, int b,
                                 int n_q, int n_kv, int s_q, int s_k, int causal, int window,
                                 int q_offset, const long long* st, float* lse, int lse_row,
                                 cudaStream_t stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  MapCoord cq, ck, cv;
  if (!encode_map(&tq, q, BF, 256, s_q, n_q, b, st[2], st[1], st[0], 64, &cq) ||
      !encode_map(&tk, k, BF, 256, s_k, n_kv, b, st[5], st[4], st[3], W2_BN, &ck) ||
      !encode_map(&tv, v, BF, 256, s_k, n_kv, b, st[8], st[7], st[6], W2_BN, &cv) ||
      ck.pos_inner != cv.pos_inner)
    return (int)cudaErrorInvalidValue;
  auto kernel = lse ? flash_wgmma256_kernel<T, true> : flash_wgmma256_kernel<T, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W2_SMEM);
  dim3 grid(n_q, (s_q + W2_BM - 1) / W2_BM, b);
  kernel<<<grid, W2_THREADS, W2_SMEM, stream>>>(tq, tk, tv, (T*)out, n_q, n_kv, s_q, s_k, causal,
                                                window, q_offset, softmax_scale(256) * LOG2E, cq,
                                                ck, st[9], st[10], st[11], lse, lse_row);
  return 0;
}

template <typename T, int HD>
static int launch_flash_tc(const void* q, const void* k, const void* v, void* out, int b,
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
  return 0;
}

template <typename T>
static int launch_flash_16(const void* q, const void* k, const void* v, void* out, int b,
                           int n_q, int n_kv, int s_q, int s_k, int d, int causal, int window,
                           int q_offset, int variant, const long long* st, float* lse,
                           int lse_row, cudaStream_t stream) {
  if (variant == 2) {  // wgmma
    if (d == 64)
      return launch_flash_wgmma<T, 64>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                       q_offset, st, lse, lse_row, stream);
    if (d == 128)
      return launch_flash_wgmma<T, 128>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                        q_offset, st, lse, lse_row, stream);
    if (d == 256)
      return launch_flash_wgmma256<T>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                      q_offset, st, lse, lse_row, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 1 || lse) return (int)cudaErrorInvalidValue;
  switch (d) {  // mma_sync
    case 16:
      return launch_flash_tc<T, 16>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                    q_offset, st, stream);
    case 32:
      return launch_flash_tc<T, 32>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                    q_offset, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ckv

// q/out (b, n_q, s_q, d), k/v (b, n_kv, s_k, d) in dtype, each with element
// strides (batch, head, position) and a contiguous head dim; rows 16-byte
// aligned. variant: 0 the float32 CUDA-core kernel (float32, d any multiple
// of 4 up to 256), 1 mma_sync (bfloat16/float16, d in {16, 32}), 2 wgmma
// (bfloat16/float16, d in {64, 128, 256}). lse: null, or (wgmma) float32
// (b, n_q, s_q) with rows lse_row >= s_q floats apart,
// which the kernel fills with each query row's logsumexp in log2 units
// (the epilogue's) for the backward; the output is the same either way.
extern "C" int ckv_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                   int n_q, int n_kv, int s_q, int s_k, int d, int causal,
                                   int window, int q_offset, long long q_sb, long long q_sh,
                                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, void* lse,
                                   int lse_row, int dtype, int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  int rc = 0;
  switch (dtype) {
    case ckv::F32: {
      if (variant != 0 || lse || d % 4 || d > 256) return (int)cudaErrorInvalidValue;
      const int ld = ckv::tile_ld(d);
      const size_t smem = sizeof(float) * (3 * ckv::TR * ld + ckv::TR * (ckv::TK + 4));
      auto kernel = d > 128 ? ckv::flash_f32_kernel<4> : ckv::flash_f32_kernel<2>;
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      dim3 grid((s_q + ckv::TR - 1) / ckv::TR, n_q, b);
      kernel<<<grid, ckv::NT, smem, st>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)out, n_q, n_kv, s_q, s_k, d,
          causal, window, q_offset, ckv::softmax_scale(d), q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
          v_sb, v_sh, v_ss, o_sb, o_sh, o_ss);
      break;
    }
    case ckv::BF16:
      rc = ckv::launch_flash_16<__nv_bfloat16>(q, k, v, out, b, n_q, n_kv, s_q, s_k, d, causal,
                                               window, q_offset, variant, strides, (float*)lse,
                                               lse_row, st);
      break;
    case ckv::F16:
      rc = ckv::launch_flash_16<__half>(q, k, v, out, b, n_q, n_kv, s_q, s_k, d, causal, window,
                                        q_offset, variant, strides, (float*)lse, lse_row, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
