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
// * wgmma (bfloat16 / float16, d in {64, 128}: every model the port runs).
//   A CTA of three warpgroups owns 128 query rows of one (request, query
//   head). Warpgroup 2 is the producer: one thread issues TMA loads
//   (cp.async.bulk.tensor, 128-byte swizzle) of the Q tile once and then of
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
//   with zeros. Tried on the H100 and slower (PERF.md): issuing Q K^T (i)
//   with P V (i - 1) so that the softmax runs under a product, with or
//   without named-barrier turns between the warpgroups, and 64-key tiles:
//   ptxas kept every build to the launch bound's 168 registers per thread,
//   though setmaxnreg grants the consumers 240 at run time, and spilled
//   the orders that hold two tiles' scores.
// * mma_sync (bfloat16 / float16, d in {16, 32, 256}: the tests' small
//   heads, which the 128-byte swizzled tiles do not take, and gemma3-4b's
//   256; the first tensor-core version): one CTA of 4 warps per 64 query
//   rows; mma.sync m16n8k16 fed by ldmatrix from padded tiles, K and V by
//   cp.async, one 64-key tile per step. At d = 256 a thread's output
//   fragment is 128 floats, so Q's fragments are read again from shared
//   memory per key tile instead of living in registers (64 more), and the
//   three tiles take 99 KB. The wgmma kernel's 128-key tiles at d = 256
//   would hold 128 output floats and 64 scores a thread under the 168
//   registers its launch bound leaves, and fit one stage in shared memory.
//   P is rounded to the input dtype as the A operand of P V in both
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
#include <cstdint>
#include <type_traits>

#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

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
  // Q's A fragments: in registers for the whole CTA up to d = 128; past it
  // read from the Q tile (which nothing overwrites) at each use
  constexpr bool Q_REG = HD <= 128;
  const T* q_frag = qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
  uint32_t qf[Q_REG ? KT : 1][4];
  if constexpr (Q_REG)
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
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t q_tmp[4];
      const uint32_t* qa = q_tmp;
      if constexpr (Q_REG)
        qa = qf[kk];
      else
        ldsm_x4(q_tmp, q_frag + kk * 16);
#pragma unroll
      for (int j2 = 0; j2 < NT8 / 2; ++j2) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (j2 * 16 + (lane % 8) + 8 * (lane / 16)) * LD + kk * 16 +
                        8 * ((lane / 8) % 2));
        mma16816<T>(sc[2 * j2], qa, bf[0], bf[1]);
        mma16816<T>(sc[2 * j2 + 1], qa, bf[2], bf[3]);
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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// returns once the phase of parity `parity` has completed; a pipeline that
// never completes it traps after ~8 s of clocks instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// TMA: the box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Coordinates of (column, position, head, batch) in a tensor map whose outer
// dims are (position, head, batch) when pos_inner, else (head, position,
// batch): the host orders them by stride.
struct MapCoord {
  int pos_inner;
  __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int col, int pos, int head, int batch) const {
    if (pos_inner)
      tma_load_4d(dst, map, bar, col, pos, head, batch);
    else
      tma_load_4d(dst, map, bar, col, head, pos, batch);
  }
};

template <typename T, int HD>
static __global__ void __launch_bounds__(WG_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int n_q, int n_kv, int s_q,
    int s_k, int causal, int window, int q_offset, float scale_log2, MapCoord cq, MapCoord ckv,
    long long o_sb, long long o_sh, long long o_ss) {
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
    }
  }
}

// cuTensorMapEncodeTiled, found at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                             &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A 4-d map over the (d, position, head, batch) view of a strided tensor,
// outer dims ordered by stride, boxes of 64
// columns x `rows` positions with the 128-byte swizzle; rows past s_len
// read as zeros.
static bool encode_map(CUtensorMap* map, const void* ptr, bool bf16, int d, int s_len, int heads,
                       int batch, long long ss, long long sh, long long sb, int rows,
                       MapCoord* coord) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const bool pos_inner = ss <= sh;
  coord->pos_inner = pos_inner;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(pos_inner ? s_len : heads),
                              (cuuint64_t)(pos_inner ? heads : s_len), (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(2 * (pos_inner ? ss : sh)),
                                 (cuuint64_t)(2 * (pos_inner ? sh : ss)), (cuuint64_t)(2 * sb)};
  const cuuint32_t box[4] = {64, (cuuint32_t)(pos_inner ? rows : 1),
                             (cuuint32_t)(pos_inner ? 1 : rows), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
static int launch_flash_wgmma(const void* q, const void* k, const void* v, void* out, int b,
                              int n_q, int n_kv, int s_q, int s_k, int causal, int window,
                              int q_offset, const long long* st, cudaStream_t stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  MapCoord cq, ck, cv;
  // a batch of one never steps the batch coordinate: any aligned stride will do
  const long long q_sb = b > 1 ? st[0] : st[2] * s_q + st[1] * n_q;
  const long long k_sb = b > 1 ? st[3] : st[5] * s_k + st[4] * n_kv;
  const long long v_sb = b > 1 ? st[6] : st[8] * s_k + st[7] * n_kv;
  if (!encode_map(&tq, q, BF, HD, s_q, n_q, b, st[2], st[1], q_sb, 64, &cq) ||
      !encode_map(&tk, k, BF, HD, s_k, n_kv, b, st[5], st[4], k_sb, WG_BN, &ck) ||
      !encode_map(&tv, v, BF, HD, s_k, n_kv, b, st[8], st[7], v_sb, WG_BN, &cv) ||
      ck.pos_inner != cv.pos_inner)
    return (int)cudaErrorInvalidValue;
  const int smem = WgCfg<HD>::SMEM;
  cudaFuncSetAttribute(flash_wgmma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid((s_q + WG_BM - 1) / WG_BM, n_q, b);
  flash_wgmma_kernel<T, HD><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, (T*)out, n_q, n_kv, s_q, s_k, causal, window, q_offset,
      softmax_scale(HD) * LOG2E, cq, ck, st[9], st[10], st[11]);
  return 0;
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
                           int q_offset, int variant, const long long* st, cudaStream_t stream) {
  if (variant == 2) {  // wgmma
    if (d == 64)
      return launch_flash_wgmma<T, 64>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                       q_offset, st, stream);
    if (d == 128)
      return launch_flash_wgmma<T, 128>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window,
                                        q_offset, st, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 1) return (int)cudaErrorInvalidValue;
  switch (d) {  // mma_sync
    case 16:
      launch_flash_tc<T, 16>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset, st,
                             stream);
      break;
    case 32:
      launch_flash_tc<T, 32>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset, st,
                             stream);
      break;
    case 256:
      launch_flash_tc<T, 256>(q, k, v, out, b, n_q, n_kv, s_q, s_k, causal, window, q_offset,
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
// aligned. variant: 0 the float32 CUDA-core kernel (float32, d any multiple
// of 4 up to 256), 1 mma_sync (bfloat16/float16, d in {16, 32, 256}), 2 wgmma
// (bfloat16/float16, d in {64, 128}).
extern "C" int ckv_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                   int n_q, int n_kv, int s_q, int s_k, int d, int causal,
                                   int window, int q_offset, long long q_sb, long long q_sh,
                                   long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, int dtype,
                                   int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  int rc = 0;
  switch (dtype) {
    case ckv::F32: {
      if (variant != 0 || d % 4 || d > 256) return (int)cudaErrorInvalidValue;
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
                                               window, q_offset, variant, strides, st);
      break;
    case ckv::F16:
      rc = ckv::launch_flash_16<__half>(q, k, v, out, b, n_q, n_kv, s_q, s_k, d, causal, window,
                                        q_offset, variant, strides, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
