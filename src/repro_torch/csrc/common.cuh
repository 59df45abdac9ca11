// Shared device helpers for the port's attention kernels.
//
// Dtype codes (must match repro_torch/kernels/build.py DTYPE_CODES):
//   0 float32, 1 bfloat16, 2 float16.
//
// flash_attention's float32 kernel computes on the CUDA cores with the tile
// helpers below: a 64-row x 64-key tile per step, 256 threads, each thread
// holding a 4 x 4 block of scores in registers: rows ty + 16 i and keys
// tx + 16 j (ty = tid / 16, tx = tid % 16). Rows and keys sit in shared
// memory as float32 with a row stride of d + 4 words, so that the float4
// reads of 16 consecutive keys fall on distinct banks. chunk_score,
// chunk_attention and decode_attention run their products on the tensor
// cores (split-TF32 where an operand is float32: the tf32 and mma helpers
// below) and finish their cross-CTA sums in the last CTA to arrive
// (last_to_arrive). Every sum runs in a fixed order: no float atomics, the
// same result on every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <type_traits>

#define CKV_NEG_INF (-1e30f)
#define CKV_MASKED(x) ((x) <= -1e29f)

namespace ckv {

enum DType { F32 = 0, BF16 = 1, F16 = 2 };

constexpr int NT = 256;  // threads per CTA
constexpr int TR = 64;   // rows per tile
constexpr int TK = 64;   // keys per tile

// Runs a host call once per device and keeps its result: for
// cudaFuncSetAttribute, which acts on the device current when it is called.
// One static instance per kernel instantiation.
struct OncePerDevice {
  static constexpr int kMaxDevices = 64;
  std::once_flag flag[kMaxDevices];
  cudaError_t err[kMaxDevices] = {};

  template <typename F>
  cudaError_t operator()(F&& f) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(flag[dev], [&] { err[dev] = f(); });
    return err[dev];
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// d ** -0.5 as Python computes it, rounded once to float32
inline float softmax_scale(int d) { return (float)std::pow((double)d, -0.5); }

// shared-memory row stride of a (rows, d) float32 tile
__host__ __device__ __forceinline__ int tile_ld(int d) { return d + 4; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// reductions over the 16 lanes that share one ty (one half of a warp)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte asynchronous copy global -> shared; when !valid the 16 bytes are
// zero-filled and nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 operands: an exact TF32 value is a float32 whose low 13 mantissa bits
// are 0 (every float16 and bfloat16 value is one). A float32 x splits into
// hi = rna(x) and lo = rna(x - hi); x - hi - lo is below 2^-22 |x|.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16 x 8, float32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col).
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x16] * b[16x8] in bfloat16 or float16, float32 accumulation
template <typename T>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (sizeof(T) == 2 && std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Called by every thread of each CTA that shares *counter once its partial
// results are stored: true in the last CTA to arrive, which then reads the
// others' partials (with __ldcg) and resets the counter for the next launch.
// Which CTA comes last varies from run to run; what it computes must not.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n_arrivals, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == n_arrivals - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Load rows [r_lo, r_hi) of d elements each into a float32 tile of row
// stride ld; row_ptr(r) gives the source row, or nullptr for a row of zeros.
// Each thread moves 16-byte vectors and keeps four loads in flight before it
// stores, so a tile costs a few round trips to L2 rather than one per
// element. Needs d a multiple of 16 / sizeof(T) and 16-byte aligned rows.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst, int ld, int r_lo, int r_hi, int d,
                                          RowPtr row_ptr) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = d / VEC, total = (r_hi - r_lo) * per_row;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    uint4 buf[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int i = base + u * blockDim.x;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total) {
        const T* src = row_ptr(r_lo + i / per_row);
        if (src) buf[u] = *reinterpret_cast<const uint4*>(src + (i % per_row) * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int i = base + u * blockDim.x;
      if (i < total) {
        float* out = dst + (r_lo + i / per_row) * ld + (i % per_row) * VEC;
        const T* v = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = to_f32(v[e]);
      }
    }
  }
}

template <typename T, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int rows, int d, RowPtr row_ptr) {
  load_rows<T>(dst, tile_ld(d), 0, rows, d, row_ptr);
}

// acc[i][j] = sum over x of qs[ty + 16 i][x] * ks[tx + 16 j][x], x ascending
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks, int d, int ty,
                                            int tx, float acc[4][4]) {
  const int ld = tile_ld(d);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int x = 0; x < d; x += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ld + x);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// Online-softmax step for this thread's 4 rows over one key tile: sc holds
// scaled scores (CKV_NEG_INF where masked). On return sc holds the
// unnormalised probabilities exp(s - m_new) (0 where masked), m_run/l_run
// are updated, and alpha[i] = exp(m_old - m_new) rescales earlier sums.
__device__ __forceinline__ void online_softmax(float sc[4][4], float m_run[4], float l_run[4],
                                               float alpha[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
    float m_new = fmaxf(m_run[i], half_max(mx));
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[i][j] = CKV_MASKED(sc[i][j]) ? 0.f : expf(sc[i][j] - m_new);
      p += sc[i][j];
    }
    p = half_sum(p);
    alpha[i] = expf(m_run[i] - m_new);
    l_run[i] = l_run[i] * alpha[i] + p;
    m_run[i] = m_new;
  }
}

}  // namespace ckv

extern "C" const char* ckv_error_string(int code);
