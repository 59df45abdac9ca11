// What the wgmma attention kernels share (flash_attention.cu's forward,
// flash_attention_bwd.cu's backward): mbarriers, TMA loads of swizzled
// tiles over a strided (d, position, head, batch) view and 1-d bulk copies,
// both completing on an mbarrier, the tensor maps' encoding on the host, and
// the register helpers of the softmax (ex2, two floats packed as 16-bit
// values).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ckv {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
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
// read as zeros. A batch of one never steps the batch coordinate, so any
// aligned batch stride will do there.
static bool encode_map(CUtensorMap* map, const void* ptr, bool bf16, int d, int s_len, int heads,
                       int batch, long long ss, long long sh, long long sb, int rows,
                       MapCoord* coord) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  if (batch == 1) sb = ss * s_len + sh * heads;
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

}  // namespace ckv
