// selective_scan: the mamba-1 recurrence with a scalar dt per position.
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/kernel.py:
// selective_scan (_scan_kernel):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = h_t . C_t,
// with h (d_in, n) float32 per request, seeded from h0 (decode resumes the
// carried state) or zeros, and returns (y (b, s, d_in), h_final) in float32.
// The TPU kernel asserted s % block_s == 0 and d_in % block_d == 0; this one
// takes any s and d_in (the hybrid prompt is 4160 tokens).
//
// Layout of the work: one thread owns one (channel, state) element of h and
// keeps it in a register for the whole sequence, so nothing is carried
// across CTAs (the TPU kernel carried h in VMEM along a sequential grid
// axis). The n threads of a channel are n neighbouring lanes of a warp;
// y_t sums their h * C_t by xor shuffles. A CTA of 256 threads serves
// 256 / n channels of one request and walks the sequence in steps of 32
// positions: it stages x, dt, B and C of the next 32 positions in shared
// memory with coalesced loads, runs the 32 dependent updates from there,
// and writes those rows of y back coalesced. Decode is the same launch at
// s = 1 seeded with h0.
//
// Bound on the H100: bytes. At the hybrid prefill (s = 4160, d_in = 3200,
// n = 16, bfloat16 x) it must read x (27 MB) and write y in float32 (53 MB):
// ~0.024 ms at 3.35 TB/s, against ~1 GFLOP. The sequential loop over s
// makes this first version latency-bound (every step waits on the one
// before through h), several times the bound; a chunked two-pass scan is
// the way past it. Decode reads and writes h (410 KB per request): launch-
// bound.
#include "common.cuh"

namespace ckv {

constexpr int SS_THREADS = 256;
constexpr int SS_STEPS = 32;  // positions staged in shared memory per step

template <typename T>
static __global__ void __launch_bounds__(SS_THREADS) selective_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int s, int d_in, int n, int b_sb,
    int b_ss, int c_sb, int c_ss) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int ch_per_cta = SS_THREADS / n;
  float* xs = smem;                         // [SS_STEPS][ch_per_cta]
  float* ys = xs + SS_STEPS * ch_per_cta;   // [SS_STEPS][ch_per_cta]
  float* bs = ys + SS_STEPS * ch_per_cta;   // [SS_STEPS][n]
  float* cs = bs + SS_STEPS * n;            // [SS_STEPS][n]
  float* dts = cs + SS_STEPS * n;           // [SS_STEPS]
  const int c = tid / n, j = tid % n;  // channel within the CTA, state index
  const int ch0 = blockIdx.x * ch_per_cta, ch = ch0 + c;
  const bool live = ch < d_in;
  const size_t hidx = ((size_t)b * d_in + ch) * n + j;
  const float a = live ? A[(size_t)ch * n + j] : 0.f;
  float h = (live && h0) ? h0[hidx] : 0.f;
  const T* xb = x + (size_t)b * s * d_in;
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  float* yb = y + (size_t)b * s * d_in;
  for (int t0 = 0; t0 < s; t0 += SS_STEPS) {
    const int ts = min(SS_STEPS, s - t0);
    __syncthreads();
    for (int i = tid; i < ts * ch_per_cta; i += SS_THREADS) {
      int tt = i / ch_per_cta, cc = i % ch_per_cta;
      xs[tt * ch_per_cta + cc] =
          ch0 + cc < d_in ? to_f32(xb[(size_t)(t0 + tt) * d_in + ch0 + cc]) : 0.f;
    }
    for (int i = tid; i < ts * n; i += SS_THREADS) {
      int tt = i / n, jj = i % n;
      bs[tt * n + jj] = to_f32(bb[(size_t)(t0 + tt) * b_ss + jj]);
      cs[tt * n + jj] = to_f32(cb[(size_t)(t0 + tt) * c_ss + jj]);
    }
    for (int i = tid; i < ts; i += SS_THREADS) dts[i] = dt[(size_t)b * s + t0 + i];
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < ts; ++tt) {
      const float d = dts[tt];
      h = expf(d * a) * h + (d * xs[tt * ch_per_cta + c]) * bs[tt * n + j];
      float p = h * cs[tt * n + j];
      for (int o = n / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (j == 0) ys[tt * ch_per_cta + c] = p;
    }
    __syncthreads();
    for (int i = tid; i < ts * ch_per_cta; i += SS_THREADS) {
      int tt = i / ch_per_cta, cc = i % ch_per_cta;
      if (ch0 + cc < d_in) yb[(size_t)(t0 + tt) * d_in + ch0 + cc] = ys[tt * ch_per_cta + cc];
    }
  }
  if (live) h_out[hidx] = h;
}

template <typename T>
static void launch_scan(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* h0, float* y, float* h_out, int b, int s,
                        int d_in, int n, int b_sb, int b_ss, int c_sb, int c_ss,
                        cudaStream_t st) {
  const int ch_per_cta = SS_THREADS / n;
  // at most 2 x 32 x 128 + 2 x 32 x 32 + 32 floats (n >= 2): under 48 KB
  const size_t smem = sizeof(float) * SS_STEPS * (2 * ch_per_cta + 2 * n + 1);
  dim3 grid((d_in + ch_per_cta - 1) / ch_per_cta, b);
  selective_scan_kernel<T><<<grid, SS_THREADS, smem, st>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, y, h_out, s, d_in, n, b_sb, b_ss,
      c_sb, c_ss);
}

}  // namespace ckv

// x (b, s, d_in) contiguous in dtype; dt (b, s) float32; A (d_in, n) float32;
// B/C (b, s, n) in dtype with element strides (b_sb, b_ss) / (c_sb, c_ss) and a
// contiguous last dim; h0 (b, d_in, n) float32 or null for zeros. Out: y
// (b, s, d_in) float32, h_out (b, d_in, n) float32. n is a power of two, 2 <= n <= 32.
extern "C" int ckv_selective_scan(const void* x, const float* dt, const float* A, const void* Bm,
                                  const void* Cm, const float* h0, float* y, float* h_out, int b,
                                  int s, int d_in, int n, int b_sb, int b_ss, int c_sb, int c_ss,
                                  int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 2 || n > 32 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case ckv::F32:
      ckv::launch_scan<float>(x, dt, A, Bm, Cm, h0, y, h_out, b, s, d_in, n, b_sb, b_ss, c_sb,
                              c_ss, st);
      break;
    case ckv::BF16:
      ckv::launch_scan<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h_out, b, s, d_in, n, b_sb, b_ss,
                                      c_sb, c_ss, st);
      break;
    case ckv::F16:
      ckv::launch_scan<__half>(x, dt, A, Bm, Cm, h0, y, h_out, b, s, d_in, n, b_sb, b_ss, c_sb,
                               c_ss, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
