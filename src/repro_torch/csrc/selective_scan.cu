// selective_scan: the mamba-1 recurrence with a scalar dt per position.
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/kernel.py:
// selective_scan (_scan_kernel):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = h_t . C_t,
// with h (d_in, n) float32 per request, seeded from h0 (decode resumes the
// carried state) or zeros, and returns (y (b, s, d_in), h_final) in float32.
// The TPU kernel asserted s % block_s == 0 and d_in % block_d == 0; these
// take any s and d_in (the hybrid prompt is 4160 tokens). The TPU kernel
// carried h in VMEM along a sequential grid axis; CTAs on the card run in no
// order, so each CTA here owns whole channels of one request for the whole
// sequence and nothing is carried across CTAs.
//
// Two kernels; the wrapper (kernels/selective_scan/ops.py) picks one by s:
//
// * chunked (s >= 16: every prefill). The sequence is parallel, not the
//   loop. A first small kernel packs B, C and dt, which all channels share,
//   once per 256-position chunk into an image in device memory (B and C in
//   the input dtype, laid out so that a thread's run is two or four 16-byte
//   vectors; B and C arrive as slices of the (b, s, 2n + 1) projection, whose
//   66-byte rows (n = 16) no 16-byte copy can read). Then a CTA of 256
//   threads owns 16 channels of one request for the whole sequence; the 16
//   threads of a channel each take a run of 16 consecutive positions of a
//   chunk. The CTA copies chunk k + 1's image and x rows into shared memory
//   with cp.async while it computes chunk k (double-buffered). Per chunk, x
//   becomes float32 runs per channel; then for each state index j a thread
//   forms a_t = exp2(dt_t * A_j log2 e) and b_t = dt_t x_t B_tj over its run
//   (one exponential per position, channel and state), folds them into the
//   pair (prod a, local h) under (a2 a1, a2 b1 + b2), and the 16 threads of
//   the channel scan their pairs with four shuffle steps. Seeded with the h
//   carried from the previous chunk, that gives every h_t of the run, and
//   y_t += C_tj h_t accumulates in registers across j, with no per-step
//   reduction over lanes. The carry is the h of the chunk's last position,
//   kept in shared memory per (channel, state), so one pass covers the
//   sequence. y goes back through shared memory to coalesced rows. The sums
//   are re-associated against the sequential form, so y and h move by
//   rounding (within 1e-5 relative); a scan resumed from its carried state
//   is bit-identical to the whole scan where the cut falls on a 256-position
//   chunk boundary (the same chunks then see the same inputs and carries).
// * sequential (s < 16: the decode step, s = 1 seeded with h0), the step
//   kernel. One thread owns one channel of one request, with the channel's
//   n states of h and of A log2 e in registers (loaded as 16-byte vectors; n
//   a template parameter); it reads x, dt, B and C of each position straight
//   from device memory (B and C, shared by all channels, as L1 broadcasts),
//   every load of a position before any use and the next position's ahead,
//   sums y over j in registers (no shuffles, no shared memory, no barrier)
//   and stores h and y directly: 3200 threads a hymba request, 8192 a
//   falcon-mamba one, in CTAs of 128. It uses the chunked kernel's
//   exponential, ex2.approx of dt (A log2 e), and its fma order, so decode
//   and prefill do the same arithmetic per element.
//
// Bound on the H100 at the hybrid prefill (s = 4160, d_in = 3200, n = 16,
// bfloat16 x): s x d_in x n = 2.1e8 exponentials, ~0.051 ms at the
// special-function units' 16 per clock per SM (132 SMs at 1.98 GHz), above
// the bytes (x 27 MB read, y 53 MB written in float32: ~0.024 ms) and the
// float32 arithmetic (~6 operations per exponential, ~0.019 ms at
// 67 TFLOP/s). A sequential kernel took 0.97 ms there: one thread
// walked all 4160 positions, each step waiting on the last through h and
// adding a shuffle chain for y; the chunked kernel takes 0.22 ms. What holds
// it back now is latency, not a unit's rate: one CTA alone on each SM
// (d_in = 132 x 16) already takes 0.15 ms (two warps per scheduler, each
// chunk's j loop a chain of dependent steps), 200 CTAs put two on 68 of the
// 132 SMs, and 125 registers per thread allow no third (chip_smoke.py times
// both). The decode step reads h and A and writes h once (0.63 MB a hymba
// request, 1.6 MB a falcon-mamba one: 0.19 / 0.48 us at 3.35 TB/s); the
// launch and one dependent round trip to memory bound it, not a unit's rate.
#include <cstdint>

#include "common.cuh"

namespace ckv {

constexpr int SD_THREADS = 128;  // channels per CTA of the step kernel
constexpr float SC_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float sc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// N consecutive float32 values (a row of A or of h) as 16-byte vectors
// (8-byte ones for N = 2); the row starts on a multiple of N floats
template <int N>
__device__ __forceinline__ void load_state_row(const float* src, float (&v)[N]) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(src + j);
      v[j] = a.x, v[j + 1] = a.y, v[j + 2] = a.z, v[j + 3] = a.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_state_row(float* dst, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

// One position's inputs of one channel: x, dt, and the n values of B and C
// that every channel of the request shares (L1 broadcasts)
template <typename T, int N>
struct StepIn {
  float x, dt, b[N], c[N];
  __device__ __forceinline__ void load(const T* xp, const float* dtp, const T* bp,
                                       const T* cp) {
    x = to_f32(*xp);
    dt = *dtp;
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = to_f32(bp[j]), c[j] = to_f32(cp[j]);
  }
};

// step kernel (the decode step, s < 16): grid (ceil(d_in / SD_THREADS), b);
// one thread per channel of one request walks the positions with the
// channel's n states of h and of A log2 e in registers. Every load of a
// position is started before any is used, the next position's before this
// one's arithmetic; y sums C_j h_j over j ascending, in registers. The
// arithmetic per element is the chunked kernel's: a = ex2(dt (A log2 e)),
// h = fma(a, h, (dt x) B), y = fma(C, h, y).
template <typename T, int N>
static __global__ void __launch_bounds__(SD_THREADS) selective_scan_step_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int s, int d_in, int b_sb, int b_ss,
    int c_sb, int c_ss) {
  const int ch = blockIdx.x * SD_THREADS + threadIdx.x, b = blockIdx.y;
  if (ch >= d_in) return;
  const T* xb = x + (size_t)b * s * d_in + ch;
  const float* dtb = dt + (size_t)b * s;
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  float* yb = y + (size_t)b * s * d_in + ch;
  const size_t hrow = ((size_t)b * d_in + ch) * N;
  StepIn<T, N> cur;
  cur.load(xb, dtb, bb, cb);
  float a2[N], h[N];
  load_state_row<N>(A + (size_t)ch * N, a2);
  if (h0) {
    load_state_row<N>(h0 + hrow, h);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) h[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) a2[j] *= SC_LOG2E;
  for (int t = 0; t < s; ++t) {
    StepIn<T, N> nxt;
    if (t + 1 < s)
      nxt.load(xb + (size_t)(t + 1) * d_in, dtb + t + 1, bb + (size_t)(t + 1) * b_ss,
               cb + (size_t)(t + 1) * c_ss);
    const float dtx = cur.dt * cur.x;
    float yv = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      h[j] = fmaf(sc_exp2(cur.dt * a2[j]), h[j], dtx * cur.b[j]);
      yv = fmaf(cur.c[j], h[j], yv);
    }
    yb[(size_t)t * d_in] = yv;
    if (t + 1 < s) cur = nxt;
  }
  store_state_row<N>(h_out + hrow, h);
}

template <typename T>
static cudaError_t launch_scan_step(const void* x, const float* dt, const float* A,
                                    const void* Bm, const void* Cm, const float* h0, float* y,
                                    float* h_out, int b, int s, int d_in, int n, int b_sb,
                                    int b_ss, int c_sb, int c_ss, cudaStream_t st) {
  const dim3 grid((d_in + SD_THREADS - 1) / SD_THREADS, b);
  auto go = [&](auto kernel) {
    kernel<<<grid, SD_THREADS, 0, st>>>((const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, y,
                                        h_out, s, d_in, b_sb, b_ss, c_sb, c_ss);
  };
  switch (n) {
    case 2: go(selective_scan_step_kernel<T, 2>); break;
    case 4: go(selective_scan_step_kernel<T, 4>); break;
    case 8: go(selective_scan_step_kernel<T, 8>); break;
    case 16: go(selective_scan_step_kernel<T, 16>); break;
    case 32: go(selective_scan_step_kernel<T, 32>); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// chunked kernel (prefill)
constexpr int SC_RUN = 16;                  // positions per thread
constexpr int SC_TPC = 16;                  // threads per channel
constexpr int SC_CHUNK = SC_RUN * SC_TPC;   // positions per chunk
constexpr int SC_CH = 16;                   // channels per CTA
constexpr int SC_THREADS = SC_TPC * SC_CH;  // 256
constexpr int SC_XRUN = SC_RUN + 1;         // float runs of x, y and dt: odd stride
constexpr int SC_XLD = SC_TPC * SC_XRUN + 18;  // a channel's row: 290 = 2 mod 32 words

// A chunk's image: B and C in the input dtype, per state j a row of 16 runs
// of 16 positions, each run padded by 16 bytes so that 8 neighbouring runs'
// 16-byte vectors hit distinct banks, rows padded by 16 bytes more; then dt
// as float32 runs of SC_XRUN. The pack kernel writes it once per chunk into
// device memory; every CTA copies it to shared memory as it is.
template <typename T>
struct ScanImg {
  static constexpr int VEC = 16 / sizeof(T);     // values per 16-byte vector
  static constexpr int RUN = SC_RUN + VEC;       // elements per padded run
  static constexpr int LD = SC_TPC * RUN + VEC;  // elements per state row
  static constexpr int DT_BYTES = SC_TPC * SC_XRUN * 4;
  static __host__ __device__ int bc_bytes(int n) { return n * LD * (int)sizeof(T); }
  static __host__ __device__ int bytes(int n) { return 2 * bc_bytes(n) + DT_BYTES; }
};

__device__ __forceinline__ int sc_xpos(int t) { return (t / SC_RUN) * SC_XRUN + t % SC_RUN; }

// 16-byte asynchronous copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void sc_cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the 16 values of a run, as float32
template <typename T>
__device__ __forceinline__ void load_run(const T* src, float (&v)[SC_RUN]) {
  constexpr int VEC = ScanImg<T>::VEC;
#pragma unroll
  for (int u = 0; u < SC_RUN / VEC; ++u) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + u * VEC);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[u * VEC + i] = to_f32(e[i]);
  }
}

// grid (chunks, b): chunk images of B, C and dt; zeros past s and in the pads
template <typename T>
static __global__ void __launch_bounds__(256) selective_scan_pack_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ dt,
    unsigned char* __restrict__ img, int s, int n, int b_sb, int b_ss, int c_sb, int c_ss) {
  using I = ScanImg<T>;
  const int b = blockIdx.y, t0 = blockIdx.x * SC_CHUNK;
  unsigned char* im = img + ((size_t)b * gridDim.x + blockIdx.x) * I::bytes(n);
  T* bi = reinterpret_cast<T*>(im);
  T* ci = bi + n * I::LD;
  float* di = reinterpret_cast<float*>(im + 2 * I::bc_bytes(n));
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  for (int i = threadIdx.x; i < n * I::LD; i += blockDim.x) {
    const int j = i / I::LD, q = i % I::LD, p = q / I::RUN, r = q % I::RUN;
    const int t = t0 + p * SC_RUN + r;
    const bool in = p < SC_TPC && r < SC_RUN && t < s;
    bi[i] = in ? bb[(size_t)t * b_ss + j] : from_f32<T>(0.f);
    ci[i] = in ? cb[(size_t)t * c_ss + j] : from_f32<T>(0.f);
  }
  for (int i = threadIdx.x; i < SC_TPC * SC_XRUN; i += blockDim.x) {
    const int t = t0 + (i / SC_XRUN) * SC_RUN + i % SC_XRUN;
    di[i] = i % SC_XRUN < SC_RUN && t < s ? dt[(size_t)b * s + t] : 0.f;
  }
}

// grid (ceil(d_in / 16), b), 256 threads; x_vec: x's rows of 16 channels
// are whole 16-byte vectors (d_in a multiple of 16 / sizeof(T))
template <typename T>
static __global__ void __launch_bounds__(SC_THREADS, 2) selective_scan_chunked_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ img,
    const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_out, int s, int d_in, int n, int x_vec) {
  using I = ScanImg<T>;
  constexpr int XV = SC_CH * (int)sizeof(T) / 16;  // 16-byte vectors per x row
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const int img_bytes = I::bytes(n), n_chunks = (s + SC_CHUNK - 1) / SC_CHUNK;
  // double-buffered: chunk images, and x rows as loaded ([SC_CHUNK][SC_CH])
  auto ims = [&](int k) { return sc_smem + (k & 1) * img_bytes; };
  auto xraw = [&](int k) {
    return reinterpret_cast<T*>(sc_smem + 2 * img_bytes) + (k & 1) * SC_CHUNK * SC_CH;
  };
  // [SC_CH][SC_XLD]: x as float32 runs, then y
  float* xs = reinterpret_cast<float*>(reinterpret_cast<T*>(sc_smem + 2 * img_bytes) +
                                       2 * SC_CHUNK * SC_CH);
  float* a2s = xs + SC_CH * SC_XLD;  // [SC_CH][n]: A log2 e
  float* carry = a2s + SC_CH * n;    // [SC_CH][n]: h at the last chunk's end
  const int tid = threadIdx.x, b = blockIdx.y;
  const int c = tid / SC_TPC, p = tid % SC_TPC;  // channel within the CTA, run
  const int ch0 = blockIdx.x * SC_CH;
  for (int i = tid; i < SC_CH * n; i += SC_THREADS) {
    const int cc = i / n, j = i % n, ch = ch0 + cc;
    const bool live = ch < d_in;
    a2s[i] = live ? A[(size_t)ch * n + j] * SC_LOG2E : 0.f;
    carry[i] = live && h0 ? h0[((size_t)b * d_in + ch) * n + j] : 0.f;
  }
  const T* xb = x + (size_t)b * s * d_in;
  const unsigned char* imb = img + (size_t)b * n_chunks * img_bytes;
  float* yb = y + (size_t)b * s * d_in;
  const float* xrow = xs + c * SC_XLD + p * SC_XRUN;  // this thread's run
  const int brun = p * I::RUN;

  // chunk k's image, and its x rows when they are whole vectors, into buffer k & 1
  auto prefetch = [&](int k) {
    const unsigned char* src = imb + (size_t)k * img_bytes;
    for (int v = tid; v < img_bytes / 16; v += SC_THREADS)
      sc_cp16(ims(k) + 16 * v, src + 16 * v, 16);
    if (x_vec)
      for (int v = tid; v < SC_CHUNK * XV; v += SC_THREADS) {
        const int tt = v / XV, u = v % XV, t = k * SC_CHUNK + tt;
        const int ch = ch0 + u * (16 / (int)sizeof(T));
        const bool in = t < s && ch < d_in;
        sc_cp16(xraw(k) + v * (16 / (int)sizeof(T)), in ? xb + (size_t)t * d_in + ch : xb,
                in ? 16 : 0);
      }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  prefetch(0);
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * SC_CHUNK, ts = min(SC_CHUNK, s - t0);
    if (k + 1 < n_chunks) {
      prefetch(k + 1);  // buffer (k + 1) & 1 was last read before the last barrier
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // chunk k's copies have landed; the last chunk's y has left xs
    // x to float32 runs per channel; positions past s are zeros, and dt = 0
    // there makes them (a, b) = (1, 0), which leaves h exactly as it was
    if (x_vec) {
      const T* xr = xraw(k);
      for (int i = tid; i < SC_CHUNK * SC_CH; i += SC_THREADS)
        xs[(i % SC_CH) * SC_XLD + sc_xpos(i / SC_CH)] = to_f32(xr[i]);
    } else {
      for (int i = tid; i < SC_CHUNK * SC_CH; i += SC_THREADS) {
        const int tt = i / SC_CH, cc = i % SC_CH;
        xs[cc * SC_XLD + sc_xpos(tt)] =
            tt < ts && ch0 + cc < d_in ? to_f32(xb[(size_t)(t0 + tt) * d_in + ch0 + cc]) : 0.f;
      }
    }
    __syncthreads();

    const T* bs = reinterpret_cast<const T*>(ims(k));
    const T* cs = bs + n * I::LD;
    const float* dts = reinterpret_cast<const float*>(ims(k) + 2 * I::bc_bytes(n));
    float dtr[SC_RUN], dtx[SC_RUN], yv[SC_RUN];
#pragma unroll
    for (int r = 0; r < SC_RUN; ++r) {
      dtr[r] = dts[p * SC_XRUN + r];
      dtx[r] = dtr[r] * xrow[r];
      yv[r] = 0.f;
    }
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float a2 = a2s[c * n + j], h_in = carry[c * n + j];
      float bv[SC_RUN], pr[SC_RUN], hl[SC_RUN];
      load_run<T>(bs + j * I::LD + brun, bv);
      // the run from a zero state: its h and the running product of a
      float pc = 1.f, h = 0.f;
#pragma unroll
      for (int r = 0; r < SC_RUN; ++r) {
        const float a = sc_exp2(dtr[r] * a2);
        h = fmaf(a, h, dtx[r] * bv[r]);
        pc *= a;
        pr[r] = pc;
        hl[r] = h;
      }
      // inclusive scan of the runs' (prod a, h) over the channel's threads,
      // then shifted by one: the pair of all runs before this one
      float ag = pc, bg = h;
#pragma unroll
      for (int o = 1; o < SC_TPC; o <<= 1) {
        const float au = __shfl_up_sync(0xffffffffu, ag, o, SC_TPC);
        const float bu = __shfl_up_sync(0xffffffffu, bg, o, SC_TPC);
        if (p >= o) {
          bg = fmaf(ag, bu, bg);
          ag *= au;
        }
      }
      float ae = __shfl_up_sync(0xffffffffu, ag, 1, SC_TPC);
      float be = __shfl_up_sync(0xffffffffu, bg, 1, SC_TPC);
      if (p == 0) ae = 1.f, be = 0.f;
      const float h_start = fmaf(ae, h_in, be);
      float cv[SC_RUN];
      load_run<T>(cs + j * I::LD + brun, cv);
#pragma unroll
      for (int r = 0; r < SC_RUN; ++r) {
        h = fmaf(pr[r], h_start, hl[r]);
        yv[r] = fmaf(cv[r], h, yv[r]);
      }
      if (p == SC_TPC - 1) carry[c * n + j] = h;
    }

    __syncthreads();  // every thread has read its x: the buffer takes y
#pragma unroll
    for (int r = 0; r < SC_RUN; ++r) xs[c * SC_XLD + p * SC_XRUN + r] = yv[r];
    __syncthreads();
    for (int i = tid; i < ts * SC_CH; i += SC_THREADS) {
      const int tt = i / SC_CH, cc = i % SC_CH;
      if (ch0 + cc < d_in) yb[(size_t)(t0 + tt) * d_in + ch0 + cc] = xs[cc * SC_XLD + sc_xpos(tt)];
    }
  }
  __syncthreads();
  for (int i = tid; i < SC_CH * n; i += SC_THREADS) {
    const int ch = ch0 + i / n;
    if (ch < d_in) h_out[((size_t)b * d_in + ch) * n + i % n] = carry[i];
  }
}

template <typename T>
static size_t scan_scratch_bytes(int b, int s, int n) {
  return (size_t)b * ((s + SC_CHUNK - 1) / SC_CHUNK) * ScanImg<T>::bytes(n);
}

// shared memory of the chunked kernel. bfloat16, n = 16: 2 x 26176 + 2 x 8192
// + (16 x 290 + 2 x 16 x 16) x 4 bytes, ~89 KB; float32, n = 32: ~218 KB
template <typename T>
static size_t chunked_smem(int n) {
  return 2 * (size_t)ScanImg<T>::bytes(n) + 2 * sizeof(T) * SC_CHUNK * SC_CH +
         sizeof(float) * (SC_CH * SC_XLD + 2 * SC_CH * n);
}

template <typename T>
static cudaError_t launch_scan_chunked(const void* x, const float* dt, const float* A,
                                       const void* Bm, const void* Cm, const float* h0, float* y,
                                       float* h_out, void* scratch, int b, int s, int d_in, int n,
                                       int b_sb, int b_ss, int c_sb, int c_ss, cudaStream_t st) {
  static OncePerDevice smem_opt_in;  // at the largest n
  const cudaError_t attr = smem_opt_in([] {
    return cudaFuncSetAttribute(selective_scan_chunked_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)chunked_smem<T>(32));
  });
  if (attr != cudaSuccess) return attr;
  const int n_chunks = (s + SC_CHUNK - 1) / SC_CHUNK;
  selective_scan_pack_kernel<T><<<dim3(n_chunks, b), 256, 0, st>>>(
      (const T*)Bm, (const T*)Cm, dt, (unsigned char*)scratch, s, n, b_sb, b_ss, c_sb, c_ss);
  const int x_vec = d_in % (16 / (int)sizeof(T)) == 0;
  selective_scan_chunked_kernel<T>
      <<<dim3((d_in + SC_CH - 1) / SC_CH, b), SC_THREADS, chunked_smem<T>(n), st>>>(
          (const T*)x, (const unsigned char*)scratch, A, h0, y, h_out, s, d_in, n, x_vec);
  return cudaGetLastError();
}

}  // namespace ckv

// Device bytes of the scratch the chunked kernel needs (its chunk images).
extern "C" long long ckv_selective_scan_scratch(int b, int s, int n, int dtype) {
  switch (dtype) {
    case ckv::F32:
      return (long long)ckv::scan_scratch_bytes<float>(b, s, n);
    case ckv::BF16:
      return (long long)ckv::scan_scratch_bytes<__nv_bfloat16>(b, s, n);
    case ckv::F16:
      return (long long)ckv::scan_scratch_bytes<__half>(b, s, n);
    default:
      return -1;
  }
}

// x (b, s, d_in) contiguous in dtype; dt (b, s) float32; A (d_in, n) float32;
// B/C (b, s, n) in dtype with element strides (b_sb, b_ss) / (c_sb, c_ss) and a
// contiguous last dim; h0 (b, d_in, n) float32 or null for zeros. Out: y
// (b, s, d_in) float32, h_out (b, d_in, n) float32. n is a power of two,
// 2 <= n <= 32. variant: 0 sequential, the step kernel (scratch unused), 1
// chunked (scratch of ckv_selective_scan_scratch bytes, 16-byte aligned).
extern "C" int ckv_selective_scan(const void* x, const float* dt, const float* A, const void* Bm,
                                  const void* Cm, const float* h0, float* y, float* h_out,
                                  void* scratch, int b, int s, int d_in, int n, int b_sb,
                                  int b_ss, int c_sb, int c_ss, int dtype, int variant,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 2 || n > 32 || (n & (n - 1)) || variant < 0 || variant > 1 ||
      (variant == 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return variant == 1
               ? ckv::launch_scan_chunked<T>(x, dt, A, Bm, Cm, h0, y, h_out, scratch, b, s, d_in,
                                             n, b_sb, b_ss, c_sb, c_ss, st)
               : ckv::launch_scan_step<T>(x, dt, A, Bm, Cm, h0, y, h_out, b, s, d_in, n, b_sb,
                                          b_ss, c_sb, c_ss, st);
  };
  switch (dtype) {
    case ckv::F32:
      return (int)run(float{});
    case ckv::BF16:
      return (int)run(__nv_bfloat16{});
    case ckv::F16:
      return (int)run(__half{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}
