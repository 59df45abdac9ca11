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
// The backward (training, below): a pack launch into an image of its own,
// then a kernel that walks the chunks from last to first from the carries
// the forward saved (a warp per two channels, two CTAs an SM), then a
// reduction of its per-CTA partials.
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
// are whole 16-byte vectors (d_in a multiple of 16 / sizeof(T)). SAVE (the
// training forward's instance): also store h at the start of every chunk
// into carries (b, n_chunks, d_in, n) float32, for the backward kernel;
// serving's instance (SAVE false) has no such store.
template <typename T, bool SAVE>
static __global__ void __launch_bounds__(SC_THREADS, 2) selective_scan_chunked_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ img,
    const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_out, float* __restrict__ carries, int s, int d_in, int n,
    int x_vec) {
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
    if constexpr (SAVE) {  // h at chunk k's start; the j loop rewrites carry after a barrier
      float* ck = carries + ((size_t)b * n_chunks + k) * d_in * n;
      for (int i = tid; i < SC_CH * n; i += SC_THREADS) {
        const int ch = ch0 + i / n;
        if (ch < d_in) ck[(size_t)ch * n + i % n] = carry[i];
      }
    }
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

template <typename T, bool SAVE>
static cudaError_t launch_chunked_instance(const void* x, const float* A, const float* h0,
                                          float* y, float* h_out, float* carries,
                                          const void* scratch, int b, int s, int d_in, int n,
                                          cudaStream_t st) {
  static OncePerDevice smem_opt_in;  // at the largest n
  const cudaError_t attr = smem_opt_in([] {
    return cudaFuncSetAttribute(selective_scan_chunked_kernel<T, SAVE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)chunked_smem<T>(32));
  });
  if (attr != cudaSuccess) return attr;
  const int x_vec = d_in % (16 / (int)sizeof(T)) == 0;
  selective_scan_chunked_kernel<T, SAVE>
      <<<dim3((d_in + SC_CH - 1) / SC_CH, b), SC_THREADS, chunked_smem<T>(n), st>>>(
          (const T*)x, (const unsigned char*)scratch, A, h0, y, h_out, carries, s, d_in, n,
          x_vec);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_scan_chunked(const void* x, const float* dt, const float* A,
                                       const void* Bm, const void* Cm, const float* h0, float* y,
                                       float* h_out, float* carries, void* scratch, int b, int s,
                                       int d_in, int n, int b_sb, int b_ss, int c_sb, int c_ss,
                                       cudaStream_t st) {
  const int n_chunks = (s + SC_CHUNK - 1) / SC_CHUNK;
  selective_scan_pack_kernel<T><<<dim3(n_chunks, b), 256, 0, st>>>(
      (const T*)Bm, (const T*)Cm, dt, (unsigned char*)scratch, s, n, b_sb, b_ss, c_sb, c_ss);
  return carries ? launch_chunked_instance<T, true>(x, A, h0, y, h_out, carries, scratch, b, s,
                                                    d_in, n, st)
                 : launch_chunked_instance<T, false>(x, A, h0, y, h_out, nullptr, scratch, b, s,
                                                     d_in, n, st);
}

// ---------------------------------------------------------------------------
// The backward (training): no TPU kernel to replace; the JAX package
// differentiates its jnp chunked scan (src/repro/models/ssm.py:
// _selective_scan_chunked). With a_t = exp(dt_t A), u_t = dt_t x_t and
// q_t = a_t g_t, where g_t = dL/dh_t = dy_t C_t + q_{t+1} (q_s = dh_final):
//   q_t = a_t (dy_t C_t + q_{t+1}),           dh0 = q_0,
//   dC_t = sum_d dy_t h_t,   dB_t = sum_d u_t g_t,   dx_t = dt_t sum_n B_t g_t,
//   ddt_t = sum_{d,n} (x_t B_t + A a_t h_{t-1}) g_t,  dA = sum_{b,t} dt_t a_t h_{t-1} g_t.
// q's recurrence runs backwards with elements (a_t, a_t dy_t C_t) that are
// local to position t, so it decomposes as the forward's does.
//
// Three launches: selective_scan_bwd_pack_kernel packs B, C and dt per
// 256-position chunk into an image laid out for the backward (a lane's 8
// positions of one state are one 16-byte vector, two for float32);
// selective_scan_bwd_kernel walks the chunks from last to first;
// selective_scan_bwd_reduce_kernel adds its per-CTA partials.
//
// selective_scan_bwd_kernel: grid (ceil(d_in / 16), b), 256 threads, 16
// channels of one request per CTA, built for two CTAs an SM (at most 128
// registers a thread, no spill; ~112 KB of shared memory at bfloat16 and
// n 16): runs of 8 positions keep a lane's arrays small. Warp w owns
// channels 2w and 2w + 1 for the whole sequence; lane l owns positions
// 8l .. 8l + 7 of every chunk, for both channels. Per chunk it reads the
// image, x, dy and h at the chunk's start (``carries``, which the forward's
// SAVE instance stores). A state step j of a lane: per channel a_t =
// exp2(dt_t A_j log2 e) once per element and its run folded from a zero
// state, for h's pair (prod a, local h, with (dt_t x_t) B_t rounded as the
// forward rounds it) and, backwards, q's local q; the two channels' scans
// up the warp (h) and down it (q) together, five shuffle steps with their
// latencies overlapped; h recomputed along the run from its start; the two
// channels' walks back interleaved for every g_t. dx's and ddt's
// per-position sums stay in registers across j; dA's per (channel, j) sum
// is reduced over the warp one step later, while the next step's runs are
// in flight. dB and dC sum over channels: a lane adds its two channels'
// terms in registers, and the 8 warps add theirs into rows of shared
// memory, one row per state: warp w takes state (i + m w) mod n at step i
// (m = n / 8), so that within a window of m steps no two warps share a row
// and one barrier per window orders the additions (8 a chunk, not one per
// state; n < 8: groups of n warps with rows of their own, a barrier a
// step), and every row gets its warps' terms in a fixed order. Each chunk's
// rows then go out as one per-CTA partial (cta, b, 2, n, S), S = s rounded
// up to whole chunks; ddt's per-warp sums likewise into (cta, b, S). The
// reduction adds the partials over the CTAs, and dA over b, each in a fixed
// order. No atomics: every run gives the same bits.
//
// Copies overlap compute (cp.async): chunk k - 1's x rows, its dy (4-byte
// copies that land already transposed into runs) and its carries while
// chunk k's states run; its image while chunk k ends (dx and ddt written,
// the rows flushed).
//
// Bound on the H100 at hymba's training shape (b 1, s 4096, d_in 3200,
// n 16, bfloat16 x): s d_in n = 2.1e8 exponentials, ~0.050 ms at the
// special-function units' rate; 19 float32 operations an element at the
// CUDA cores' 67 TFLOP/s, ~0.060 ms; the bytes the function moves (x and dx
// 26 MB each, dy 52 MB in float32) ~0.031 ms. The kernel also writes its
// partials (dB and dC: 200 CTAs x 4096 x 16 x 2 x 4 bytes = 105 MB) and
// reads them again in the reduction. What holds it back is latency: at 16
// warps an SM the dependent chains of a state step (the scans' shuffles,
// the walk's chain through q) leave the schedulers idle much of the time;
// and 200 CTAs at hymba's width leave 64 of the 132 SMs with one CTA, so
// the busiest SMs run 32 channels against a mean of 24.
constexpr int SB_THREADS = 256;
constexpr int SB_WARPS = SB_THREADS / 32;  // 8
constexpr int SB_RUN = 8;                  // positions per lane
constexpr int SB_CH = 2 * SB_WARPS;        // channels per CTA: two per warp
constexpr int SB_LD = SC_CHUNK + 4;        // floats per channel row of runs: 260 = 4 mod 32
static_assert(SB_RUN * 32 == SC_CHUNK && SB_THREADS == SC_CHUNK, "a warp spans a chunk");

// Position t of a chunk in a row of float32 runs: lane t / 8's two 16-byte
// vectors ([v][lane][4], v = t / 4 % 2), so that a warp's float4 loads of
// one row are contiguous.
__host__ __device__ __forceinline__ int sb_pos(int t) {
  return ((t >> 2) & 1) * 128 + (t >> 3) * 4 + (t & 3);
}

// The backward's chunk image: B and C in the input dtype, per state j the
// chunk's 256 values as [u][lane][VEC] (a lane's run of 8 is U 16-byte
// vectors), then dt as a float32 row of runs (sb_pos).
template <typename T>
struct BwdImg {
  static constexpr int VEC = 16 / sizeof(T);  // values per 16-byte vector
  static constexpr int U = SB_RUN / VEC;       // vectors per run: 1, or 2 for float32
  static constexpr __host__ __device__ int bc_elems(int n) { return n * SC_CHUNK; }
  static constexpr __host__ __device__ int bytes(int n) {
    return 2 * bc_elems(n) * (int)sizeof(T) + SC_CHUNK * 4;
  }
  static __host__ __device__ __forceinline__ int pos(int t) {
    const int r = t % SB_RUN;
    return (r / VEC) * 32 * VEC + (t / SB_RUN) * VEC + r % VEC;
  }
};

// Byte offsets of the backward kernel's shared memory at state size N
template <typename T, int N>
struct BwdSmem {
  static constexpr int img = 0;                                  // chunk k's image
  static constexpr int xraw = img + BwdImg<T>::bytes(N);         // x rows as copied: [t][16]
  static constexpr int xs = xraw + SC_CHUNK * SB_CH * (int)sizeof(T);  // x as runs; then ddt
  static constexpr int dys = xs + SB_CH * SB_LD * 4;   // dy as runs, by chunk parity; then dx
  static constexpr int acc = dys + 2 * SB_CH * SB_LD * 4;        // dB, dC sums: [row][2][runs]
  static constexpr int ROWS = N < SB_WARPS ? SB_WARPS : N;      // rows of dB / dC sums
  static constexpr int dts = acc + ROWS * 2 * SC_CHUNK * 4;      // dt as runs
  static constexpr int as_ = dts + SC_CHUNK * 4;                 // A [16][N]
  static constexpr int hc = as_ + SB_CH * N * 4;                 // h at the chunk's start, by parity
  static constexpr int gcar = hc + 2 * SB_CH * N * 4;            // q after the chunk
  static constexpr int sda = gcar + SB_CH * N * 4;               // dA of this request
  static constexpr int total = sda + SB_CH * N * 4;
};

// 4-byte asynchronous copy; !valid fills zeros and reads nothing
__device__ __forceinline__ void sb_cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a lane's 8 values of a row of float32 runs
__device__ __forceinline__ void ld_run8(const float* row, int lane, float (&v)[SB_RUN]) {
  const float4 p = *reinterpret_cast<const float4*>(row + lane * 4);
  const float4 q = *reinterpret_cast<const float4*>(row + 128 + lane * 4);
  v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w, v[4] = q.x, v[5] = q.y, v[6] = q.z, v[7] = q.w;
}

__device__ __forceinline__ void st_run8(float* row, int lane, const float (&v)[SB_RUN]) {
  *reinterpret_cast<float4*>(row + lane * 4) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(row + 128 + lane * 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// a lane's 8 values of state row j of the image's B or C, as float32
template <typename T>
__device__ __forceinline__ void ld_img_run8(const T* row, int lane, float (&v)[SB_RUN]) {
  using I = BwdImg<T>;
#pragma unroll
  for (int u = 0; u < I::U; ++u) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + u * 32 * I::VEC + lane * I::VEC);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < I::VEC; ++i) v[u * I::VEC + i] = to_f32(e[i]);
  }
}

// grid (chunks, b): the backward's chunk images; zeros past s
template <typename T>
static __global__ void __launch_bounds__(256) selective_scan_bwd_pack_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ dt,
    unsigned char* __restrict__ img, int s, int n, int b_sb, int b_ss, int c_sb, int c_ss) {
  using I = BwdImg<T>;
  const int b = blockIdx.y, t0 = blockIdx.x * SC_CHUNK;
  unsigned char* im = img + ((size_t)b * gridDim.x + blockIdx.x) * I::bytes(n);
  T* bi = reinterpret_cast<T*>(im);
  T* ci = bi + I::bc_elems(n);
  float* di = reinterpret_cast<float*>(im + 2 * I::bc_elems(n) * sizeof(T));
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  for (int i = threadIdx.x; i < n * SC_CHUNK; i += blockDim.x) {
    const int t = i / n, j = i % n, tt = t0 + t;  // reads along a position's states
    const int o = j * SC_CHUNK + I::pos(t);
    bi[o] = tt < s ? bb[(size_t)tt * b_ss + j] : from_f32<T>(0.f);
    ci[o] = tt < s ? cb[(size_t)tt * c_ss + j] : from_f32<T>(0.f);
  }
  for (int t = threadIdx.x; t < SC_CHUNK; t += blockDim.x)
    di[sb_pos(t)] = t0 + t < s ? dt[(size_t)b * s + t0 + t] : 0.f;
}

// half v of a lane's run in a row of float32 runs, loaded where it is used:
// a volatile load, so that the compiler keeps no earlier copy of it live
__device__ __forceinline__ float4 lds_half(const float* row, int lane, int v) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"((uint32_t)__cvta_generic_to_shared(row + v * 128 + lane * 4)));
  return r;
}

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A state step of one lane, in three parts. sb_fold: a channel's run from a
// zero state, giving h's pair (prod a = pc, local h) and, folded backwards,
// q's local q (its product of a is pc too); a_t = exp2(dt_t A_j log2 e) once
// per element, kept for the rest of the step, and hv_t = (dt_t x_t) B_t,
// rounded as the forward kernel and the plain version round it.
__device__ __forceinline__ void sb_fold(const float* dtrow, const float (&bv)[SB_RUN],
                                        const float (&cv)[SB_RUN], const float* xrow,
                                        const float* dyrow, float a2, int lane,
                                        float (&a)[SB_RUN], float (&hv)[SB_RUN], float& pc,
                                        float& h, float& ql) {
  pc = 1.f, h = 0.f, ql = 0.f;
  {
    float dt[SB_RUN], xv[SB_RUN];
    ld_run8(dtrow, lane, dt);
    ld_run8(xrow, lane, xv);
#pragma unroll
    for (int r = 0; r < SB_RUN; ++r) {
      a[r] = sc_exp2(dt[r] * a2);
      hv[r] = (dt[r] * xv[r]) * bv[r];
      h = fmaf(a[r], h, hv[r]);
      pc *= a[r];
    }
  }
  float dyv[SB_RUN];
  ld_run8(dyrow, lane, dyv);
#pragma unroll
  for (int r = SB_RUN - 1; r >= 0; --r) ql = a[r] * fmaf(dyv[r], cv[r], ql);
}

// sb_scan: for the lane's two channels at once, inclusive scans of the
// runs' pairs up the warp for h and down it for q, shifted by one run,
// seeded with the chunk's carry h_in and the later chunk's q_after: h at the
// start of the lane's run and q after it. The channels' shuffles
// interleave, so that their latencies overlap.
__device__ __forceinline__ void sb_scan(int lane, const float (&pc)[2], float (&h)[2],
                                        float (&ql)[2], const float (&h_in)[2],
                                        const float (&q_after)[2]) {
  float ua[2] = {pc[0], pc[1]}, da[2] = {pc[0], pc[1]};
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float au = __shfl_up_sync(0xffffffffu, ua[c], o);
      const float bu = __shfl_up_sync(0xffffffffu, h[c], o);
      const float ad = __shfl_down_sync(0xffffffffu, da[c], o);
      const float bd = __shfl_down_sync(0xffffffffu, ql[c], o);
      if (lane >= o) {
        h[c] = fmaf(ua[c], bu, h[c]);
        ua[c] *= au;
      }
      if (lane + o < 32) {
        ql[c] = fmaf(da[c], bd, ql[c]);
        da[c] *= ad;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // the pairs of the runs before and after this one
    float ae = __shfl_up_sync(0xffffffffu, ua[c], 1);
    float be = __shfl_up_sync(0xffffffffu, h[c], 1);
    float fe = __shfl_down_sync(0xffffffffu, da[c], 1);
    float ge = __shfl_down_sync(0xffffffffu, ql[c], 1);
    if (lane == 0) ae = 1.f, be = 0.f;
    if (lane == 31) fe = 1.f, ge = 0.f;
    h[c] = fmaf(ae, h_in[c], be);
    ql[c] = fmaf(fe, q_after[c], ge);
  }
}

// sb_walk2: for the lane's two channels at once (their steps interleaved:
// two independent chains through q), h recomputed along the run from its
// start, then the walk back from q after the run (qn): every g_t. Adds B g
// into dxs0 / dxs1 and A a h_{t-1} g into dda per position; sets db and dc
// to the two channels' x g and dy h; returns q at the run's first position
// (lane 0's: the chunk's) in qn and each channel's sum over the lane's run
// of dt a h_{t-1} g in da0, da1. dt, x and dy are read again half a run at a
// time where they are used, which keeps the kernel within 128 registers.
__device__ __forceinline__ void sb_walk2(const float* dtrow, const float (&bv)[SB_RUN],
                                         const float (&cv)[SB_RUN], const float* x0row,
                                         const float* dy0row, const float* x1row,
                                         const float* dy1row, float A0, float A1, int lane,
                                         const float (&a0)[SB_RUN], float (&hv0)[SB_RUN],
                                         const float (&a1)[SB_RUN], float (&hv1)[SB_RUN],
                                         const float (&h_start)[2], float (&qn)[2],
                                         float (&dxs0)[SB_RUN], float (&dxs1)[SB_RUN],
                                         float (&dda)[SB_RUN], float (&db)[SB_RUN],
                                         float (&dc)[SB_RUN], float& da0, float& da1) {
  float h0 = h_start[0], h1 = h_start[1];
#pragma unroll
  for (int r = 0; r < SB_RUN; ++r) {
    hv0[r] = h0 = fmaf(a0[r], h0, hv0[r]);
    hv1[r] = h1 = fmaf(a1[r], h1, hv1[r]);
  }
  float q0 = qn[0], q1 = qn[1];
  da0 = da1 = 0.f;
#pragma unroll
  for (int v = 1; v >= 0; --v) {
    const float4 dt4 = lds_half(dtrow, lane, v);
    const float4 x04 = lds_half(x0row, lane, v), dy04 = lds_half(dy0row, lane, v);
    const float4 x14 = lds_half(x1row, lane, v), dy14 = lds_half(dy1row, lane, v);
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int r = 4 * v + e;
      const float dtr = f4_at(dt4, e);
      const float y0 = f4_at(dy04, e), y1 = f4_at(dy14, e);
      const float g0 = fmaf(y0, cv[r], q0), g1 = fmaf(y1, cv[r], q1);
      const float w0 = (a0[r] * (r ? hv0[r - 1] : h_start[0])) * g0;
      const float w1 = (a1[r] * (r ? hv1[r - 1] : h_start[1])) * g1;
      q0 = a0[r] * g0;
      q1 = a1[r] * g1;
      dxs0[r] = fmaf(bv[r], g0, dxs0[r]);
      dxs1[r] = fmaf(bv[r], g1, dxs1[r]);
      dda[r] = fmaf(A1, w1, fmaf(A0, w0, dda[r]));
      da0 = fmaf(dtr, w0, da0);
      da1 = fmaf(dtr, w1, da1);
      db[r] = fmaf(f4_at(x14, e), g1, f4_at(x04, e) * g0);
      dc[r] = fmaf(y1, hv1[r], y0 * hv0[r]);
    }
  }
  qn[0] = q0, qn[1] = q1;
}

// What a state step leaves for the next one: its two channels' q at the
// chunk's first position (lane 0's) and their lanes' dA terms, which the
// next step reduces over the warp and stores while its own runs are in
// flight (gcar and sda at ic0, ic1 = channel n + j).
struct SbPending {
  int ic0, ic1;
  float q0, q1, da0, da1;
  __device__ __forceinline__ void out(int lane, float* gcar, float* sda) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      da0 += __shfl_xor_sync(0xffffffffu, da0, o);
      da1 += __shfl_xor_sync(0xffffffffu, da1, o);
    }
    if (lane == 0) {
      gcar[ic0] = q0;
      gcar[ic1] = q1;
      sda[ic0] += da0;
      sda[ic1] += da1;
    }
  }
};

template <typename T, int N>
static __global__ void __launch_bounds__(SB_THREADS, 2) selective_scan_bwd_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ img,
    const float* __restrict__ A, const float* __restrict__ carries, const float* __restrict__ dy,
    const float* __restrict__ dh_final, T* __restrict__ dx, float* __restrict__ part_bc,
    float* __restrict__ part_dt, float* __restrict__ dA_req, float* __restrict__ dh0, int s,
    int d_in, int x_vec) {
  using I = BwdImg<T>;
  using L = BwdSmem<T, N>;
  constexpr int n = N;
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const int n_chunks = (s + SC_CHUNK - 1) / SC_CHUNK, S = n_chunks * SC_CHUNK;
  constexpr int img_bytes = I::bytes(N);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.y, n_b = gridDim.y, cta = blockIdx.x, ch0 = cta * SB_CH;
  unsigned char* im = sc_smem + L::img;
  T* xraw = reinterpret_cast<T*>(sc_smem + L::xraw);
  float* xs = reinterpret_cast<float*>(sc_smem + L::xs);
  float* dys = reinterpret_cast<float*>(sc_smem + L::dys);
  float* acc = reinterpret_cast<float*>(sc_smem + L::acc);
  float* dts = reinterpret_cast<float*>(sc_smem + L::dts);
  float* as_ = reinterpret_cast<float*>(sc_smem + L::as_);
  float* hc = reinterpret_cast<float*>(sc_smem + L::hc);
  float* gcar = reinterpret_cast<float*>(sc_smem + L::gcar);
  float* sda = reinterpret_cast<float*>(sc_smem + L::sda);
  for (int i = tid; i < SB_CH * n; i += SB_THREADS) {
    const int ch = ch0 + i / n, j = i % n;
    const bool live = ch < d_in;
    as_[i] = live ? A[(size_t)ch * n + j] : 0.f;
    gcar[i] = live && dh_final ? dh_final[((size_t)b * d_in + ch) * n + j] : 0.f;
    sda[i] = 0.f;
  }
  const T* xb = x + (size_t)b * s * d_in;
  const float* dyb = dy + (size_t)b * s * d_in;
  T* dxb = dx + (size_t)b * s * d_in;
  const unsigned char* imb = img + (size_t)b * n_chunks * img_bytes;
  float* pbc = part_bc + ((size_t)cta * n_b + b) * 2 * n * S;
  float* pdt = part_dt + ((size_t)cta * n_b + b) * S;
  constexpr int XE = 16 / (int)sizeof(T);        // x values per 16-byte vector
  constexpr int XV = SB_CH / XE;                 // 16-byte vectors per x row
  constexpr int PASSES = SC_CHUNK * SB_CH / SB_THREADS;  // (position, channel) pairs a thread
  // the pair thread tid takes in pass it over a chunk's 256 x 16 values: a
  // warp takes 4 positions x 8 channels, so that its transposed accesses of
  // rows of runs (channel stride 4 mod 32 banks) fall on distinct banks
  auto pair = [&](int it, int& t, int& c) {
    const int unit = it * SB_WARPS + w;
    t = (unit >> 1) * 4 + (lane >> 3);
    c = (unit & 1) * 8 + (lane & 7);
  };
  // chunk k's x rows as they are, its dy transposed into runs and its carries
  auto copy_rows = [&](int k) {
    const int t0 = k * SC_CHUNK;
    if (x_vec) {
#pragma unroll 1
      for (int v = tid; v < SC_CHUNK * XV; v += SB_THREADS) {
        const int t = t0 + v / XV, ch = ch0 + (v % XV) * XE;
        const bool in = t < s && ch < d_in;
        sc_cp16(xraw + v * XE, in ? xb + (size_t)t * d_in + ch : xb, in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < SC_CHUNK * SB_CH; i += SB_THREADS) {
        const int t = t0 + i / SB_CH, ch = ch0 + i % SB_CH;
        xraw[i] = t < s && ch < d_in ? xb[(size_t)t * d_in + ch] : from_f32<T>(0.f);
      }
    }
    float* dk = dys + (k & 1) * SB_CH * SB_LD;
#pragma unroll 1
    for (int it = 0; it < PASSES; ++it) {
      int t, c;
      pair(it, t, c);
      const bool in = t0 + t < s && ch0 + c < d_in;
      sb_cp4(dk + c * SB_LD + sb_pos(t), in ? dyb + (size_t)(t0 + t) * d_in + ch0 + c : dyb, in);
    }
    const float* ck = carries + ((size_t)b * n_chunks + k) * d_in * n + (size_t)ch0 * n;
    float* hk = hc + (k & 1) * SB_CH * n;
#pragma unroll 1
    for (int i = tid; i < SB_CH * n; i += SB_THREADS) {
      const bool in = ch0 + i / n < d_in;
      sb_cp4(hk + i, in ? ck + i : carries, in);
    }
  };
  auto copy_img = [&](int k) {
    const unsigned char* src = imb + (size_t)k * img_bytes;
#pragma unroll 1
    for (int v = tid; v < img_bytes / 16; v += SB_THREADS) sc_cp16(im + 16 * v, src + 16 * v, 16);
  };

  // the rows of dB / dC sums: one a state, and G groups of warps with rows
  // of their own where n < 8; m steps a window
  constexpr int G = N < SB_WARPS ? SB_WARPS / N : 1;
  constexpr int m = N * G / SB_WARPS, wpg = SB_WARPS / G;
  static_assert(N * G == L::ROWS, "a row per state and group");
  const int wl = w % wpg, row0 = (w / wpg) * N;

  copy_img(n_chunks - 1);
  copy_rows(n_chunks - 1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const T* bimg = reinterpret_cast<const T*>(im);
  float dxs0[SB_RUN], dxs1[SB_RUN], dda[SB_RUN];  // per position: sum_j B g (two channels), sum A a h g
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * SC_CHUNK, kb = k & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk k's copies have landed; the later chunk's outputs are read
#pragma unroll 1
    for (int it = 0; it < PASSES; ++it) {
      int t, c;
      pair(it, t, c);
      xs[c * SB_LD + sb_pos(t)] = to_f32(xraw[t * SB_CH + c]);
    }
    dts[tid] = reinterpret_cast<const float*>(im + 2 * I::bc_elems(n) * sizeof(T))[tid];
    __syncthreads();  // x and dt in runs; the x rows' buffer is free
    if (k > 0) {
      copy_rows(k - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const float* dyk = dys + kb * SB_CH * SB_LD;
    const float* hk = hc + kb * SB_CH * n;
#pragma unroll
    for (int r = 0; r < SB_RUN; ++r) dxs0[r] = dxs1[r] = dda[r] = 0.f;
    {
      SbPending pend;
#pragma unroll 1
      for (int i = 0; i < N; ++i) {
        const int j = (i + m * wl) & (N - 1);
        // the previous step's outputs; every lane has read its q_after
        if (i) pend.out(lane, gcar, sda);
        float bv[SB_RUN], cv[SB_RUN], db[SB_RUN], dc[SB_RUN];
        ld_img_run8<T>(bimg + j * SC_CHUNK, lane, bv);
        ld_img_run8<T>(bimg + (n + j) * SC_CHUNK, lane, cv);
        const int c0 = 2 * w, c1 = c0 + 1;
        float a0[SB_RUN], hv0[SB_RUN], a1[SB_RUN], hv1[SB_RUN], pc[2], h[2], q[2], da0, da1;
        const float A0 = as_[c0 * n + j], A1 = as_[c1 * n + j];
        sb_fold(dts, bv, cv, xs + c0 * SB_LD, dyk + c0 * SB_LD, A0 * SC_LOG2E, lane, a0, hv0,
                pc[0], h[0], q[0]);
        sb_fold(dts, bv, cv, xs + c1 * SB_LD, dyk + c1 * SB_LD, A1 * SC_LOG2E, lane, a1, hv1,
                pc[1], h[1], q[1]);
        sb_scan(lane, pc, h, q, {hk[c0 * n + j], hk[c1 * n + j]},
                {gcar[c0 * n + j], gcar[c1 * n + j]});
        sb_walk2(dts, bv, cv, xs + c0 * SB_LD, dyk + c0 * SB_LD, xs + c1 * SB_LD,
                 dyk + c1 * SB_LD, A0, A1, lane, a0, hv0, a1, hv1, h, q, dxs0, dxs1, dda, db, dc,
                 da0, da1);
        pend = {c0 * n + j, c1 * n + j, q[0], q[1], da0, da1};
        {  // u g = dt (x g)
          float dt[SB_RUN];
          ld_run8(dts, lane, dt);
#pragma unroll
          for (int r = 0; r < SB_RUN; ++r) db[r] *= dt[r];
        }
        float* ra = acc + (row0 + j) * 2 * SC_CHUNK;
        if (i < m) {  // the window that first takes each row
          st_run8(ra, lane, db);
          st_run8(ra + SC_CHUNK, lane, dc);
        } else {
          float o[SB_RUN];
          ld_run8(ra, lane, o);
#pragma unroll
          for (int r = 0; r < SB_RUN; ++r) o[r] += db[r];
          st_run8(ra, lane, o);
          ld_run8(ra + SC_CHUNK, lane, o);
#pragma unroll
          for (int r = 0; r < SB_RUN; ++r) o[r] += dc[r];
          st_run8(ra + SC_CHUNK, lane, o);
        }
        if (i % m == m - 1) __syncthreads();  // the window's rows are in
      }
      pend.out(lane, gcar, sda);
    }
    // every warp is done with the image: chunk k - 1's goes in while this one ends
    if (k > 0) {
      copy_img(k - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    {  // dx = dt sum_j B g into this chunk's dy runs, ddt's warp sums over
       // channel 2w's x run (the lane reads both before it writes)
      float dt[SB_RUN], x0[SB_RUN], x1[SB_RUN], dd[SB_RUN];
      ld_run8(dts, lane, dt);
      ld_run8(xs + 2 * w * SB_LD, lane, x0);
      ld_run8(xs + (2 * w + 1) * SB_LD, lane, x1);
#pragma unroll
      for (int r = 0; r < SB_RUN; ++r) {
        dd[r] = fmaf(x0[r], dxs0[r], fmaf(x1[r], dxs1[r], dda[r]));
        dxs0[r] *= dt[r];
        dxs1[r] *= dt[r];
      }
      float* dxk = dys + kb * SB_CH * SB_LD;
      st_run8(dxk + 2 * w * SB_LD, lane, dxs0);
      st_run8(dxk + (2 * w + 1) * SB_LD, lane, dxs1);
      st_run8(xs + 2 * w * SB_LD, lane, dd);
    }
    {  // the chunk's rows (the G groups' added in group order) into the partial
      const float4* a4 = reinterpret_cast<const float4*>(acc);
#pragma unroll 1
      for (int i = tid; i < N * 2 * (SC_CHUNK / 4); i += SB_THREADS) {
        const int j = i / (SC_CHUNK / 2), q = (i / (SC_CHUNK / 4)) & 1, f = i % (SC_CHUNK / 4);
        float4 sum = a4[(j * 2 + q) * (SC_CHUNK / 4) + f];
        for (int g = 1; g < G; ++g) {
          const float4 o = a4[((g * N + j) * 2 + q) * (SC_CHUNK / 4) + f];
          sum.x += o.x, sum.y += o.y, sum.z += o.z, sum.w += o.w;
        }
        const int t = (f & 31) * SB_RUN + (f >> 5) * 4;  // f = v * 32 + lane
        *reinterpret_cast<float4*>(pbc + (size_t)(q * n + j) * S + t0 + t) = sum;
      }
    }
    __syncthreads();  // dx and ddt's warp sums are in
    {
      const int p = sb_pos(tid);
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < SB_WARPS; ++v) sum += xs[2 * v * SB_LD + p];
      pdt[t0 + tid] = sum;
    }
    const float* dxk = dys + kb * SB_CH * SB_LD;
#pragma unroll 1
    for (int it = 0; it < PASSES; ++it) {
      int t, c;
      pair(it, t, c);
      if (t0 + t < s && ch0 + c < d_in)
        dxb[(size_t)(t0 + t) * d_in + ch0 + c] = from_f32<T>(dxk[c * SB_LD + sb_pos(t)]);
    }
  }
  __syncthreads();
  for (int i = tid; i < SB_CH * n; i += SB_THREADS) {
    const int ch = ch0 + i / n;
    if (ch < d_in) {
      const size_t o = ((size_t)b * d_in + ch) * n + i % n;
      dh0[o] = gcar[i];
      dA_req[o] = sda[i];
    }
  }
}

// The sums over CTAs (dB, dC, ddt: four positions a thread; in blocks of 16
// CTAs, then over the blocks, which keeps the rounding error of a sum over
// hundreds of partials near that of one over tens) and over requests (dA),
// each in index order. blockIdx.y: 0 dB and dC (rounded to
// T), 1 ddt, 2 dA (float32). The partials' rows are S = s rounded up to
// whole chunks long; positions past s are not read.
template <typename T>
static __global__ void __launch_bounds__(256) selective_scan_bwd_reduce_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_dt,
    const float* __restrict__ dA_req, T* __restrict__ dB, T* __restrict__ dC,
    float* __restrict__ ddt, float* __restrict__ dA, int n_cta, int n_b, int s, int d_in,
    int n) {
  const int S = (s + SC_CHUNK - 1) / SC_CHUNK * SC_CHUNK;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y < 2) {
    const size_t per_cta = (size_t)n_b * (blockIdx.y == 0 ? 2 * n : 1) * S / 4;  // float4s
    const float4* p4 = reinterpret_cast<const float4*>(blockIdx.y == 0 ? part_bc : part_dt);
    for (size_t i = i0; i < per_cta; i += stride) {
      const size_t t = i * 4 % S, row = i * 4 / S;
      if (t >= (size_t)s) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int v0 = 0; v0 < n_cta; v0 += 16) {  // blocks of 16 CTAs, then the blocks
        float4 blk = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int v = v0; v < min(v0 + 16, n_cta); ++v) {
          const float4 o = p4[v * per_cta + i];
          blk.x += o.x, blk.y += o.y, blk.z += o.z, blk.w += o.w;
        }
        sum.x += blk.x, sum.y += blk.y, sum.z += blk.z, sum.w += blk.w;
      }
      const float e[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int u = 0; u < 4 && t + u < (size_t)s; ++u) {
        if (blockIdx.y == 1) {
          ddt[row * s + t + u] = e[u];
        } else {
          const size_t qj = row % (2 * n), bb = row / (2 * n);
          T* out = qj < (size_t)n ? dB : dC;
          out[(bb * s + t + u) * n + qj % n] = from_f32<T>(e[u]);
        }
      }
    }
  } else {
    const size_t per_b = (size_t)d_in * n;
    for (size_t i = i0; i < per_b; i += stride) {
      float sum = 0.f;
      for (int v = 0; v < n_b; ++v) sum += dA_req[v * per_b + i];
      dA[i] = sum;
    }
  }
}

template <typename T>
static size_t scan_bwd_scratch_bytes(int b, int s, int n) {
  return (size_t)b * ((s + SC_CHUNK - 1) / SC_CHUNK) * BwdImg<T>::bytes(n);
}

// floats of the backward's workspace: dB and dC partials (cta, b, 2, n, S),
// ddt partials (cta, b, S), dA per request (b, d_in, n)
static size_t scan_bwd_work_floats(int b, int s, int d_in, int n) {
  const size_t n_cta = (d_in + SB_CH - 1) / SB_CH;
  const size_t S = (size_t)(s + SC_CHUNK - 1) / SC_CHUNK * SC_CHUNK;
  return n_cta * b * ((size_t)2 * n * S + S) + (size_t)b * d_in * n;
}

// calls f with the kernel instance of state size n (a power of two, 2 .. 32)
template <typename T, typename F>
static cudaError_t with_bwd_kernel(int n, F&& f) {
  switch (n) {
    case 2: return f(selective_scan_bwd_kernel<T, 2>, BwdSmem<T, 2>::total);
    case 4: return f(selective_scan_bwd_kernel<T, 4>, BwdSmem<T, 4>::total);
    case 8: return f(selective_scan_bwd_kernel<T, 8>, BwdSmem<T, 8>::total);
    case 16: return f(selective_scan_bwd_kernel<T, 16>, BwdSmem<T, 16>::total);
    case 32: return f(selective_scan_bwd_kernel<T, 32>, BwdSmem<T, 32>::total);
    default: return cudaErrorInvalidValue;
  }
}

// each backward kernel instance's shared memory opt-in and a carveout of all
// shared memory, once per device
template <typename T>
static cudaError_t bwd_prepare() {
  static OncePerDevice once;
  return once([] {
    for (int n = 2; n <= 32; n *= 2) {
      const cudaError_t e = with_bwd_kernel<T>(n, [](auto kernel, int smem) {
        const cudaError_t a =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (a != cudaSuccess) return a;
        return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
      });
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
}

template <typename T>
static int bwd_ctas_per_sm(int n) {
  if (bwd_prepare<T>() != cudaSuccess) return -1;
  int blocks = -1;
  const cudaError_t e = with_bwd_kernel<T>(n, [&](auto kernel, int smem) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, SB_THREADS, smem);
  });
  return e == cudaSuccess ? blocks : -1;
}

template <typename T>
static cudaError_t launch_scan_bwd(const void* x, const float* dt, const float* A,
                                   const void* Bm, const void* Cm, const float* carries,
                                   const float* dy, const float* dh_final, void* dx, void* dB,
                                   void* dC, float* ddt, float* dA, float* dh0, void* scratch,
                                   float* work, int b, int s, int d_in, int n, int b_sb, int b_ss,
                                   int c_sb, int c_ss, cudaStream_t st) {
  const cudaError_t attr = bwd_prepare<T>();
  if (attr != cudaSuccess) return attr;
  const int n_chunks = (s + SC_CHUNK - 1) / SC_CHUNK, n_cta = (d_in + SB_CH - 1) / SB_CH;
  const size_t S = (size_t)n_chunks * SC_CHUNK;
  selective_scan_bwd_pack_kernel<T><<<dim3(n_chunks, b), 256, 0, st>>>(
      (const T*)Bm, (const T*)Cm, dt, (unsigned char*)scratch, s, n, b_sb, b_ss, c_sb, c_ss);
  float* part_bc = work;
  float* part_dt = part_bc + (size_t)n_cta * b * 2 * n * S;
  float* dA_req = part_dt + (size_t)n_cta * b * S;
  const int x_vec = d_in % (16 / (int)sizeof(T)) == 0;
  const cudaError_t e = with_bwd_kernel<T>(n, [&](auto kernel, int smem) {
    kernel<<<dim3(n_cta, b), SB_THREADS, smem, st>>>(
        (const T*)x, (const unsigned char*)scratch, A, carries, dy, dh_final, (T*)dx, part_bc,
        part_dt, dA_req, dh0, s, d_in, x_vec);
    return cudaSuccess;
  });
  if (e != cudaSuccess) return e;
  selective_scan_bwd_reduce_kernel<T><<<dim3(264, 3), 256, 0, st>>>(
      part_bc, part_dt, dA_req, (T*)dB, (T*)dC, ddt, dA, n_cta, b, s, d_in, n);
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

// Floats of the workspace the backward needs (its per-CTA partials).
extern "C" long long ckv_selective_scan_bwd_work_floats(int b, int s, int d_in, int n) {
  return (long long)ckv::scan_bwd_work_floats(b, s, d_in, n);
}

// Device bytes of the scratch the backward needs (its chunk images).
extern "C" long long ckv_selective_scan_bwd_scratch(int b, int s, int n, int dtype) {
  switch (dtype) {
    case ckv::F32:
      return (long long)ckv::scan_bwd_scratch_bytes<float>(b, s, n);
    case ckv::BF16:
      return (long long)ckv::scan_bwd_scratch_bytes<__nv_bfloat16>(b, s, n);
    case ckv::F16:
      return (long long)ckv::scan_bwd_scratch_bytes<__half>(b, s, n);
    default:
      return -1;
  }
}

// CTAs an SM of the backward kernel at state size n and dtype, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them on the current
// device (-1 on an error).
extern "C" long long ckv_selective_scan_bwd_occupancy(int n, int dtype) {
  if (n < 2 || n > 32 || (n & (n - 1))) return -1;
  switch (dtype) {
    case ckv::F32:
      return ckv::bwd_ctas_per_sm<float>(n);
    case ckv::BF16:
      return ckv::bwd_ctas_per_sm<__nv_bfloat16>(n);
    case ckv::F16:
      return ckv::bwd_ctas_per_sm<__half>(n);
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
// carries (chunked only, else null): (b, ceil(s / 256), d_in, n) float32,
// h at the start of every 256-position chunk, for the backward.
extern "C" int ckv_selective_scan(const void* x, const float* dt, const float* A, const void* Bm,
                                  const void* Cm, const float* h0, float* y, float* h_out,
                                  float* carries, void* scratch, int b, int s, int d_in, int n,
                                  int b_sb, int b_ss, int c_sb, int c_ss, int dtype, int variant,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 2 || n > 32 || (n & (n - 1)) || variant < 0 || variant > 1 ||
      (variant == 1 && !scratch) || (variant == 0 && carries))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return variant == 1
               ? ckv::launch_scan_chunked<T>(x, dt, A, Bm, Cm, h0, y, h_out, carries, scratch, b,
                                             s, d_in, n, b_sb, b_ss, c_sb, c_ss, st)
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

// The backward of ckv_selective_scan at output gradients dy (b, s, d_in)
// float32 contiguous and dh_final (b, d_in, n) float32 or null for zeros,
// from the forward's inputs (x, dt, A, B, C as ckv_selective_scan takes
// them) and its carries (b, ceil(s / 256), d_in, n) float32: h at the start
// of every chunk, h0 or zeros at the first. Out: dx (b, s, d_in) in x's
// dtype, dB and dC (b, s, n) contiguous in x's dtype, ddt (b, s), dA
// (d_in, n) and dh0 (b, d_in, n) float32. scratch:
// ckv_selective_scan_bwd_scratch bytes (16-byte aligned); work:
// ckv_selective_scan_bwd_work_floats floats (16-byte aligned). Three
// launches: the backward's pack, the backward and the reduction over CTAs.
extern "C" int ckv_selective_scan_bwd(const void* x, const float* dt, const float* A,
                                      const void* Bm, const void* Cm, const float* carries,
                                      const float* dy, const float* dh_final, void* dx, void* dB,
                                      void* dC, float* ddt, float* dA, float* dh0, void* scratch,
                                      float* work, int b, int s, int d_in, int n, int b_sb,
                                      int b_ss, int c_sb, int c_ss, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 2 || n > 32 || (n & (n - 1)) || !scratch || !work || !carries || b < 1 || s < 1 ||
      d_in < 1)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return ckv::launch_scan_bwd<T>(x, dt, A, Bm, Cm, carries, dy, dh_final, dx, dB, dC, ddt, dA,
                                   dh0, scratch, work, b, s, d_in, n, b_sb, b_ss, c_sb, c_ss, st);
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
