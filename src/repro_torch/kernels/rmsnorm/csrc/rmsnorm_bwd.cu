// The backward of the fused RMSNorm, by hand for Hopper.
//
// Computes the gradient of the port's forward (rmsnorm.cu), which replaces
// the Pallas TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_fused
// (body _rmsnorm_kernel): y = x * r * gamma with r = rsqrt(mean(x^2) + eps),
// all in float32.  Given dy, in float32:
//
//   dx     = r * (gamma * dy) - x * r^3 * mean(x * gamma * dy), cast to x's
//            dtype;
//   dgamma = sum over rows of dy * x * r, cast to gamma's dtype.
//
// The TPU kernel has no backward (the reference trains through jax.grad of a
// plain norm); the port's models call the kernel, so its gradient is a kernel
// too.
//
// Design.  Two launches, no atomics, deterministic.  The row kernel takes
// one of three routes, picked per call by rmsnorm_bwd_route():
//   register  (rmsnorm_bwd_regs; the forward's register route) rows of at
//             most kMaxVectors 16-byte vectors a lane (D <= 2,048 in bf16,
//             <= 1,024 in float32) with D a multiple of the vector and x,
//             gamma, dy and dx 16-byte aligned.  One warp per row: a lane
//             issues its kV vector loads of x and dy (at [4096, 1536] in
//             bf16, 6 each) before any arithmetic, sums x^2 and
//             x * gamma * dy, folds both with shuffles (no barrier), and
//             writes dx as 16-byte vectors from the registers.  gamma is
//             converted to float32 into shared memory once per block.  A
//             lane adds dy * x * r for its fixed columns into its warp's row
//             of float32 partials in shared memory across the rows its warp
//             walks (rows r0 + warp, r0 + warp + 8, ... of its block's
//             chunk); at the end the block adds its 8 warp rows in warp order
//             and writes the sum to row blockIdx of the [blocks, D] scratch.
//             Blocks of 8 warps, two an SM (at most 128 registers a
//             thread; at 85, for three, ptxas spilled), each warp walking
//             the same number of rows (the wrapper's count: two at
//             [4096, 1536]).
//   wide      (rmsnorm_bwd_wide) the same alignment and D, past the register
//             route, up to kWideMaxWarps * 32 * 4 vectors (D <= 16,384 in
//             bf16, <= 8,192 in float32).  One block walks a contiguous
//             chunk of rows, one row at a time, each thread holding kV = 2
//             (up to 512 vectors a row) or 4 vectors of the row (vectors t,
//             t + T, ... for thread t of T = 32 * ceil(vectors / (32 kV)):
//             7 warps at zamba2-7b's 3584 and 7168 in bf16).  A thread loads
//             its x and dy vectors before any arithmetic, and issues the next
//             row's loads into a second set of registers once its two sums
//             are formed, so they are in flight through the barrier and the
//             dx stores.  The block folds both sums in one fixed order
//             (shuffles, then the warps' sums from double-buffered shared
//             memory in warp order: one barrier a row).  gamma is staged once
//             a block as float32 in shared memory, laid out [kN / 4][vectors]
//             float4s so that neighbouring threads read neighbouring 16
//             bytes.  dx is written as 16-byte vectors.  A thread's dgamma
//             partials (kV * kN floats, its fixed columns) stay in registers
//             across its rows and are written once, as float4s, to row
//             blockIdx of the scratch.  The wrapper sizes the grid (two blocks
//             an SM: 256 blocks and 7.3 MB of scratch at [4096, 7168]).
//   generic   (rmsnorm_bwd_rows) everything else (unaligned tensors, D not a
//             multiple of the vector, or wider than the wide route): one block
//             of 256 threads per contiguous chunk of rows; the block walks
//             its rows one at a time.  A thread owns columns t, t + 256, ...:
//             it reads x, dy and gamma there, sums x^2 and x * gamma * dy, the
//             block folds both sums (shuffles, then the 8 warp sums in a
//             fixed order from shared memory, double-buffered so one barrier
//             a row does), recomputes r as the forward does and writes dx.
//             The second read of the row is the thread's own values, served
//             from L1.  Each thread adds dy * x * r into its columns of the
//             block's float32 partial dgamma in shared memory (its own
//             columns only, so no barrier or atomic), and writes them to row
//             blockIdx of the scratch at the end.
//   rmsnorm_bwd_gamma  sums the scratch over the blocks and writes dgamma: a
//                      block per 32 columns, its 32 warps each summing every
//                      32nd partial row, then the 32 sums in warp order.
// The forward stays as it was: r is recomputed, not saved.  The routes form
// r and dx alike but sum in other orders (so compare each only with the
// plain version); each is the same bits from run to run.
//
// Bound on an H100 SXM: memory.  The function must read x and dy and write dx
// (gamma and dgamma are one row each): at the qwen2-1.5b train step's
// [4096, 1536] in bf16, 3 * 12.58 MB = 37.7 MB, 11.3 us at 3.35 TB/s; at
// zamba2-7b's [4096, 3584] and [4096, 7168], 88.1 and 176.2 MB, 26.30 and
// 52.59 us.  About 8 flops an element, far below any peak.  The generic route
// pays scalar (2-byte) loads and a barrier per row; the vector routes read
// each byte once in 16-byte vectors, and their scratch is one float32 row a
// block (256 x 1536 = 1.6 MB at the qwen2 step, 256 x 7168 = 7.3 MB at
// zamba2's widest, mostly in L2), written once and read once.

// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing (the wrapper allocates dx, dgamma and the
// scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVectors = 8;         // register route: vectors per lane
constexpr int kWideMaxWarps = 16;      // wide route: warps a block, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Register route: one warp per row, kV vectors of kN values a lane.  x and
// dy stay in registers; gamma, converted to float32 once per block, and the
// warps' dgamma partials (a row each) live in shared memory, so a thread
// needs at most 128 registers: two blocks an SM.  The block folds its
// warps' partials in warp order at the end.
template <typename TX, typename TG, int kV>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_bwd_regs(const TX* __restrict__ x, const TG* __restrict__ gamma,
                 const TX* __restrict__ dy, TX* __restrict__ dx,
                 float* __restrict__ part, long long rows, int d, float eps) {
  extern __shared__ float4 smem4[];      // gamma [d], then [kWarps][d] dgamma
  constexpr int kN = 16 / sizeof(TX);            // values per 16-byte vector
  constexpr int kQ = kN / 4;                     // float4s per vector
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_vec = d / kN;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  const float inv_d = 1.0f / (float)d;
  float* sg = reinterpret_cast<float*>(smem4);
  const float4* g4 = smem4;
  float4* mine = smem4 + (long long)(1 + warp) * (d / 4);
  for (int i = threadIdx.x; i < d; i += kThreads) sg[i] = to_f32(gamma[i]);
  __syncthreads();

  bool first = true;
  for (long long row = r0 + warp; row < r1; row += kWarps) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* yv = reinterpret_cast<const uint4*>(dy + row * d);
    uint4 xr[kV], yr[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {          // every load before any arithmetic
      const int v = lane + 32 * j;
      if (v < n_vec) {
        xr[j] = xv[v];
        yr[j] = yv[v];
      }
    }
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = lane + 32 * j;
      if (v < n_vec) {
        const TX* a = reinterpret_cast<const TX*>(&xr[j]);
        const TX* b = reinterpret_cast<const TX*>(&yr[j]);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 g = g4[v * kQ + q];
          const float gk[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xf = to_f32(a[4 * q + e]);
            ss += xf * xf;
            dot += xf * (gk[e] * to_f32(b[4 * q + e]));
          }
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = dot * inv_d * r * r * r;
    uint4* dv = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = lane + 32 * j;
      if (v < n_vec) {
        const TX* a = reinterpret_cast<const TX*>(&xr[j]);
        const TX* b = reinterpret_cast<const TX*>(&yr[j]);
        uint4 packed;
        TX* out = reinterpret_cast<TX*>(&packed);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 g = g4[v * kQ + q];
          const float gk[4] = {g.x, g.y, g.z, g.w};
          float dg[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xf = to_f32(a[4 * q + e]), yf = to_f32(b[4 * q + e]);
            out[4 * q + e] = from_f32<TX>(r * (gk[e] * yf) - xf * c);
            dg[e] = yf * (xf * r);
          }
          float4* at = mine + v * kQ + q;    // this lane's columns only
          float4 s4 = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *at;
          s4.x += dg[0];
          s4.y += dg[1];
          s4.z += dg[2];
          s4.w += dg[3];
          *at = s4;
        }
        dv[v] = packed;
      }
    }
    first = false;
  }
  if (first) {                              // a warp without rows adds zeros
    for (int i = lane; i < d / 4; i += 32)
      mine[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  // the warps' partials, added in warp order
  const float* sdg = sg + d;
  float* pr = part + (long long)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float t = sdg[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += sdg[(long long)w * d + i];
    pr[i] = t;
  }
}

// Wide route: a block walks its chunk of rows one at a time, kV vectors of
// kN values a thread, the next row's vectors loaded while this one is
// folded and written; dgamma partials of the thread's columns in registers.
template <typename TX, typename TG, int kV>
__global__ void __launch_bounds__(32 * kWideMaxWarps)
rmsnorm_bwd_wide(const TX* __restrict__ x, const TG* __restrict__ gamma,
                 const TX* __restrict__ dy, TX* __restrict__ dx,
                 float* __restrict__ part, long long rows, int d, float eps) {
  extern __shared__ float4 sg4[];        // gamma, [kQ][n_vec] float4s
  __shared__ float red[2][kWideMaxWarps][2];     // double-buffered sums
  constexpr int kN = 16 / sizeof(TX);            // values per 16-byte vector
  constexpr int kQ = kN / 4;                     // float4s per vector
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_threads = blockDim.x, warps = n_threads >> 5;
  const int n_vec = d / kN;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  const float inv_d = 1.0f / (float)d;

  uint4 xa[kV], ya[kV];                  // the first row's loads go out first
  if (r0 < r1) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + r0 * d);
    const uint4* yv = reinterpret_cast<const uint4*>(dy + r0 * d);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = t + n_threads * j;
      if (v < n_vec) {
        xa[j] = xv[v];
        ya[j] = yv[v];
      }
    }
  }
  float* sg = reinterpret_cast<float*>(sg4);
  for (int i = t; i < d; i += n_threads) {
    const int v = i / kN, k = i - v * kN;
    sg[4 * ((k >> 2) * n_vec + v) + (k & 3)] = to_f32(gamma[i]);
  }
  float dg[kV][kN];
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int k = 0; k < kN; ++k) dg[j][k] = 0.0f;
  __syncthreads();                               // gamma staged

  int buf = 0;
  for (long long row = r0; row < r1; ++row, buf ^= 1) {
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = t + n_threads * j;
      if (v < n_vec) {
        const TX* a = reinterpret_cast<const TX*>(&xa[j]);
        const TX* b = reinterpret_cast<const TX*>(&ya[j]);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 g = sg4[q * n_vec + v];
          const float gk[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xf = to_f32(a[4 * q + e]);
            ss += xf * xf;
            dot += xf * (gk[e] * to_f32(b[4 * q + e]));
          }
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      red[buf][warp][0] = ss;
      red[buf][warp][1] = dot;
    }
    // the next row's loads, in flight through the barrier and the stores
    const bool more = row + 1 < r1;
    uint4 xb[kV], yb[kV];
    if (more) {
      const uint4* xv = reinterpret_cast<const uint4*>(x + (row + 1) * d);
      const uint4* yv = reinterpret_cast<const uint4*>(dy + (row + 1) * d);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int v = t + n_threads * j;
        if (v < n_vec) {
          xb[j] = xv[v];
          yb[j] = yv[v];
        }
      }
    }
    __syncthreads();
    ss = 0.0f;
    dot = 0.0f;
    for (int w = 0; w < warps; ++w) {            // warp order
      ss += red[buf][w][0];
      dot += red[buf][w][1];
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = dot * inv_d * r * r * r;
    uint4* dv = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = t + n_threads * j;
      if (v < n_vec) {
        const TX* a = reinterpret_cast<const TX*>(&xa[j]);
        const TX* b = reinterpret_cast<const TX*>(&ya[j]);
        uint4 packed;
        TX* o = reinterpret_cast<TX*>(&packed);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 g = sg4[q * n_vec + v];
          const float gk[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xf = to_f32(a[4 * q + e]), yf = to_f32(b[4 * q + e]);
            o[4 * q + e] = from_f32<TX>(r * (gk[e] * yf) - xf * c);
            dg[j][4 * q + e] += yf * (xf * r);
          }
        }
        dv[v] = packed;
      }
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        xa[j] = xb[j];
        ya[j] = yb[j];
      }
    }
  }
  float4* pr = reinterpret_cast<float4*>(part + (long long)blockIdx.x * d);
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int v = t + n_threads * j;
    if (v < n_vec) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        pr[v * kQ + q] = make_float4(dg[j][4 * q], dg[j][4 * q + 1],
                                     dg[j][4 * q + 2], dg[j][4 * q + 3]);
    }
  }
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows(const TX* __restrict__ x, const TG* __restrict__ gamma,
                 const TX* __restrict__ dy, TX* __restrict__ dx,
                 float* __restrict__ part, long long rows, int d, float eps) {
  extern __shared__ float sdg[];                 // [d] partial dgamma
  __shared__ float red[2][kWarps][2];            // double-buffered sums
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < d; i += kThreads) sdg[i] = 0.0f;

  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  const float inv_d = 1.0f / (float)d;
  int buf = 0;
  for (long long row = r0; row < r1; ++row, buf ^= 1) {
    const TX* xr = x + row * d;
    const TX* gr = dy + row * d;
    float ss = 0.0f, dot = 0.0f;
    for (int i = t; i < d; i += kThreads) {
      const float xv = to_f32(xr[i]);
      ss += xv * xv;
      dot += xv * (to_f32(gamma[i]) * to_f32(gr[i]));
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      red[buf][warp][0] = ss;
      red[buf][warp][1] = dot;
    }
    __syncthreads();
    ss = 0.0f;
    dot = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ss += red[buf][w][0];
      dot += red[buf][w][1];
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = dot * inv_d * r * r * r;
    TX* dxr = dx + row * d;
    for (int i = t; i < d; i += kThreads) {
      const float xv = to_f32(xr[i]), dyv = to_f32(gr[i]);
      dxr[i] = from_f32<TX>(r * (to_f32(gamma[i]) * dyv) - xv * c);
      sdg[i] += dyv * (xv * r);
    }
  }
  float* pr = part + (long long)blockIdx.x * d;
  for (int i = t; i < d; i += kThreads) pr[i] = sdg[i];
}

// dgamma[i] = sum over the blocks' partial rows of column i: a block of 32
// warps per 32 columns, warp w summing partial rows w, w + 32, ..., then the
// 32 warp sums added in warp order; a fixed order, so the same bits every run
constexpr int kGammaWarps = 32;

template <typename TG>
__global__ void __launch_bounds__(32 * kGammaWarps)
rmsnorm_bwd_gamma(const float* __restrict__ part, TG* __restrict__ dgamma,
                  int blocks, int d) {
  __shared__ float red[kGammaWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (i < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kGammaWarps)
      s += part[(long long)b * d + i];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < d) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kGammaWarps; ++w) t += red[w][lane];
    dgamma[i] = from_f32<TG>(t);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

enum Route { kGeneric = 0, kRegister = 1, kWide = 2 };

// The route for rows of d values of x_bytes each at these pointers, and
// through *kv its vectors per lane (register) or per thread (wide), 0 on the
// generic route.
Route pick(const void* x, const void* gamma, const void* dy, const void* dx,
           int d, int x_bytes, int* kv) {
  const int n = 16 / x_bytes;
  *kv = 0;
  if (d % n != 0 || !aligned16(x) || !aligned16(gamma) || !aligned16(dy) ||
      !aligned16(dx))
    return kGeneric;
  const int n_vec = d / n;
  if (n_vec <= 32 * kMaxVectors) {
    *kv = (n_vec + 31) / 32;
    return kRegister;
  }
  if (n_vec > 32 * kWideMaxWarps * 4) return kGeneric;
  *kv = n_vec <= 32 * 8 * 2 ? 2 : 4;     // 2 a thread up to 8 warps' worth
  return kWide;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename TX, typename TG, int kV>
cudaError_t launch_regs(const void* x, const void* gamma, const void* dy,
                        void* dx, void* part, long long rows, int d,
                        float eps, int blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (1 + kWarps) * (size_t)d;
  const cudaError_t err = allow_smem(rmsnorm_bwd_regs<TX, TG, kV>, bytes);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_regs<TX, TG, kV><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(gamma),
      static_cast<const TX*>(dy), static_cast<TX*>(dx),
      static_cast<float*>(part), rows, d, eps);
  return cudaGetLastError();
}

template <typename TX, typename TG, int kV>
cudaError_t launch_wide(const void* x, const void* gamma, const void* dy,
                        void* dx, void* part, long long rows, int d,
                        float eps, int blocks, cudaStream_t stream) {
  const int n_vec = d / (16 / (int)sizeof(TX));
  const int threads = 32 * ((n_vec + 32 * kV - 1) / (32 * kV));
  const size_t bytes = sizeof(float) * (size_t)d;
  const cudaError_t err = allow_smem(rmsnorm_bwd_wide<TX, TG, kV>, bytes);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_wide<TX, TG, kV><<<blocks, threads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(gamma),
      static_cast<const TX*>(dy), static_cast<TX*>(dx),
      static_cast<float*>(part), rows, d, eps);
  return cudaGetLastError();
}

template <typename TX, typename TG>
int launch(const void* x, const void* gamma, const void* dy, void* dx,
           void* dgamma, void* part, long long rows, int d, float eps,
           int blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)d;
  int kv;
  const Route route = pick(x, gamma, dy, dx, d, sizeof(TX), &kv);
  cudaError_t err;
  if (route == kWide) {
    err = kv == 2 ? launch_wide<TX, TG, 2>(x, gamma, dy, dx, part, rows, d,
                                           eps, blocks, stream)
                  : launch_wide<TX, TG, 4>(x, gamma, dy, dx, part, rows, d,
                                           eps, blocks, stream);
  } else {
    switch (kv) {
#define RMS_BWD_REGS(KV)                                                    \
  case KV:                                                                  \
    err = launch_regs<TX, TG, KV>(x, gamma, dy, dx, part, rows, d, eps,     \
                                  blocks, stream);                          \
    break;
      RMS_BWD_REGS(1) RMS_BWD_REGS(2) RMS_BWD_REGS(3) RMS_BWD_REGS(4)
      RMS_BWD_REGS(5) RMS_BWD_REGS(6) RMS_BWD_REGS(7) RMS_BWD_REGS(8)
#undef RMS_BWD_REGS
      default:
        err = allow_smem(rmsnorm_bwd_rows<TX, TG>, bytes);
        if (err != cudaSuccess) return (int)err;
        rmsnorm_bwd_rows<TX, TG><<<blocks, kThreads, bytes, stream>>>(
            static_cast<const TX*>(x), static_cast<const TG*>(gamma),
            static_cast<const TX*>(dy), static_cast<TX*>(dx),
            static_cast<float*>(part), rows, d, eps);
        err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_gamma<TG><<<(d + 31) / 32, 32 * kGammaWarps, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TG*>(dgamma), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: [rows, d] of float32 (x_bf16 == 0) or bf16; gamma, dgamma: [d]
// of float32 (g_bf16 == 0) or bf16; part: float32 scratch [blocks, d] with
// 1 <= blocks <= rows (any such count works on every route; the wrapper
// picks it by rmsnorm_bwd_route).  d * 4 bytes of shared memory a block:
// d <= 56,000.
extern "C" int rmsnorm_bwd(const void* x, const void* gamma, const void* dy,
                           void* dx, void* dgamma, void* part,
                           long long rows, int d, float eps, int x_bf16,
                           int g_bf16, int blocks, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || d > 56000 || blocks < 1 || blocks > rows)
    return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    return g_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                        x, gamma, dy, dx, dgamma, part, rows, d, eps, blocks,
                        stream)
                  : launch<__nv_bfloat16, float>(x, gamma, dy, dx, dgamma,
                                                 part, rows, d, eps, blocks,
                                                 stream);
  }
  return g_bf16 ? launch<float, __nv_bfloat16>(x, gamma, dy, dx, dgamma, part,
                                               rows, d, eps, blocks, stream)
                : launch<float, float>(x, gamma, dy, dx, dgamma, part, rows,
                                       d, eps, blocks, stream);
}

// The route rmsnorm_bwd() takes for these arguments, launching nothing:
// 256 * route + vectors, where route is 0 (generic), 1 (register) or 2 (wide)
// and vectors are the register route's per lane or the wide route's per
// thread (0 on the generic route).  dx may be NULL, which counts as aligned
// (as the allocator's outputs are).
extern "C" int rmsnorm_bwd_route(const void* x, const void* gamma,
                                 const void* dy, const void* dx, int d,
                                 int x_bf16) {
  if (d <= 0) return 0;
  int kv;
  const Route route = pick(x, gamma, dy, dx, d, x_bf16 ? 2 : 4, &kv);
  return 256 * route + kv;
}
