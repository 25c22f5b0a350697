// Fused RMSNorm, by hand for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_fused (body _rmsnorm_kernel):
// y = x * rsqrt(mean(x^2) + eps) * gamma, computed in float32 and cast once to
// x's dtype.  The TPU form normalises a [block_rows, D] tile per grid step in
// VMEM; here one warp owns one row, so no block-wide reduction and no shared
// memory are needed:
//
//   pass 1  the warp reads its row, 16 bytes per lane per load (8 bf16 or 4
//           float32 values) when D is a multiple of that width and the
//           pointers are 16-byte aligned, else one value per lane per load,
//           and sums the squares in float32; a shuffle tree folds the lanes.
//   pass 2  the warp reads the row again (it is in L1/L2 after pass 1: at most
//           32 KB for D = 8,192 in float32), multiplies by rsqrt and by gamma
//           in float32, and writes in x's dtype.
//
// gamma is read as float32 or bf16; any leading shape is flattened to rows by
// the wrapper; any D >= 1 works (lanes stride over the row).
//
// Bound on an H100 SXM: memory.  Per call the function must read x and gamma
// once and write y once: 2 * rows * D * sizeof(x) + D * sizeof(gamma) bytes,
// i.e. about 12.6 MB for the prefill's [4096, 768] in bf16, 3.8 us at 3.35 TB/s.
// About 4 flops per element, two orders of magnitude below the float32 peak.
// The design reads HBM once per element and writes once; the decode step's
// [8, 768] rows are a single block, where launch latency sets the time.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // rows per block
constexpr int kThreads = 32 * kWarps;

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

template <typename TX, typename TG>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TG* __restrict__ gamma,
               TX* __restrict__ out, long long rows, int d, float eps,
               bool vectorised) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * d;
  TX* yr = out + row * d;
  constexpr int kN = 16 / sizeof(TX);   // values per 16-byte vector

  float ss = 0.0f;
  if (vectorised) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kN; i += 32) {
      const uint4 raw = xv[i];
      const TX* a = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float f = to_f32(a[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);

  if (vectorised) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / kN; i += 32) {
      const uint4 raw = xv[i];
      const TX* a = reinterpret_cast<const TX*>(&raw);
      uint4 packed;
      TX* b = reinterpret_cast<TX*>(&packed);
#pragma unroll
      for (int k = 0; k < kN; ++k)
        b[k] = from_f32<TX>(to_f32(a[k]) * r * to_f32(gamma[i * kN + k]));
      yv[i] = packed;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f32<TX>(to_f32(xr[i]) * r * to_f32(gamma[i]));
  }
}

template <typename TX, typename TG>
int launch(const void* x, const void* gamma, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  constexpr int kN = 16 / sizeof(TX);
  const bool vectorised = d % kN == 0 &&
                          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<TX, TG><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(gamma),
      static_cast<TX*>(out), rows, d, eps, vectorised);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] of float32 (x_bf16 == 0) or bf16; gamma: [d] of float32
// (g_bf16 == 0) or bf16.
extern "C" int rmsnorm(const void* x, const void* gamma, void* out,
                       long long rows, int d, float eps, int x_bf16,
                       int g_bf16, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    return g_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, rows,
                                                         d, eps, stream)
                  : launch<__nv_bfloat16, float>(x, gamma, out, rows, d, eps,
                                                 stream);
  }
  return g_bf16 ? launch<float, __nv_bfloat16>(x, gamma, out, rows, d, eps,
                                               stream)
                : launch<float, float>(x, gamma, out, rows, d, eps, stream);
}
