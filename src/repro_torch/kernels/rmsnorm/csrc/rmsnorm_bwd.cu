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
// Design.  Two launches, no atomics, deterministic:
//   rmsnorm_bwd_rows   one block of 256 threads per contiguous chunk of rows;
//                      the block walks its rows one at a time.  A thread owns
//                      columns t, t + 256, ...: it reads x, dy and gamma there,
//                      sums x^2 and x * gamma * dy, the block folds both sums
//                      (shuffles, then the 8 warp sums in a fixed order from
//                      shared memory, double-buffered so one barrier a row
//                      does), recomputes r as the forward does and writes dx.
//                      The second read of the row is the thread's own values,
//                      served from L1.  Each thread adds dy * x * r into its
//                      columns of the block's float32 partial dgamma in shared
//                      memory (its own columns only, so no barrier or atomic),
//                      and writes them to row blockIdx of a float32 [blocks, D]
//                      scratch at the end.
//   rmsnorm_bwd_gamma  one thread per column sums the scratch over the blocks
//                      in block order and writes dgamma.
// The forward stays as it was: r is recomputed, not saved.
//
// Bound on an H100 SXM: memory.  The function must read x and dy and write dx
// (gamma and dgamma are one row each): at the qwen2-1.5b train step's
// [4096, 1536] in bf16, 3 * 12.58 MB = 37.7 MB, 11.3 us at 3.35 TB/s.  About 8
// flops an element, far below any peak.  What this design leaves on the
// table: scalar (2-byte) loads, a barrier per row, and the scratch (blocks =
// 4 per SM, 528 x D float32 = 3.2 MB written and read again at D = 1536,
// mostly in L2).
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing (the wrapper allocates dx, dgamma and the
// scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename TG>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_gamma(const float* __restrict__ part, TG* __restrict__ dgamma,
                  int blocks, int d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += part[(long long)b * d + i];
  dgamma[i] = from_f32<TG>(s);
}

template <typename TX, typename TG>
int launch(const void* x, const void* gamma, const void* dy, void* dx,
           void* dgamma, void* part, long long rows, int d, float eps,
           int blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)d;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_rows<TX, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  rmsnorm_bwd_rows<TX, TG><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(gamma),
      static_cast<const TX*>(dy), static_cast<TX*>(dx),
      static_cast<float*>(part), rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_gamma<TG><<<(d + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(static_cast<const float*>(part),
                                    static_cast<TG*>(dgamma), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: [rows, d] of float32 (x_bf16 == 0) or bf16; gamma, dgamma: [d]
// of float32 (g_bf16 == 0) or bf16; part: float32 scratch [blocks, d] with
// 1 <= blocks <= rows.  d * 4 bytes of shared memory a block: d <= 56,000.
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
