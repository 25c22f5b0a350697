// Fused RMSNorm, by hand for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_fused (body _rmsnorm_kernel):
// y = x * rsqrt(mean(x^2) + eps) * gamma, computed in float32 and cast once to
// x's dtype.  The TPU form normalises a [block_rows, D] tile per grid step in
// VMEM; here a warp, or a block for wide rows, owns one row.  Three routes,
// picked per call by rmsnorm_route():
//
//   register  rows of at most 16 vectors of 16 bytes per lane (D <= 4,096 in
//             bf16, D <= 2,048 in float32) with D a multiple of the vector
//             width and 16-byte aligned x, gamma and out.  One warp a row.
//             Built for each kV = ceil(D / (32 * kN)) vectors per lane (kN
//             values per 16 bytes).  A lane issues all of its kV x loads and
//             kV gamma loads before any arithmetic, so a row costs one memory
//             round trip, and the row stays in registers: x is read once.
//   wide      the same alignment and D, past 16 vectors a lane, up to
//             kWideMaxWarps * 32 * kWideV vectors (D <= 16,384 in bf16,
//             <= 8,192 in float32).  One block a row, ceil(vectors / (32 *
//             kWideV)) warps (7 at zamba2-7b's 7168 in bf16: 224 threads of 4
//             vectors each); a thread issues its kWideV x and gamma loads
//             before any arithmetic, as the register route does, and the
//             block folds its warps' sums in warp order from shared memory
//             (one barrier).  One row a block keeps the 8 rows of a decode
//             step on 8 SMs with 7 warps each, and leaves 4,096 blocks at the
//             prefill's [4096, 7168] for the SMs to hold several rows each.
//   generic   everything else (unaligned x, gamma or out, D not a multiple of
//             the vector, or wider than the wide route): one warp a row; pass
//             1 reads the row (16 bytes per lane per load where x and out
//             allow, else one value) and sums the squares; pass 2 reads it
//             again, multiplies and writes.
//
// The register route sums in the order of the generic route's vector loop
// (aligned x and out, D a multiple of the vector) -- lane l adds the squares of
// vectors l, l + 32, ..., values 0..kN-1 of each, one after another, then the
// same __shfl_xor_sync tree folds the lanes -- and both form (x * r) * gamma,
// so on such rows the two give the same bits.  The wide route sums in its own
// fixed order (a thread's vectors, the warp's tree, then the warps in order),
// and the generic route's one-value loop in another: each agrees with the
// plain version to one bf16 ulp and gives the same bits from run to run.
//
// Rows per block on the register route follow the row count: blocks take up
// to 8 warps (one row each) but only as many as leave a block for every SM,
// so the 8 rows of a decode step run on 8 SMs instead of sharing one.
//
// Bound on an H100 SXM: memory.  Per call the function must read x and gamma
// once and write y once: 2 * rows * D * sizeof(x) + D * sizeof(gamma) bytes,
// i.e. about 12.6 MB for the prefill's [4096, 768] in bf16, 3.8 us at 3.35 TB/s,
// and 117.4 MB for zamba2-7b's [4096, 7168], 35.06 us.  About 4 flops per
// element, two orders of magnitude below the float32 peak.  A decode step's
// [8, D] rows move a few tens to a few hundred KB (229 KB at [8, 7168], 0.07
// us): there one memory round trip and the launch set the time, hence the
// single round trip on every vector route.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWarps = 8;           // rows per block, at most
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxVectors = 16;        // register route: vectors per lane
constexpr int kWideV = 4;              // wide route: vectors per thread
constexpr int kWideMaxWarps = 16;      // wide route: warps a row, at most

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

// The kN gamma values that scale one 16-byte vector of x: 8, 16 or 32 bytes,
// loaded as one or two vector words.
template <typename TG, int kN>
struct GammaVec {
  static constexpr int kBytes = kN * (int)sizeof(TG);
  using Word = typename std::conditional<kBytes == 8, uint2, uint4>::type;
  static constexpr int kWords = kBytes / (int)sizeof(Word);
  Word w[kWords];

  __device__ __forceinline__ void load(const TG* gamma, int v) {
    const Word* p = reinterpret_cast<const Word*>(gamma) + (size_t)v * kWords;
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = p[i];
  }
  __device__ __forceinline__ float at(int k) const {
    return to_f32(reinterpret_cast<const TG*>(w)[k]);
  }
};

__device__ __forceinline__ float warp_sum(float ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  return ss;
}

// Register route: one warp per row, kV vectors of kN values per lane.
template <typename TX, typename TG, int kV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_regs(const TX* __restrict__ x, const TG* __restrict__ gamma,
             TX* __restrict__ out, long long rows, int d, float eps) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  constexpr int kN = 16 / sizeof(TX);   // values per 16-byte vector
  const int n_vec = d / kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);

  uint4 xr[kV];
  GammaVec<TG, kN> g[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {          // every load before any arithmetic
    const int v = lane + 32 * j;
    if (v < n_vec) {
      xr[j] = xv[v];
      g[j].load(gamma, v);
    }
  }

  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (lane + 32 * j < n_vec) {
      const TX* a = reinterpret_cast<const TX*>(&xr[j]);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float f = to_f32(a[k]);
        ss += f * f;
      }
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);

  uint4* yv = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int v = lane + 32 * j;
    if (v < n_vec) {
      const TX* a = reinterpret_cast<const TX*>(&xr[j]);
      uint4 packed;
      TX* b = reinterpret_cast<TX*>(&packed);
#pragma unroll
      for (int k = 0; k < kN; ++k)
        b[k] = from_f32<TX>(to_f32(a[k]) * r * g[j].at(k));
      yv[v] = packed;
    }
  }
}

// Wide route: one block per row, kWideV vectors of kN values a thread
// (vectors t, t + T, ... of the row for thread t of T).
template <typename TX, typename TG>
__global__ void __launch_bounds__(32 * kWideMaxWarps)
rmsnorm_wide(const TX* __restrict__ x, const TG* __restrict__ gamma,
             TX* __restrict__ out, int d, float eps) {
  __shared__ float red[kWideMaxWarps];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, n_threads = blockDim.x;
  constexpr int kN = 16 / sizeof(TX);   // values per 16-byte vector
  const int n_vec = d / kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);

  uint4 xr[kWideV];
  GammaVec<TG, kN> g[kWideV];
#pragma unroll
  for (int j = 0; j < kWideV; ++j) {     // every load before any arithmetic
    const int v = t + n_threads * j;
    if (v < n_vec) {
      xr[j] = xv[v];
      g[j].load(gamma, v);
    }
  }

  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kWideV; ++j) {
    if (t + n_threads * j < n_vec) {
      const TX* a = reinterpret_cast<const TX*>(&xr[j]);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float f = to_f32(a[k]);
        ss += f * f;
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red[t >> 5] = ss;
  __syncthreads();
  ss = 0.0f;
  for (int w = 0; w < n_threads >> 5; ++w) ss += red[w];   // warp order
  const float r = rsqrtf(ss / (float)d + eps);

  uint4* yv = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int j = 0; j < kWideV; ++j) {
    const int v = t + n_threads * j;
    if (v < n_vec) {
      const TX* a = reinterpret_cast<const TX*>(&xr[j]);
      uint4 packed;
      TX* b = reinterpret_cast<TX*>(&packed);
#pragma unroll
      for (int k = 0; k < kN; ++k)
        b[k] = from_f32<TX>(to_f32(a[k]) * r * g[j].at(k));
      yv[v] = packed;
    }
  }
}

// Generic route: one warp per row, two passes over the row.
template <typename TX, typename TG>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_generic(const TX* __restrict__ x, const TG* __restrict__ gamma,
                TX* __restrict__ out, long long rows, int d, float eps,
                bool vectorised) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
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
  ss = warp_sum(ss);
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

enum Route { kGeneric = 0, kRegister = 1, kWide = 2 };

// The route for rows of d values of x_bytes each at these pointers, and
// through *kv the register route's vectors per lane (0 off that route).
Route pick(const void* x, const void* gamma, const void* out, int d,
           int x_bytes, int* kv) {
  const int n = 16 / x_bytes;
  *kv = 0;
  if (d % n != 0 || !aligned16(x) || !aligned16(gamma) || !aligned16(out))
    return kGeneric;
  const int n_vec = d / n;
  if (n_vec <= 32 * kMaxVectors) {
    *kv = (n_vec + 31) / 32;
    return kRegister;
  }
  return n_vec <= 32 * kWideMaxWarps * kWideV ? kWide : kGeneric;
}

// Threads of the wide route's block: whole warps of kWideV vectors each.
int wide_threads(int d, int x_bytes) {
  const int n_vec = d / (16 / x_bytes);
  return 32 * ((n_vec + 32 * kWideV - 1) / (32 * kWideV));
}

// Rows per block: up to kMaxWarps, fewer where that leaves an SM without a
// block.
int warps_per_block(long long rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  int w = kMaxWarps;
  while (w > 1 && (rows + w - 1) / w < sms) w >>= 1;
  return w;
}

template <typename TX, typename TG, int kV>
void launch_regs(const void* x, const void* gamma, void* out, long long rows,
                 int d, float eps, unsigned blocks, int threads,
                 cudaStream_t stream) {
  rmsnorm_regs<TX, TG, kV><<<blocks, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(gamma),
      static_cast<TX*>(out), rows, d, eps);
}

template <typename TX, typename TG>
int launch(const void* x, const void* gamma, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  int kv;
  const Route route = pick(x, gamma, out, d, sizeof(TX), &kv);
  if (route == kWide) {
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_wide<TX, TG><<<(unsigned)rows, wide_threads(d, sizeof(TX)), 0,
                           stream>>>(
        static_cast<const TX*>(x), static_cast<const TG*>(gamma),
        static_cast<TX*>(out), d, eps);
    return (int)cudaGetLastError();
  }
  const int warps = warps_per_block(rows);
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  const int threads = 32 * warps;
  switch (kv) {
#define RMS_REGS(KV)                                                        \
  case KV:                                                                  \
    launch_regs<TX, TG, KV>(x, gamma, out, rows, d, eps, nb, threads,       \
                            stream);                                        \
    break;
    RMS_REGS(1) RMS_REGS(2) RMS_REGS(3) RMS_REGS(4) RMS_REGS(5) RMS_REGS(6)
    RMS_REGS(7) RMS_REGS(8) RMS_REGS(9) RMS_REGS(10) RMS_REGS(11)
    RMS_REGS(12) RMS_REGS(13) RMS_REGS(14) RMS_REGS(15) RMS_REGS(16)
#undef RMS_REGS
    default: {
      constexpr int kN = 16 / sizeof(TX);
      const bool vectorised = d % kN == 0 && aligned16(x) && aligned16(out);
      rmsnorm_generic<TX, TG><<<nb, threads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TG*>(gamma),
          static_cast<TX*>(out), rows, d, eps, vectorised);
    }
  }
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

// The route rmsnorm() takes for these arguments, launching nothing:
// 65536 * route + 256 * vectors + rows per block, where route is 0 (generic),
// 1 (register) or 2 (wide), vectors are the register route's per lane or the
// wide route's per thread (0 on the generic route), and rows per block are
// the register and generic routes' warps a block (1 on the wide route).  out
// may be NULL, which counts as aligned (as the allocator's outputs are).
extern "C" int rmsnorm_route(const void* x, const void* gamma, const void* out,
                             long long rows, int d, int x_bf16) {
  if (rows <= 0 || d <= 0) return 0;
  int kv;
  const Route route = pick(x, gamma, out, d, x_bf16 ? 2 : 4, &kv);
  if (route == kWide) return 65536 * kWide + 256 * kWideV + 1;
  return 65536 * route + 256 * kv + warps_per_block(rows);
}
