// Causal or non-causal GQA flash attention, by hand for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (body _flash_kernel).  q [B, H, Sq, hd], k and v [B, Hkv, Skv, hd], float32
// or bf16; the output has q's layout and dtype.  The function is the TPU
// kernel's: q is cast to float32 and multiplied by scale = 1/sqrt(hd), the
// scores q.k^T are float32, the causal mask keeps kpos <= qpos counted from
// 0 (scores of masked pairs become -1e30), an online softmax keeps the running
// max m, the normaliser l and the float32 accumulator per row, P stays float32
// for the P.V product, and the output is acc / max(l, 1e-20) cast once.
//
// Design.  One block of 256 threads (a 16 x 16 grid) per (batch, head, 64-row
// q tile) walks the kv tiles of 64 rows in a loop, which takes the place of
// the TPU's sequential ("arbitrary") kv grid axis; the kv head is h / group.
// Under the causal mask the loop stops at the tile that holds the diagonal
// instead of skipping the later ones with pl.when, and q tiles are handed out
// last first, so the longest blocks start first.  The q tile (pre-scaled), a
// K tile and a V tile are staged in shared memory as float32; Q and K rows
// are padded to hd + 4 floats, so that the 16-byte loads of eight threads
// reading eight K rows fall on distinct banks.  Each thread owns 4 rows
// (ty + 16 r) and, of the 64 x 64 score tile, the 4 columns tx + 16 c: it
// sums their dot products over hd with float32 FMAs, masks them, and reduces
// the row max and row sum over the 16 threads of its row with shuffles.  Its
// rows' m, l and the accumulator columns tx + 16 c (hd / 16 of them) stay in
// registers.  P goes to shared memory over the K tile, which the scores no
// longer need, and every thread then adds P.V for its rows and columns.  At
// hd = 128 that is 33 KB for Q, 33 KB for K or P and 32 KB for V: 98 KB of
// dynamic shared memory (two blocks fit on an SM), above the 48 KB default,
// so the host entry sets cudaFuncAttributeMaxDynamicSharedMemorySize before
// the first launch (a launch without it is refused, which only
// cudaGetLastError() shows).  Any Sq, Skv >= 1 works: rows past Sq are
// computed on zeros and not stored, columns past Skv are masked and their V
// rows are zero.  Any hd from 1 to 128 works: the kernel is built for hd 16,
// 32, 64 and 128, and a smaller hd runs in the next larger build with its
// extra columns zero.
//
// Bound on an H100 SXM: operations.  A causal head of S rows needs
// S (S + 1) / 2 (q, k) pairs at 4 hd flops each (q.k and p.v): at the
// qwen2-1.5b prefill (B = 8, H = 12, S = 512, hd = 128) 6.45 GFLOP, 96 us at
// the 67 TFLOP/s float32 peak, against 29.4 MB of bf16 q, k, v and output,
// 8.8 us at 3.35 TB/s.  The scores and P are float32 in the function, which
// bf16 tensor cores (wgmma) would round; they would lift the bound to the
// bytes and change the numerics, and are later work.  The kernel computes the
// whole diagonal tile and masks it: at S = 512, 36 tiles of 64 x 64 per head
// where the function needs 32.5, 1.12 times its work.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns a cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;             // q rows per block
constexpr int kBk = 64;             // kv rows per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLdP = kBk + 4;       // P row stride (floats)
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

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

template <int HD>
struct Tile {
  static constexpr int kLd = HD + 4;                   // Q and K row stride
  static constexpr int kQ = kBq * kLd;                 // Q tile (floats)
  static constexpr int kKP = kBk * kLd > kBq * kLdP ? kBk * kLd : kBq * kLdP;
  static constexpr int kV = kBk * HD;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// HD: the build's head dim; hd <= HD the inputs' (extra columns are zero)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int heads,
             int group, int sq, int skv, int hd, bool causal, float scale) {
  using L = Tile<HD>;
  constexpr int kNc = HD / 16;      // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBq][kLd], scaled q
  float* ks = qs + L::kQ;                        // [kBk][kLd], then P
  float* ps = ks;                                // [kBq][kLdP]
  float* vs = ks + L::kKP;                       // [kBk][HD]

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBq;
  const long long q_base = ((long long)b * heads + h) * sq * hd;
  const long long kv_base =
      ((long long)b * (heads / group) + h / group) * skv * hd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  for (int i = t; i < kBq * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    qs[r * L::kLd + d] =
        (row < sq && d < hd) ? to_f32(q[q_base + (long long)row * hd + d]) *
                                   scale
                             : 0.0f;
  }

  float m[4], l[4], acc[4][kNc];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[r][c] = 0.0f;
  }

  int n_tiles = (skv + kBk - 1) / kBk;
  if (causal)                        // up to the tile of the last row's diagonal
    n_tiles = min(n_tiles, (min(q0 + kBq, sq) - 1) / kBk + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();                 // the previous tile's P and V are used
    for (int i = t; i < kBk * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = k0 + r;
      const bool in = row < skv && d < hd;
      const long long g = kv_base + (long long)row * hd + d;
      ks[r * L::kLd + d] = in ? to_f32(k[g]) : 0.0f;
      vs[r * HD + d] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * r) * L::kLd + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 bk =
            *reinterpret_cast<const float4*>(&ks[(tx + 16 * c) * L::kLd + d]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][c] = fmaf(a[r].x, bk.x, s[r][c]);
          s[r][c] = fmaf(a[r].y, bk.y, s[r][c]);
          s[r][c] = fmaf(a[r].z, bk.z, s[r][c]);
          s[r][c] = fmaf(a[r].w, bk.w, s[r][c]);
        }
      }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= skv || (causal && kpos > qpos)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        rs += s[r][c];
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + half_warp_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kNc; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();                 // every thread is done with K
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ty + 16 * r) * kLdP + tx + 16 * c] = s[r][c];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBk; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[r] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * r) * kLdP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kNc];
#pragma unroll
        for (int c = 0; c < kNc; ++c) vv[c] = vs[(j + jj) * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pj = jj == 0 ? p[r].x : jj == 1 ? p[r].y
                         : jj == 2 ? p[r].z : p[r].w;
#pragma unroll
          for (int c = 0; c < kNc; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= sq) continue;
    const float lr = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) out[q_base + (long long)row * hd + d] = from_f32<T>(acc[r][c] / lr);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, int kv_heads, int sq, int skv, int hd, bool causal,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = Tile<HD>::kBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};       // one per build of the kernel
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const dim3 grid((unsigned)((sq + kBq - 1) / kBq), (unsigned)heads,
                  (unsigned)batch);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), heads,
      heads / kv_heads, sq, skv, hd, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int heads, int kv_heads, int sq, int skv, int hd,
             bool causal, float scale, cudaStream_t stream) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal, scale, stream);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal, scale, stream);
  return launch<T, 128>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                        causal, scale, stream);
}

}  // namespace

// q [batch, heads, sq, hd], k and v [batch, kv_heads, skv, hd] -> out [batch,
// heads, sq, hd]; all float32 (bf16 = 0) or all bf16 (bf16 = 1), contiguous.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int heads, int kv_heads,
                               int sq, int skv, int hd, int causal, int bf16,
                               float scale, cudaStream_t stream) {
  if (batch == 0 || sq == 0) return 0;
  if (batch < 0 || batch > 65535 || heads < 1 || heads > 65535 ||
      kv_heads < 1 || heads % kv_heads != 0 || sq < 0 || skv < 1 || hd < 1 ||
      hd > 128)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, heads, kv_heads, sq,
                                   skv, hd, causal != 0, scale, stream);
  return dispatch<float>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal != 0, scale, stream);
}
