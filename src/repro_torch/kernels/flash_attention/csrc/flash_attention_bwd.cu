// The backward of the GQA flash attention, by hand for Hopper.
//
// Computes the gradient of the port's forward (flash_attention.cu), which
// replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention (body
// _flash_kernel).  q, o, dO [B, H, Sq, hd], k and v [B, Hkv, Skv, hd], all
// float32 or all bf16; q head h reads kv head h / G (G = H / Hkv).  The
// standard recompute formulation, every product accumulated in float32:
//
//   D   = rowsum(dO * O)
//   P   = exp(S * scale - LSE), S = Q K^T, under the forward's mask (kpos <=
//         max(qpos, prefix - 1) when causal; columns past Skv masked)
//   dV  = P^T dO           (bf16: P rounded to bf16 first, as the forward
//                           rounds it before P V)
//   dP  = dO V^T
//   dS  = P * (dP - D)
//   dQ  = scale * dS K
//   dK  = scale * dS^T Q
//
// dK and dV sum over the G q heads of their kv head.  The three gradients are
// cast once to the inputs' dtype at the end.  The TPU kernel has no backward
// (the reference trains through jax.grad of plain attention); the port's
// models call the kernel, so its gradient is a kernel too.
//
// Design: SIMT, float32 throughout, three launches, no atomics.
//   flash_bwd_prep  one block of 256 threads (16 x 16) per (batch, head, 64-row
//                   q tile).  It recomputes each row's LSE with the forward's
//                   online softmax over the kv tiles the rows see (one more
//                   Q K^T pass: the forward, and so every serve, stays as it
//                   was) and D, and writes both as float32 [B, H, Sq] scratch.
//   flash_bwd_dkdv  one block per (batch, kv head, 64-row kv tile).  K and V
//                   of the tile stay in shared memory; the block loops over
//                   the G q heads of the kv head and, under the causal mask,
//                   over the q tiles that see the tile (all of them where the
//                   prefix reaches it), staging Q, dO, LSE and D of each.  Per
//                   q tile a thread forms 4 x 4 entries of S and dP with
//                   float32 FMAs (rows ty + 16 i, columns tx + 16 j), makes P
//                   and dS, puts both in shared memory, and adds P^T dO and
//                   dS^T Q into its 4 kv rows by hd / 16 columns of dV and dK,
//                   held in registers until the one store at the end.
//   flash_bwd_dq    one block per (batch, head, 64-row q tile): the same S, dP,
//                   P and dS over the kv tiles the rows see, adding dS K into
//                   the block's dQ rows, held in registers.
// Tiles are float32 in shared memory, rows of Q, K, V and dO padded to hd + 4
// floats so that 16-byte loads fall on distinct banks: 170 KB for dK/dV and
// 153 KB for dQ at hd 128, one block an SM.  Builds for hd 64 and 128; a
// smaller hd runs in the next larger build with zero columns.
//
// Bound on an H100 SXM, at the qwen2-1.5b train step (q, o, dO [8, 12, 512,
// 128], k, v [8, 2, 512, 128], causal):
//   bytes       q, o, dO, k, v read, dq, dk, dv written: 58.7 MB in bf16,
//               17.5 us at 3.35 TB/s;
//   operations  5 products (S, dP, dV, dQ, dK) of 4 hd flops per visible (q, k)
//               pair, 16.1 GFLOP over the causal half: 16.3 us at the bf16
//               tensor-core peak of 989 TFLOP/s, 240 us at the float32 FMA peak
//               of 67 TFLOP/s.
// So bf16 is bound by bytes (17.5 us) and float32 by operations (240 us).
// This kernel runs SIMT FMAs for both dtypes, does a sixth product (the LSE
// pass), whole 64 x 64 tiles on the diagonal, and reads its shared tiles many
// times a product: it is far from the bf16 bound by design.  Tensor cores
// (wgmma), an LSE written by the forward, and a dK/dV grid that splits the G
// heads are the later work.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing (the wrapper allocates the gradients and the
// LSE and D scratch) and returns a cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;              // q rows and kv rows per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLdP = kB + 4;        // P and dS row stride (floats)
constexpr float kNegInf = -1e30f;   // the forward's mask value

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
  return __float2bfloat16(v);
}
// P as the dV product reads it: rounded to the inputs' type
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

__device__ __forceinline__ int causal_limit(int qpos, int prefix) {
  return max(qpos, prefix - 1);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int skv,
                                        bool causal, int prefix) {
  return qpos < sq && kpos < skv &&
         (!causal || kpos <= causal_limit(qpos, prefix));
}

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

template <int HD>
struct Ld {
  static constexpr int kRow = HD + 4;          // Q, K, V, dO row stride
  static constexpr int kTile = kB * kRow;      // one such tile (floats)
};

// rows [r0, r0 + 64) of a [rows, hd] matrix into a [64][HD + 4] float tile,
// zero past the rows and past hd
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int hd) {
  for (int i = threadIdx.x; i < kB * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    dst[r * Ld<HD>::kRow + d] =
        (row < rows && d < hd) ? to_f32(src[(long long)row * hd + d]) : 0.0f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two [64][HD + 4]
// tiles
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int kL = Ld<HD>::kRow;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * kL + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * kL + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// The kv tiles a 64-row q tile from q0 sees.
__device__ __forceinline__ int kv_tiles(int q0, int sq, int skv, bool causal,
                                        int prefix) {
  int n = (skv + kB - 1) / kB;
  if (causal) n = min(n, causal_limit(min(q0 + kB, sq) - 1, prefix) / kB + 1);
  return n;
}

// ------------------------------------------------------------------- prep
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_prep(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ lse, float* __restrict__ delta, int heads,
               int group, int sq, int skv, int hd, bool causal, int prefix,
               float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Ld<HD>::kTile;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  const long long q_base = bh * sq * hd;
  const long long kv_base =
      ((long long)b * (heads / group) + h / group) * skv * hd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  // D = rowsum(dO * O) for rows ty + 16 i, over columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float s = 0.0f;
    if (row < sq)
      for (int d = tx; d < hd; d += 16) {
        const long long g = q_base + (long long)row * hd + d;
        s += to_f32(dout[g]) * to_f32(o[g]);
      }
    s = half_warp_sum(s);
    if (tx == 0 && row < sq) delta[bh * sq + row] = s;
  }

  stage<T, HD>(qs, q + q_base, q0, sq, hd);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  const int n_tiles = kv_tiles(q0, sq, skv, causal, prefix);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                       // the previous K tile is used
    stage<T, HD>(ks, k + kv_base, k0, skv, hd);
    __syncthreads();
    float s[4][4];
    dot_tile<HD>(s, qs, ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = (kpos < skv && (!causal || kpos <= causal_limit(qpos, prefix)))
                      ? s[i][j] * scale
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      l[i] = expf(m[i] - m_new) * l[i] + half_warp_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < sq) lse[bh * sq + row] = m[i] + logf(l[i]);
  }
}

// P and dS of one (q tile, kv tile) pair, from the staged Q, K, dO, V and
// the rows' LSE and D: p[i][j], ds[i][j] for q rows ty + 16 i and kv rows
// tx + 16 j.
template <int HD>
__device__ __forceinline__ void p_and_ds(float (&p)[4][4], float (&ds)[4][4],
                                         const float* qs, const float* ks,
                                         const float* dos, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         int sq, int skv, bool causal,
                                         int prefix, float scale, int tx,
                                         int ty) {
  dot_tile<HD>(p, qs, ks, tx, ty);
  dot_tile<HD>(ds, dos, vs, tx, ty);           // dP
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      p[i][j] = visible(q0 + r, k0 + c, sq, skv, causal, prefix)
                    ? expf(p[i][j] * scale - lse_s[r])
                    : 0.0f;
      ds[i][j] = p[i][j] * (ds[i][j] - delta_s[r]);
    }
  }
}

// ------------------------------------------------------------------ dK, dV
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int heads, int group,
               int sq, int skv, int hd, bool causal, int prefix,
               float scale) {
  constexpr int kNc = HD / 16;      // accumulator columns per thread
  constexpr int kL = Ld<HD>::kRow;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + Ld<HD>::kTile;
  float* qs = vs + Ld<HD>::kTile;
  float* dos = qs + Ld<HD>::kTile;
  float* ps = dos + Ld<HD>::kTile;     // [64 q rows][kLdP]
  float* dss = ps + kB * kLdP;         // [64 q rows][kLdP]
  float* lse_s = dss + kB * kLdP;      // [64]
  float* delta_s = lse_s + kB;         // [64]

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int kv_heads = heads / group;
  const long long kv_base = ((long long)b * kv_heads + hk) * skv * hd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  stage<T, HD>(ks, k + kv_base, k0, skv, hd);
  stage<T, HD>(vs, v + kv_base, k0, skv, hd);

  float dka[4][kNc], dva[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c) dka[i][c] = dva[i][c] = 0.0f;

  // the first q tile that sees this kv tile: its diagonal, or 0 where the
  // prefix reaches the tile
  const int qt0 = (causal && prefix - 1 < k0) ? k0 / kB : 0;
  const int n_qt = (sq + kB - 1) / kB;
  for (int g = 0; g < group; ++g) {
    const long long bh = (long long)b * heads + hk * group + g;
    const long long q_base = bh * sq * hd;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();                 // the previous tile's Q, dO, P, dS used
      stage<T, HD>(qs, q + q_base, q0, sq, hd);
      stage<T, HD>(dos, dout + q_base, q0, sq, hd);
      if (t < kB) {
        const int row = q0 + t;
        lse_s[t] = row < sq ? lse[bh * sq + row] : 0.0f;
        delta_s[t] = row < sq ? delta[bh * sq + row] : 0.0f;
      }
      __syncthreads();

      float p[4][4], ds[4][4];
      p_and_ds<HD>(p, ds, qs, ks, dos, vs, lse_s, delta_s, q0, k0, sq, skv,
                   causal, prefix, scale, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * kLdP + tx + 16 * j] = round_p<T>(p[i][j]);
          dss[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV[kv row][d] += P[j][kv row] dO[j][d]; dK likewise from dS and Q
#pragma unroll 2
      for (int j = 0; j < kB; ++j) {
        float pj[4], dsj[4], dov[kNc], qv[kNc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pj[i] = ps[j * kLdP + ty + 16 * i];
          dsj[i] = dss[j * kLdP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < kNc; ++c) {
          dov[c] = dos[j * kL + tx + 16 * c];
          qv[c] = qs[j * kL + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kNc; ++c) {
            dva[i][c] = fmaf(pj[i], dov[c], dva[i][c]);
            dka[i][c] = fmaf(dsj[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= skv) continue;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        const long long g = kv_base + (long long)row * hd + d;
        dk[g] = from_f32<T>(dka[i][c] * scale);
        dv[g] = from_f32<T>(dva[i][c]);
      }
    }
  }
}

// --------------------------------------------------------------------- dQ
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int heads, int group, int sq, int skv, int hd,
             bool causal, int prefix, float scale) {
  constexpr int kNc = HD / 16;
  constexpr int kL = Ld<HD>::kRow;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + Ld<HD>::kTile;
  float* ks = dos + Ld<HD>::kTile;
  float* vs = ks + Ld<HD>::kTile;
  float* dss = vs + Ld<HD>::kTile;     // [64 q rows][kLdP]
  float* lse_s = dss + kB * kLdP;
  float* delta_s = lse_s + kB;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  const long long q_base = bh * sq * hd;
  const long long kv_base =
      ((long long)b * (heads / group) + h / group) * skv * hd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  stage<T, HD>(qs, q + q_base, q0, sq, hd);
  stage<T, HD>(dos, dout + q_base, q0, sq, hd);
  if (t < kB) {
    const int row = q0 + t;
    lse_s[t] = row < sq ? lse[bh * sq + row] : 0.0f;
    delta_s[t] = row < sq ? delta[bh * sq + row] : 0.0f;
  }

  float dqa[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c) dqa[i][c] = 0.0f;

  const int n_tiles = kv_tiles(q0, sq, skv, causal, prefix);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                   // the previous K, V and dS are used
    stage<T, HD>(ks, k + kv_base, k0, skv, hd);
    stage<T, HD>(vs, v + kv_base, k0, skv, hd);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<HD>(p, ds, qs, ks, dos, vs, lse_s, delta_s, q0, k0, sq, skv,
                 causal, prefix, scale, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ[q row][d] += dS[q row][j] K[j][d]
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float dsj[4], kv[kNc];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsj[i] = dss[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kNc; ++c) kv[c] = ks[j * kL + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kNc; ++c) dqa[i][c] = fmaf(dsj[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      const int d = tx + 16 * c;
      if (d < hd)
        dq[q_base + (long long)row * hd + d] = from_f32<T>(dqa[i][c] * scale);
    }
  }
}

// -------------------------------------------------------------- launches
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int batch, int heads, int kv_heads, int sq, int skv,
           int hd, bool causal, int prefix, float scale,
           cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * Ld<HD>::kTile;
  constexpr size_t pds = sizeof(float) * kB * kLdP;
  constexpr size_t rows = sizeof(float) * 2 * kB;
  constexpr size_t prep_bytes = 2 * tile;
  constexpr size_t dkdv_bytes = 4 * tile + 2 * pds + rows;
  constexpr size_t dq_bytes = 4 * tile + pds + rows;
  static bool ready[64] = {};       // per device, per build
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    if ((err = allow_smem(flash_bwd_prep<T, HD>, prep_bytes)) != cudaSuccess ||
        (err = allow_smem(flash_bwd_dkdv<T, HD>, dkdv_bytes)) != cudaSuccess ||
        (err = allow_smem(flash_bwd_dq<T, HD>, dq_bytes)) != cudaSuccess)
      return (int)err;
    ready[dev] = true;
  }
  const int group = heads / kv_heads;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot_ = static_cast<const T*>(dout);
  const dim3 q_grid((unsigned)((sq + kB - 1) / kB), (unsigned)heads,
                    (unsigned)batch);
  flash_bwd_prep<T, HD><<<q_grid, kThreads, prep_bytes, stream>>>(
      qt, kt, ot, dot_, lse, delta, heads, group, sq, skv, hd, causal, prefix,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)((skv + kB - 1) / kB), (unsigned)kv_heads,
                     (unsigned)batch);
  flash_bwd_dkdv<T, HD><<<kv_grid, kThreads, dkdv_bytes, stream>>>(
      qt, kt, vt, dot_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      heads, group, sq, skv, hd, causal, prefix, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq<T, HD><<<q_grid, kThreads, dq_bytes, stream>>>(
      qt, kt, vt, dot_, lse, delta, static_cast<T*>(dq), heads, group, sq, skv,
      hd, causal, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, int batch, int heads, int kv_heads, int sq,
             int skv, int hd, bool causal, int prefix, float scale,
             cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
                         heads, kv_heads, sq, skv, hd, causal, prefix, scale,
                         stream);
  return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch, heads,
                        kv_heads, sq, skv, hd, causal, prefix, scale, stream);
}

}  // namespace

// q, o, dout, dq [batch, heads, sq, hd]; k, v, dk, dv [batch, kv_heads, skv,
// hd]; all float32 (bf16 = 0) or all bf16 (bf16 = 1), contiguous; lse and
// delta: float32 scratch [batch, heads, sq].  hd <= 128; prefix as the
// forward's (0 <= prefix <= skv, only with causal).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta,
                                   int batch, int heads, int kv_heads, int sq,
                                   int skv, int hd, int causal, int prefix,
                                   int bf16, float scale,
                                   cudaStream_t stream) {
  if (batch == 0 || sq == 0) return 0;
  if (batch < 0 || batch > 65535 || heads < 1 || heads > 65535 ||
      kv_heads < 1 || heads % kv_heads != 0 || sq < 0 || skv < 1 || hd < 1 ||
      hd > 128 || prefix < 0 || prefix > skv || (prefix > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, batch,
                                   heads, kv_heads, sq, skv, hd, causal != 0,
                                   prefix, scale, stream);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, l, dl, batch, heads,
                         kv_heads, sq, skv, hd, causal != 0, prefix, scale,
                         stream);
}
