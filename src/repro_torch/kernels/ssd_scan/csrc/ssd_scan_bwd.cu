// The backward of the Mamba2 SSD within-chunk block, by hand for Hopper.
//
// Computes the gradient of the port's forward (ssd_scan.cu), which replaces
// the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::ssd_inner
// (body _ssd_kernel).  The TPU kernel has no backward (the reference trains
// mamba2 through jax.grad of its plain ssd_chunked); the port's models call
// the forward kernel, so its gradient is a kernel too.
//
// Per (batch x chunk, head) cell, with u = x * dt formed in float32 (or the
// given xdt), the head's group's B and C [Q, N], dA [Q], L_ij = exp(dA_i -
// dA_j) for j <= i (else 0), M = (C B^T) o L and e_j = exp(dA_last - dA_j),
// the forward is y = M u and S = sum_j e_j B_j^T u_j.  Given the float32
// output gradients gy [Q, P] and gS [N, P], in float32:
//
//   gu      = M^T gy + e o (B gS)
//   gM      = gy u^T on j <= i
//   G^      = sum over the group's heads of gM o L
//   gC      = G^ B
//   gB      = G^T C + sum over the group's heads of e o (u gS^T)
//   gdA_i   = sum_j R_ij - sum_j R_ji - r_i (+ sum_j r_j at the last row),
//             R = gM o M, r_j = e_j sum_n B_jn (u gS^T)_jn
//   gx      = gu dt, gdt = sum_p gu o x (without dt, gxdt = gu)
//
// gx, gB and gC are written in the inputs' dtype (float32 or bf16, rounded
// to nearest even as torch's cast), gdA and gdt in float32.
//
// Design: float32 SIMT, three kernels, no atomics, so every result is the
// same bits from run to run.
//   ssd_bwd_head   one block of 256 threads (a 16 x 16 grid) per (cell,
//                  head): mamba2-130m's train step has a single group over
//                  24 heads, so a block per (cell, group) alone would give 32
//                  blocks on 132 SMs.  It recomputes C B^T as the forward's
//                  SIMT kernel does (N streamed in slices of 32 staged
//                  k-major, 8 x 8 scores a thread in registers) and keeps M in
//                  shared memory beside u and gy.  Then gM (8 x 8 a thread,
//                  over P), from which R's row sums (shuffles within the 16
//                  threads of a row) and column sums (shared memory, 16
//                  partials a column added in order), and G^'s per-head part
//                  gM o L, written to float32 scratch; gu = M^T gy (8 x 4 a
//                  thread); then a second pass over N slices of e o B and gS
//                  adds e o (B gS) to gu and forms u gS^T a slice at a time,
//                  whose e-scaled values (the head's part of gB's state term)
//                  go to scratch and whose products with e o B give r.
//                  Last gx, gdt and gdA.  176 KB of dynamic shared memory, one
//                  block an SM.
//   ssd_bwd_sum    where a group has several heads: sums each group's per-head
//                  scratch over its heads in head order into its first head's
//                  slot, elementwise (a block per group and chunk of 1,024
//                  values).
//   ssd_bwd_group  a block per (cell, group, 32 rows): gC's rows from G^'s
//                  rows and B, gB's rows from G^'s columns and C plus the state
//                  term, N in slices of 32 (a warp per row at a time, a lane
//                  per column).
// The scratch is [cells x heads, Q, Q + N] float32 (235 MB at zamba2-7b's
// [8, 4, 112, 128, 64] with N = 64, 50 MB at mamba2-130m's), allocated by the
// wrapper.
//
// Bound on an H100 SXM at the mamba2-130m train step (x [8, 4, 24, 128, 64]
// bf16, N = 128, G = 1): bytes.  Reads x 12.6 MB, B and C 1.0 MB each, dA and
// dt 0.4 MB each, gy and gS 25.2 MB each; writes gx 12.6 MB, gB and gC 1.0
// MB each, gdA and gdt 0.4 MB each: 81.2 MB, 24 us at 3.35 TB/s.  The causal
// products (C B^T, gC and gB once per group; M^T gy, gy u^T, B gS and u gS^T
// per head) are 5.1 GFLOP: 5 us at the bf16 tensor-core rate, 76 us at the
// float32 SIMT rate of 67 TFLOP/s, which this first kernel runs at.  It also
// recomputes C B^T per head and writes and reads its scratch.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns a cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;            // largest chunk
constexpr int kP = 64;             // largest head dim
constexpr int kN = 128;            // largest state dim
constexpr int kNS = 32;            // N slice staged per step
constexpr int kLd = kQ + 1;        // padded stride of rows Q long
constexpr int kLdP = kP + 1;       // padded stride of rows P long
constexpr int kThreads = 256;

// ssd_bwd_head's shared memory, in floats
constexpr int kSmemHead = kQ * kLd          // M
                          + 2 * kQ * kLdP   // u, gy
                          + 2 * kNS * kLd   // C and B slices (e o B, gS)
                          + 16 * kQ         // column partials of R
                          + 5 * kQ;         // dA, e, row and column sums, r
constexpr size_t kSmemHeadBytes = sizeof(float) * kSmemHead;
// ssd_bwd_group's: G^'s rows and columns [32][kLd], B and C slices [kQ][33]
constexpr int kRows = 32;
constexpr int kSmemGroup = 2 * kRows * kLd + 2 * kQ * (kNS + 1);
constexpr size_t kSmemGroupBytes = sizeof(float) * kSmemGroup;
constexpr int kSumPerThread = 4;   // ssd_bwd_sum: values a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the sum over the 16 threads of a row of the 16 x 16 grid (lanes 0-15 or
// 16-31 of a warp), the same order in every run
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one block per cell = (batch x chunk) * heads + head
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_head(const T* __restrict__ xdt, const T* __restrict__ bm,
             const T* __restrict__ cm, const float* __restrict__ dacum,
             const float* __restrict__ dt, const float* __restrict__ gy,
             const float* __restrict__ gs, T* __restrict__ gx,
             float* __restrict__ ga, float* __restrict__ gdt,
             float* __restrict__ scratch, int heads, int groups, int q,
             int n, int p) {
  extern __shared__ float smem[];
  float* sc = smem;                  // [kQ][kLd]   M
  float* us = sc + kQ * kLd;         // [kQ][kLdP]  u
  float* gys = us + kQ * kLdP;       // [kQ][kLdP]  gy
  float* cs = gys + kQ * kLdP;       // [kNS][kLd]  C slice, k-major; gS slice
  float* bs = cs + kNS * kLd;        // [kNS][kLd]  B slice, then e o B slice
  float* red = bs + kNS * kLd;       // [16][kQ]    column partials of R
  float* da = red + 16 * kQ;         // [kQ]
  float* ev = da + kQ;               // [kQ]        e
  float* rows = ev + kQ;             // [kQ]        sum_j R_ij
  float* cols = rows + kQ;           // [kQ]        sum_i R_ij
  float* rv = cols + kQ;             // [kQ]        r
  float* gss = cs;                   // [kNS][kLdP] gS slice (second pass)

  const long long cell = blockIdx.x;
  const long long gcell =            // the head's group's B and C
      cell / heads * groups + cell % heads / (heads / groups);
  const T* xg = xdt + cell * q * p;
  const float* gyg = gy + cell * q * p;
  const float* gsg = gs + cell * n * p;
  const T* bg = bm + gcell * q * n;
  const T* cg = cm + gcell * q * n;
  float* glg = scratch + cell * q * (q + n);   // gM o L   [q][q]
  float* sbg = glg + (long long)q * q;         // e o uS^T [q][n]
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  for (int i = t; i < kQ * kP; i += kThreads) {
    const int r = i / kP, col = i % kP;
    const bool in = r < q && col < p;
    us[r * kLdP + col] =
        in ? to_f32(xg[r * p + col]) * (dt ? dt[cell * q + r] : 1.0f) : 0.0f;
    gys[r * kLdP + col] = in ? gyg[r * p + col] : 0.0f;
  }
  for (int i = t; i < kQ; i += kThreads)
    da[i] = i < q ? dacum[cell * q + i] : 0.0f;
  __syncthreads();
  const float d_last = da[q - 1];
  for (int i = t; i < kQ; i += kThreads)
    ev[i] = i < q ? expf(d_last - da[i]) : 0.0f;

  // ---- pass A: C B^T, 8 x 8 a thread (rows ty + 16 r, columns tx + 16 c)
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  for (int n0 = 0; n0 < n; n0 += kNS) {
    const int ns = min(kNS, n - n0);
    __syncthreads();                 // the previous slice is consumed
    for (int i = t; i < kQ * kNS; i += kThreads) {
      const int r = i / kNS, k = i % kNS;
      const bool in = r < q && k < ns;
      cs[k * kLd + r] = in ? to_f32(cg[r * n + n0 + k]) : 0.0f;
      bs[k * kLd + r] = in ? to_f32(bg[r * n + n0 + k]) : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < ns; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = cs[k * kLd + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = bs[k * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  // M = C B^T o L to shared memory
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      sc[i * kLd + j] =
          (j <= i && i < q) ? acc[r][c] * expf(da[i] - da[j]) : 0.0f;
    }
  }
  __syncthreads();

  // ---- gM = gy u^T (j <= i), R = gM o M, G^'s part gM o L
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  for (int k = 0; k < p; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = gys[(ty + 16 * r) * kLdP + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = us[(tx + 16 * c) * kLdP + k];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
  float colp[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) colp[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    float rowp = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      const bool in = j <= i && i < q;
      const float g = in ? acc[r][c] : 0.0f;
      const float rr = g * sc[i * kLd + j];
      rowp += rr;
      colp[c] += rr;
      if (i < q && j < q)
        glg[(long long)i * q + j] = in ? g * expf(da[i] - da[j]) : 0.0f;
    }
    rowp = row_sum16(rowp);
    if (tx == 0) rows[i] = rowp;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) red[ty * kQ + tx + 16 * c] = colp[c];
  __syncthreads();
  for (int j = t; j < kQ; j += kThreads) {
    float s = 0.0f;
    for (int y = 0; y < 16; ++y) s += red[y * kQ + j];
    cols[j] = s;
  }

  // ---- gu = M^T gy, 8 x 4 a thread (rows j = ty + 16 r, columns tx + 16 c)
  float gu[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) gu[r][c] = 0.0f;
  for (int i = ty; i < q; ++i) {     // M_ij = 0 for i < j
    float m[8], g[4];
#pragma unroll
    for (int r = 0; r < 8; ++r) m[r] = sc[i * kLd + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = gys[i * kLdP + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) gu[r][c] = fmaf(m[r], g[c], gu[r][c]);
  }

  // ---- pass B over N: gu += (e o B) gS; W = u gS^T a slice at a time, its
  // e-scaled values to scratch, r_j += sum_n (e o B)_jn W_jn
  float rp[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rp[r] = 0.0f;
  for (int n0 = 0; n0 < n; n0 += kNS) {
    const int ns = min(kNS, n - n0);
    __syncthreads();                 // the previous slice is consumed
    for (int i = t; i < kQ * kNS; i += kThreads) {
      const int r = i / kNS, k = i % kNS;
      bs[k * kLd + r] =
          (r < q && k < ns) ? ev[r] * to_f32(bg[r * n + n0 + k]) : 0.0f;
    }
    for (int i = t; i < kNS * kP; i += kThreads) {
      const int k = i / kP, col = i % kP;
      gss[k * kLdP + col] =
          (k < ns && col < p) ? gsg[(n0 + k) * p + col] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < ns; ++k) {
      float eb[8], g[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) eb[r] = bs[k * kLd + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) g[c] = gss[k * kLdP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) gu[r][c] = fmaf(eb[r], g[c], gu[r][c]);
    }
    float w[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r][0] = w[r][1] = 0.0f;
    for (int k = 0; k < p; ++k) {
      float a[8], b[2];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = us[(ty + 16 * r) * kLdP + k];
#pragma unroll
      for (int c = 0; c < 2; ++c) b[c] = gss[(tx + 16 * c) * kLdP + k];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) w[r][c] = fmaf(a[r], b[c], w[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int nl = tx + 16 * c;
        rp[r] = fmaf(bs[nl * kLd + j], w[r][c], rp[r]);
        if (j < q && nl < ns)
          sbg[(long long)j * n + n0 + nl] = ev[j] * w[r][c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float s = row_sum16(rp[r]);
    if (tx == 0) rv[ty + 16 * r] = s;
  }
  __syncthreads();

  // ---- gdA, and gx and gdt (or gxdt = gu)
  for (int k = t; k < q; k += kThreads) {
    float g = rows[k] - cols[k] - rv[k];
    if (k == q - 1) {
      float s = 0.0f;
      for (int j = 0; j < q; ++j) s += rv[j];
      g += s;
    }
    ga[cell * q + k] = g;
  }
  T* gxg = gx + cell * q * p;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 16 * r;
    const float dtj = (dt && j < q) ? dt[cell * q + j] : 1.0f;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      if (j < q && col < p) {
        gxg[j * p + col] = from_f32<T>(gu[r][c] * dtj);
        if (dt) part = fmaf(gu[r][c], to_f32(xg[j * p + col]), part);
      }
    }
    if (dt) {
      part = row_sum16(part);
      if (tx == 0 && j < q) gdt[cell * q + j] = part;
    }
  }
}

// G^ and the state term of gB summed over a group's heads, in head order,
// into the group's first head's slot; blockIdx.x = (batch x chunk) * groups
// + group, blockIdx.y a chunk of kThreads * kSumPerThread values
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum(float* __restrict__ scratch, int heads, int groups,
            long long per_head) {
  const long long bcg = blockIdx.x;
  const int rep = heads / groups;
  float* base = scratch + (bcg / groups * heads + bcg % groups * rep) *
                              per_head;
  const long long e0 =
      (long long)blockIdx.y * kThreads * kSumPerThread + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kSumPerThread; ++k) {
    const long long e = e0 + (long long)k * kThreads;
    if (e >= per_head) break;
    float s = base[e];
    for (int h = 1; h < rep; ++h) s += base[h * per_head + e];
    base[e] = s;
  }
}

// gC and gB of one group, rows 32 * blockIdx.y onwards; blockIdx.x =
// (batch x chunk) * groups + group
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group(const T* __restrict__ bm, const T* __restrict__ cm,
              const float* __restrict__ scratch, T* __restrict__ gb,
              T* __restrict__ gc, int heads, int groups, int q, int n) {
  extern __shared__ float smem[];
  float* grow = smem;                // [kRows][kLd]    G^ rows r0 + r
  float* gcol = grow + kRows * kLd;  // [kRows][kLd]    G^ columns r0 + r
  float* bsl = gcol + kRows * kLd;   // [kQ][kNS + 1]   B slice
  float* csl = bsl + kQ * (kNS + 1); // [kQ][kNS + 1]   C slice

  const long long bcg = blockIdx.x;
  const int rep = heads / groups;
  const float* gl = scratch + (bcg / groups * heads + bcg % groups * rep) *
                                  (long long)q * (q + n);
  const float* sb = gl + (long long)q * q;
  const T* bg = bm + bcg * q * n;
  const T* cg = cm + bcg * q * n;
  T* gbg = gb + bcg * q * n;
  T* gcg = gc + bcg * q * n;
  const int r0 = kRows * blockIdx.y, nr = min(kRows, q - r0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int i = t; i < kRows * kQ; i += kThreads) {
    const int r = i / kQ, j = i % kQ;
    grow[r * kLd + j] = (r < nr && j < q) ? gl[(long long)(r0 + r) * q + j]
                                          : 0.0f;
  }
  for (int i = t; i < kQ * kRows; i += kThreads) {
    const int j = i / kRows, r = i % kRows;
    gcol[r * kLd + j] = (r < nr && j < q) ? gl[(long long)j * q + r0 + r]
                                          : 0.0f;
  }
  for (int n0 = 0; n0 < n; n0 += kNS) {
    const int ns = min(kNS, n - n0);
    __syncthreads();                 // G^ staged; the previous slice consumed
    for (int i = t; i < kQ * kNS; i += kThreads) {
      const int j = i / kNS, k = i % kNS;
      const bool in = j < q && k < ns;
      bsl[j * (kNS + 1) + k] = in ? to_f32(bg[j * n + n0 + k]) : 0.0f;
      csl[j * (kNS + 1) + k] = in ? to_f32(cg[j * n + n0 + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kRows / 8; ++s) {
      const int r = warp + 8 * s;
      float sc = 0.0f, sbv = 0.0f;
      for (int j = 0; j < q; ++j) {
        sc = fmaf(grow[r * kLd + j], bsl[j * (kNS + 1) + lane], sc);
        sbv = fmaf(gcol[r * kLd + j], csl[j * (kNS + 1) + lane], sbv);
      }
      if (r < nr && lane < ns) {
        const long long o = (long long)(r0 + r) * n + n0 + lane;
        gcg[o] = from_f32<T>(sc);
        gbg[o] = from_f32<T>(sbv + sb[o]);
      }
    }
  }
}

template <typename T>
int launch(const void* xdt, const void* b, const void* c, const float* dacum,
           const float* dt, const float* gy, const float* gs, void* gx,
           void* gb, void* gc, float* ga, float* gdt, float* scratch, int bc,
           int heads, int groups, int q, int n, int p, cudaStream_t stream) {
  const long long cells = (long long)bc * heads;
  const long long gcells = (long long)bc * groups;
  const long long per_head = (long long)q * (q + n);
  const long long chunks =
      (per_head + kThreads * kSumPerThread - 1) / (kThreads * kSumPerThread);
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_head<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemHeadBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_bwd_group<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemGroupBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  ssd_bwd_head<T><<<(unsigned)cells, kThreads, kSmemHeadBytes, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(b),
      static_cast<const T*>(c), dacum, dt, gy, gs, static_cast<T*>(gx), ga,
      gdt, scratch, heads, groups, q, n, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (heads > groups) {
    ssd_bwd_sum<<<dim3((unsigned)gcells, (unsigned)chunks), kThreads, 0,
                  stream>>>(scratch, heads, groups, per_head);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ssd_bwd_group<T><<<dim3((unsigned)gcells, (q + kRows - 1) / kRows),
                     kThreads, kSmemGroupBytes, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), scratch,
      static_cast<T*>(gb), static_cast<T*>(gc), heads, groups, q, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x (or xdt), B, C in float32 or bf16 (bf16 != 0); dacum, dt (may be null),
// gy, gs float32; gx, gb, gc in the inputs' dtype; ga and gdt (null where dt
// is) float32; scratch bc * heads * q * (q + n) floats.
extern "C" int ssd_inner_bwd(const void* xdt, const void* b, const void* c,
                             const float* dacum, const float* dt,
                             const float* gy, const float* gs, void* gx,
                             void* gb, void* gc, float* ga, float* gdt,
                             float* scratch, int bc, int heads, int groups,
                             int q, int n, int p, int bf16,
                             cudaStream_t stream) {
  if (bc == 0) return 0;
  if (bc < 0 || heads < 1 || groups < 1 || heads % groups != 0 || q < 1 ||
      q > kQ || n < 1 || n > kN || p < 1 || p > kP || (dt && !gdt))
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(xdt, b, c, dacum, dt, gy, gs, gx, gb,
                                      gc, ga, gdt, scratch, bc, heads,
                                      groups, q, n, p, stream)
              : launch<float>(xdt, b, c, dacum, dt, gy, gs, gx, gb, gc, ga,
                              gdt, scratch, bc, heads, groups, q, n, p,
                              stream);
}
