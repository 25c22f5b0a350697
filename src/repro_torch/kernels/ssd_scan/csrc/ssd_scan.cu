// Mamba2 SSD within-chunk block, by hand for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::
// ssd_inner (body _ssd_kernel).  For each (batch, chunk, head) cell, with
// xdt [Q, P], B and C [Q, N] and the in-chunk cumulative decay dA [Q]:
//
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(dA_i - dA_j) * xdt_j        [Q, P]
//   state = sum_j exp(dA_{Q-1} - dA_j) * B_j^T xdt_j                    [N, P]
//
// all in float32, as the TPU kernel (preferred_element_type=f32).  The
// cross-chunk recurrence and the off-diagonal term stay outside (ops.py).
//
// Design.  One block of 256 threads per cell, a 16 x 16 thread grid.  The TPU
// kernel holds B, C and xdt whole in VMEM; at Q = N = 128 the B and C tiles
// alone are 64 KB each in float32, and the [Q, Q] score tile another 64 KB.
// Here N is streamed in slices of 32: each slice of C and B is staged in
// shared memory k-major (row stride Q + 1, so the transposing store is free of
// bank conflicts), every thread accumulates its 8 x 8 scores C.B^T in
// registers (rows ty + 16r, columns tx + 16c), and the same slice of B, scaled
// by exp(dA_last - dA), gives that slice's 32 rows of the state against xdt,
// which stays in shared memory.  Then the decay mask is applied to the
// register scores, which go to shared memory once, and y = scores . xdt.  That
// holds C/B slices (33 KB), scores (66 KB), xdt (32 KB) and dA (1 KB): 133 KB
// of dynamic shared memory, above the 48 KB default, so the host entry sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before the first launch (a
// launch without it is refused, which only cudaGetLastError() shows).  One
// block fits on an SM; the main path's 768 cells are about six waves on 132
// SMs.  Q <= 128, N <= 128 and P <= 64, any of them below (the chunk of a
// 200-token prompt is 100): tiles are zero-padded, and stores are masked.
//
// Bound on an H100 SXM: operations.  The function needs only the causal
// half of the score tile: per cell Q (Q + 1) N (C.B^T for j <= i) +
// Q (Q + 1) P (scores . xdt over j <= i) + 2 Q N P (state) flops = 5.27 MFLOP
// at Q = N = 128, P = 64; the main path's prefill (8 x 512 tokens, 24 heads:
// 768 cells) needs 4.05 GFLOP, 60 us at the 67 TFLOP/s float32 peak, against
// 176 MB moved, 53 us at 3.35 TB/s.  The kernel stays on the float32 FMA
// units, as the TPU kernel's numerics ask; TF32 or bf16 tensor cores (wgmma)
// would lift that bound and change the numerics, and are later work.  Like
// the TPU kernel it computes the full [Q, Q] score tile and masks it: 8.39
// MFLOP per cell, 1.6 times the work the function needs.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns a cudaError_t code.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 128;            // largest chunk
constexpr int kP = 64;             // largest head dim
constexpr int kN = 128;            // largest state dim
constexpr int kNS = 32;            // N slice staged per step
constexpr int kLd = kQ + 1;        // padded row stride
constexpr int kThreads = 256;
constexpr int kSmemFloats = 2 * kNS * kLd + kQ * kLd + kQ * kP + 2 * kQ;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__global__ void __launch_bounds__(kThreads, 1)
ssd_inner_kernel(const float* __restrict__ xdt, const float* __restrict__ bm,
                 const float* __restrict__ cm,
                 const float* __restrict__ dacum, float* __restrict__ y,
                 float* __restrict__ states, int q, int n, int p) {
  extern __shared__ float smem[];
  float* cs = smem;                  // [kNS][kLd]  C slice, k-major
  float* bs = cs + kNS * kLd;        // [kNS][kLd]  B slice, k-major
  float* sc = bs + kNS * kLd;        // [kQ][kLd]   masked scores
  float* xs = sc + kQ * kLd;         // [kQ][kP]    xdt
  float* da = xs + kQ * kP;          // [kQ]        dA cumsum
  float* wl = da + kQ;               // [kQ]        exp(dA_last - dA)

  const long long cell = blockIdx.x;
  const float* xg = xdt + cell * q * p;
  const float* bg = bm + cell * q * n;
  const float* cg = cm + cell * q * n;
  float* yg = y + cell * q * p;
  float* sg = states + cell * n * p;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  for (int i = t; i < kQ * kP; i += kThreads) {
    const int r = i / kP, col = i % kP;
    xs[i] = (r < q && col < p) ? xg[r * p + col] : 0.0f;
  }
  for (int i = t; i < kQ; i += kThreads) da[i] = i < q ? dacum[cell * q + i] : 0.0f;
  __syncthreads();
  const float d_last = da[q - 1];
  for (int i = t; i < kQ; i += kThreads)
    wl[i] = i < q ? expf(d_last - da[i]) : 0.0f;

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
      cs[k * kLd + r] = in ? cg[r * n + n0 + k] : 0.0f;
      bs[k * kLd + r] = in ? bg[r * n + n0 + k] : 0.0f;
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
    // this slice's state rows: n0 + ty + 16 r2, columns tx + 16 c
#pragma unroll
    for (int r2 = 0; r2 < kNS / 16; ++r2) {
      const int nl = ty + 16 * r2;
      if (nl >= ns) continue;
      float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < q; ++j) {
        const float bw = bs[nl * kLd + j] * wl[j];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st[c] = fmaf(bw, xs[j * kP + tx + 16 * c], st[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < p) sg[(n0 + nl) * p + tx + 16 * c] = st[c];
    }
  }

  // decay mask L[i, j] = exp(dA_i - dA_j) for j <= i, else 0
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

  float ya[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ya[r][c] = 0.0f;
  for (int j = 0; j < q; ++j) {
    float xv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) xv[c] = xs[j * kP + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float s = sc[(ty + 16 * r) * kLd + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) ya[r][c] = fmaf(s, xv[c], ya[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    if (i >= q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tx + 16 * c < p) yg[i * p + tx + 16 * c] = ya[r][c];
  }
}

}  // namespace

// xdt [cells, q, p], b and c [cells, q, n], dacum [cells, q] -> y [cells, q,
// p], states [cells, n, p]; all float32, contiguous.  cells = B * Nc * H.
extern "C" int ssd_inner(const float* xdt, const float* b, const float* c,
                         const float* dacum, float* y, float* states,
                         long long cells, int q, int n, int p,
                         cudaStream_t stream) {
  if (cells <= 0) return 0;
  if (q < 1 || q > kQ || n < 1 || n > kN || p < 1 || p > kP ||
      cells > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_inner_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  ssd_inner_kernel<<<(unsigned)cells, kThreads, kSmemBytes, stream>>>(
      xdt, b, c, dacum, y, states, q, n, p);
  return (int)cudaGetLastError();
}
