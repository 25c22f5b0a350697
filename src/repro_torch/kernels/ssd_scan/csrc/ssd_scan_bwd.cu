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
// to nearest even as torch's cast), gdA and gdt in float32.  No atomics:
// every sum is taken in an order fixed by the shapes, so every result is the
// same bits from run to run.  Two routes, picked by the dtype and the shapes
// (ops.py's bwd_plan):
//
// Tensor-core route (bf16 x, B and C with N and P multiples of 8 and x, B, C,
// gy and gS 16-byte aligned: every shape a model trains; two launches).
//   ssd_bwd_wg    one block per (batch x chunk, group, slice of hb heads of
//                 the group), slices the most that keep the grid within one
//                 wave of the card's SMs (4 at the mamba2-130m and zamba2-7b
//                 train steps: 8 x 4 x 1 x 4 = 128 blocks on 132 SMs; hb 6
//                 and 28).  Two warpgroups of one role, 256 threads at up
//                 to 255 registers: no setmaxnreg split, so no register
//                 count can leave one waiting (ptxas gives 255 and keeps
//                 part of the accumulators that live across heads in local
//                 memory; phase 2 of chip_smoke.py prints the spills).
//                 Shared memory 215 KB at N = 128 (B, S^T over C, the x
//                 and gy rings, gS, dA and dt, gdA's exchange), one block an
//                 SM.  Everything is computed in the transposed ("j rows")
//                 layout, so that M^T's accumulator fragments are the A
//                 fragments of M^T gy:
//     1. once per block, TMA brings B and C (128 x N bf16, 128-byte
//        swizzle) and S^T = B C^T is issued (wgmma m64n64k16 from shared
//        memory) over its three causal 64 x 64 tiles, (j0, i0) and (j0, i1)
//        by warpgroup 0, (j1, i1) by warpgroup 1; S^T goes to shared memory
//        in float32 (thread-major, conflict-free) over C's place;
//     2. per head, x comes by TMA through a two-stage ring (head h + 2
//        loads while h computes); gy and gS, float32, come by bulk copy
//        (cp.async.bulk) into the buffers of their bf16 terms, gy a head
//        ahead (two stages), gS as soon as the head's products with the
//        previous gS are done (one buffer, released by an mbarrier), and
//        at the end of the head before are split in place by all threads
//        into two bf16 terms each, hi = bf16(v) and lo = bf16(v - hi) (16
//        significant bits), in swizzled tiles;
//     3. gM^T = x gy^T (gy's terms), scaled by dt_j, is formed per causal
//        tile: R = gM o M gives gdA's row and column sums (shuffles, then
//        a fixed order across warps through shared memory), and gM o L
//        adds into G^T, kept in registers for all hb heads;
//     4. B gS (B read as it is, gS's terms MN-major) gives e o (B gS), the
//        first part of gu, and r_j = e_j dt_j sum_p x_jp (B gS)_jp; x gS^T
//        (x as it is, gS's terms K-major), scaled by e_j dt_j in registers,
//        adds the head's state term of gB into a float32 accumulator that
//        stays in registers for all hb heads.  dt folds into row and column
//        scales, so the bf16 x is an exact operand everywhere;
//     5. M^T = S^T o L (exp2 of the dA difference taken first, as in the
//        forward) is split into hi + lo A fragments and gu += M^T gy issued
//        as hi gy_hi + hi gy_lo + lo gy_hi (wgmma m64n64k16, A from
//        registers, gy MN-major).  Warpgroup 0 owns gu rows j0 (M^T tiles
//        (j0, i0), (j0, i1)) and gM^T tile (j0, i0); warpgroup 1 gu rows j1
//        ((j1, i1)) and gM^T tiles (j1, i1) and (j0, i1): about equal work
//        each;
//     6. gx = gu dt (bf16) and gdt = sum_p gu x from the accumulators, gdA
//        from the exchanged sums (sum_j r_j by a fixed shuffle tree);
//   and at the block's end its G^T tiles and state term go, float32 and
//   thread-major, to the per-slice buffer.
//   ssd_bwd_gbc   a block of one warpgroup per (batch x chunk, group, one of
//                 gB's or gC's two 64-row halves): G^T summed over the
//                 group's slices in slice order (gB's state term likewise,
//                 the accumulator's start), split into hi + lo A fragments
//                 (gC reads G^ = (G^T)^T from shared memory transposed), and
//                 gB = G^T C or gC = G^ B issued over the causal tiles
//                 (wgmma, N = 64 or 128, C or B MN-major); cast and stored.
//   Builds for N = 64 (zamba2-7b, and the smoke configs' 16) and N = 128
//   (mamba2-130m): each computes only its build's columns.  The per-slice
//   buffer is [batch x chunk x groups x slices, 3 x 64 x 64 + 128 N]
//   float32, written once and read once: 14.7 MB at mamba2-130m's [8, 4,
//   24, 128, 64] with N = 128, 10.5 MB at zamba2-7b's [8, 4, 112, 128, 64]
//   with N = 64 (the SIMT route's per-head scratch is 100.7 and 352.3 MB).
//   Why two terms: test_bwd_kernel_order_witness (in
//   tests/test_torch_ssd_scan.py) emulates this arithmetic and holds it
//   against the plain version (gdA and gdt at 1e-4 of their largest
//   entry, gx, gB and gC by the spread rule); with one term fewer on gy,
//   gS, M or G^ a gradient exceeds or approaches its limit.
//
// SIMT route (float32 throughout; and bf16 that the tensor-core route cannot
// take, N or P not a multiple of 8 or an operand not 16-byte aligned):
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
// Its scratch is [cells x heads, Q, Q + N] float32 (352.3 MB at zamba2-7b's
// [8, 4, 112, 128, 64] with N = 64, 100.7 MB at mamba2-130m's), allocated by
// the wrapper.  It runs the float32 checks against the CPU and bf16 shapes
// that no model trains.
//
// Bound on an H100 SXM at the mamba2-130m train step (x [8, 4, 24, 128, 64]
// bf16, N = 128, G = 1): bytes.  Reads x 12.6 MB, B and C 1.0 MB each, dA and
// dt 0.4 MB each, gy and gS 25.2 MB each; writes gx 12.6 MB, gB and gC 1.0
// MB each, gdA and gdt 0.4 MB each: 81.3 MB, 24.3 us at 3.35 TB/s.  The
// causal products (C B^T, gC and gB once per group; M^T gy, gy u^T, B gS and
// u gS^T per head) are 5.1 GFLOP: 5 us at the bf16 tensor-core rate, 76 us
// at the float32 SIMT rate of 67 TFLOP/s (the SIMT route's yardstick; it
// also recomputes C B^T per head and writes and reads its scratch).  The
// tensor-core route issues more products than that (the terms, and the full
// 64 x 64 diagonal tiles): not counted as needed work.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns a cudaError_t code.

#include "../../csrc/hopper.cuh"  // wgmma, TMA and mbarrier helpers

namespace {

constexpr int kQ = 128;            // largest chunk
constexpr int kP = 64;             // largest head dim
constexpr int kN = 128;            // largest state dim

// ------------------------------------------------------------------ SIMT
namespace simt {

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

}  // namespace simt

// ----------------------------------------------------------- tensor cores
namespace wgb {

using namespace hopper;

constexpr int kThreads = 256;          // ssd_bwd_wg: two warpgroups
constexpr int kGbcThreads = 128;       // ssd_bwd_gbc: one warpgroup
constexpr int kTile = 64 * 64;         // floats of a 64 x 64 tile
constexpr int kGtLd = 68;              // ssd_bwd_gbc's G^T row stride (floats)
constexpr float kLog2e = 1.4426950408889634f;
// mbarrier slots: bc_full, x_full and gy_full per stage, gs_full, gs_empty
constexpr int kBCFull = 0, kXFull = 1, kGyFull = 3, kGsFull = 5,
              kGsEmpty = 6, kBarriers = 7;

// ssd_bwd_wg's shared memory (byte offsets; tiles 1024-byte aligned)
template <int kNb>
struct Smem {
  static constexpr int kXBytes = kQ * kP * 2;       // x or a gy term [128][64]
  static constexpr int kGsBytes = kNb * kP * 2;     // [N][64] bf16: a gS term
  static constexpr int kB = 0;                      // B [128][N] bf16
  static constexpr int kS = kB + kQ * kNb * 2;      // S^T (3 float32 tiles), C
  static constexpr int kX = kS + 3 * kTile * 4;     // x, 2 stages
  static constexpr int kGy = kX + 2 * kXBytes;      // gy, 2 stages x 2 terms
  static constexpr int kGs = kGy + 4 * kXBytes;     // gS, 2 terms
  static constexpr int kDa = kGs + 2 * kGsBytes;    // dA and dt, 2 stages
  static constexpr int kEx = kDa + 2 * 2 * kQ * 4;  // gdA's exchange:
  // R's row sums [3 tiles][64], column sums [3 tiles][4 warps][64], r [128]
  static constexpr int kRowsEx = 0, kColsEx = 3 * 64,
                       kREx = kColsEx + 3 * 4 * 64;
  static constexpr int kBars = kEx + (kREx + kQ) * 4;
  // + slack to align the dynamic shared memory's start to 1024 bytes
  static constexpr size_t kBytes = kBars + 8 * kBarriers + 1024;
  static_assert(kQ * kNb * 2 <= 3 * kTile * 4, "C must fit where S^T goes");
};
static_assert(Smem<128>::kBytes <= 232448, "ssd_bwd_wg's shared memory");

// ssd_bwd_gbc's: C or B [128][N] bf16, then two G^T tiles [64][kGtLd] float32
template <int kNb>
struct GbcSmem {
  static constexpr int kOp = 0;
  static constexpr int kGt = kQ * kNb * 2;
  static constexpr size_t kBytes = kGt + 2 * 64 * kGtLd * 4 + 1024;
};

// floats of one block's part of the per-slice buffer: its G^T tiles, then
// its state term, both thread-major
template <int kNb>
struct Part {
  static constexpr long long kFloats = 3 * kTile + kQ * kNb;
};

__device__ __forceinline__ void sync_all() { named_sync(1, kThreads); }

// the sum over the 4 lanes of a quad (one accumulator row's columns)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// (a, b) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// the bf16 pair (row j, columns c and c + 1; c even) of a swizzled [rows][64]
// tile
__device__ __forceinline__ float2 pair_at(const unsigned char* tile, int j,
                                          int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + j * 128 + (((c >> 3) ^ (j & 7)) << 4) + ((c & 7) << 1)));
}

// A float32 [rows, cols] row-major matrix (cols <= 64 and a multiple of 8,
// 16-byte aligned) and its two bf16 terms, hi = bf16(v) and lo = bf16(v -
// hi), in swizzled [kRows][64] tiles at dst and dst + kRows * 128, zeros
// past rows and cols.  All kThreads threads take part, thread tid the
// 16-byte chunks (8 values) tid + kThreads it: read() loads them (from
// global or shared memory), write() stores their terms, so that a matrix
// can be split in place over its own rows once every thread has read.
template <int kRows>
struct Chunks {
  static constexpr int kCount = kRows * 8 / kThreads;
  float4 v[kCount][2];

  __device__ __forceinline__ void read(const float* src, int rows, int cols,
                                       int tid) {
#pragma unroll
    for (int it = 0; it < kCount; ++it) {
      const int idx = tid + it * kThreads, r = idx >> 3, c = idx & 7;
      v[it][0] = v[it][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && 8 * c < cols) {
        const float4* at = reinterpret_cast<const float4*>(src + r * cols +
                                                           8 * c);
        v[it][0] = at[0];
        v[it][1] = at[1];
      }
    }
  }

  __device__ __forceinline__ void write(unsigned char* dst, int tid) const {
#pragma unroll
    for (int it = 0; it < kCount; ++it) {
      const int idx = tid + it * kThreads, r = idx >> 3, c = idx & 7;
      const float f[8] = {v[it][0].x, v[it][0].y, v[it][0].z, v[it][0].w,
                          v[it][1].x, v[it][1].y, v[it][1].z, v[it][1].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2(f[2 * e], f[2 * e + 1], hi[e], lo[e]);
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(dst + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + kRows * 128 + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
};

// the first head's gy and gS terms (stage 0) and its dA and dt, past q
// dA_last (every decay stays finite) and dt 0, from global memory
template <int kNb>
__device__ __forceinline__ void stage_first(unsigned char* smem,
                                            long long cell,
                                            const float* __restrict__ dacum,
                                            const float* __restrict__ dt,
                                            const float* __restrict__ gy,
                                            const float* __restrict__ gs,
                                            int q, int n, int p) {
  using L = Smem<kNb>;
  const int tid = threadIdx.x;
  {
    Chunks<kQ> c;
    c.read(gy + cell * q * p, q, p, tid);
    c.write(smem + L::kGy, tid);
  }
  {
    Chunks<kNb> c;
    c.read(gs + cell * n * p, n, p, tid);
    c.write(smem + L::kGs, tid);
  }
  if (tid < kQ) {
    float* da = reinterpret_cast<float*>(smem + L::kDa);
    const float* dg = dacum + cell * q;
    da[tid] = dg[tid < q ? tid : q - 1];
    da[kQ + tid] = dt ? (tid < q ? dt[cell * q + tid] : 0.0f) : 1.0f;
  }
  fence_async_smem();
}

// thread tw's rows (r0, r0 + 8) and columns (8 jj + cq, + 1) of a 64 x 64
// accumulator: acc[4 jj + 2 half + e] is row r0 + 8 half, column 8 jj + cq + e
struct Frag {
  int tw, lane, r0, cq;
  __device__ __forceinline__ Frag() {
    tw = threadIdx.x & 127;
    lane = threadIdx.x & 31;
    r0 = 16 * (tw >> 5) + (lane >> 2);
    cq = 2 * (lane & 3);
  }
};

// L_ji = exp(dA_i - dA_j) for i >= j (where kDiag; i >= j throughout the
// tile right of the diagonal), i < q and j < q, else 0 (selected, never
// multiplied, so that an overflowing exp never meets a 0)
template <bool kDiag>
__device__ __forceinline__ float decay(float di, float dj, int i, int j,
                                       int q) {
  return ((!kDiag || i >= j) && i < q && j < q) ? ex2((di - dj) * kLog2e)
                                                : 0.0f;
}

// gM^T = (x gy^T) o dt_j over the causal tile (jt, it): gdA's sums of R =
// gM o M into the exchange (row sums at its j, column sums at its i), and gM
// o L added to the warpgroup's G^T tile gh
template <int kNb, bool kDiag>
__device__ __forceinline__ void gm_tile(float (&gh)[32], const float* sst,
                                        float* ex, int tile, uint32_t xs,
                                        uint32_t gys, const float* da_k,
                                        const float* dt_k, int jt, int it,
                                        int q) {
  using L = Smem<kNb>;
  const Frag f;
  float acc[32];
  {
    const uint64_t dx = descriptor(xs + 64 * jt * 128, 16, 1024);
    const uint64_t dg = descriptor(gys + 64 * it * 128, 16, 1024);
    int overwrite = 0, accumulate = 1;
    asm volatile("" : "+r"(overwrite), "+r"(accumulate));
    zero(acc);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(acc, dx + ((kk * 32) >> 4),
                 dg + ((u * L::kXBytes + kk * 32) >> 4),
                 (u | kk) ? accumulate : overwrite);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  }
  const int j0 = 64 * jt + f.r0;
  const float dj[2] = {da_k[j0], da_k[j0 + 8]};
  const float tj[2] = {dt_k[j0], dt_k[j0 + 8]};
  const float* st = sst + tile * 32 * 128 + f.tw;
  float rs[2] = {0.0f, 0.0f}, cs[16];     // cs[2 jj + e]: column 8 jj + cq + e
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int i = 64 * it + 8 * jj + f.cq;
    const float2 di = *reinterpret_cast<const float2*>(&da_k[i]);
    cs[2 * jj] = cs[2 * jj + 1] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * jj + 2 * half + e;
        const float l = decay<kDiag>(e ? di.y : di.x, dj[half], i + e,
                                     j0 + 8 * half, q);
        const float g = acc[idx] * tj[half];
        const float r = g * (st[idx * 128] * l);
        rs[half] += r;
        cs[2 * jj + e] += r;
        gh[idx] += g * l;
      }
  }
  // the 16 column sums over the warp's rows, their shuffle trees side by
  // side
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int v = 0; v < 16; ++v)
      cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], off);
  if (f.lane < 4) {
    float* col = ex + L::kColsEx + (tile * 4 + (f.tw >> 5)) * 64 + f.cq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float2*>(col + 8 * jj) =
          make_float2(cs[2 * jj], cs[2 * jj + 1]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float r = quad_sum(rs[half]);
    if ((f.lane & 3) == 0) ex[L::kRowsEx + tile * 64 + f.r0 + 8 * half] = r;
  }
}

// gu += M^T gy over the causal tile (jt, it): M^T = S^T o L as hi + lo A
// fragments, against gy's terms read MN-major (rows i of the tile)
template <int kNb, bool kDiag>
__device__ __forceinline__ void gu_tile(float (&gu)[32], const float* sst,
                                        int tile, uint32_t gys,
                                        const float* da_k, int jt, int it,
                                        int q) {
  using L = Smem<kNb>;
  const Frag f;
  uint32_t hi[4][4], lo[4][4];
  {
    const int j0 = 64 * jt + f.r0;
    const float dj[2] = {da_k[j0], da_k[j0 + 8]};
    const float* st = sst + tile * 32 * 128 + f.tw;
    // register r of k16 step kk: row j0 + 8 (r & 1), columns 16 kk + 8 (r
    // >> 1) + cq and + 1 (accumulator entries 8 kk + 2 r and + 1)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 64 * it + 16 * kk + 8 * (r >> 1) + f.cq;
        const int j = j0 + 8 * (r & 1);
        const float2 di = *reinterpret_cast<const float2*>(&da_k[i]);
        const int idx = 8 * kk + 2 * r;
        split2(st[idx * 128] * decay<kDiag>(di.x, dj[r & 1], i, j, q),
               st[(idx + 1) * 128] * decay<kDiag>(di.y, dj[r & 1], i + 1, j, q),
               hi[kk][r], lo[kk][r]);
      }
  }
  const uint64_t dg = descriptor(gys, kQ * 128, 1024);
  pin(gu);
  pin(hi);
  pin(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t rows = (64 * it + 16 * kk) * 128;
    wgmma_rs_n64(gu, hi[kk], dg + (rows >> 4), 1);
    wgmma_rs_n64(gu, hi[kk], dg + ((L::kXBytes + rows) >> 4), 1);
    wgmma_rs_n64(gu, lo[kk], dg + (rows >> 4), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(gu);
  pin(hi);
  pin(lo);
}

// Warpgroup kWg of one ssd_bwd_wg block: S^T's tiles, then every head.
template <int kNb, int kWg>
__device__ __forceinline__ void body(
    unsigned char* smem, uint32_t base, uint32_t bars, const CUtensorMap* tx,
    const float* __restrict__ dacum, const float* __restrict__ dt,
    const float* __restrict__ gy, const float* __restrict__ gs,
    bf16* __restrict__ gx, float* __restrict__ ga, float* __restrict__ gdt,
    float* __restrict__ part, long long cell0, int hb, int q, int n, int p) {
  using L = Smem<kNb>;
  constexpr int kNT = kWg == 0 ? 2 : 1;  // S^T tiles (j0,i0), (j0,i1) | (j1,i1)
  constexpr int kGh = kWg == 0 ? 1 : 2;  // G^T tiles: 0 | 2, 1
  const Frag f;
  const int tid = threadIdx.x;
  float* sst = reinterpret_cast<float*>(smem + L::kS);
  float* ex = reinterpret_cast<float*>(smem + L::kEx);
  int overwrite = 0, accumulate = 1;
  asm volatile("" : "+r"(overwrite), "+r"(accumulate));

  // 1. S^T = B C^T over this warpgroup's causal tiles, once for all heads
  {
    float sacc[kNT][32];
    const uint64_t da_ = descriptor(base + L::kB + 64 * kWg * 128, 16, 1024);
    const uint64_t dc = descriptor(base + L::kS, 16, 1024);
    mbar_wait(bars + 8 * kBCFull, 0);
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      zero(sacc[t]);
      pin(sacc[t]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int it = kWg == 0 ? t : 1;
#pragma unroll
      for (int kk = 0; kk < kNb / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kQ * 128 + (kk & 3) * 32;
        wgmma_ss(sacc[t], da_ + (off >> 4),
                 dc + ((off + 64 * it * 128) >> 4),
                 kk == 0 ? overwrite : accumulate);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kNT; ++t) pin(sacc[t]);
    sync_all();                      // both warpgroups are done with C
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int tile = kWg == 0 ? t : 2;
#pragma unroll
      for (int r = 0; r < 32; ++r)
        sst[(tile * 32 + r) * 128 + f.tw] = sacc[t][r];
    }
    sync_all();                      // S^T and head 0's terms are in place
  }

  float gh[kGh][32];
  float sb[kNb / 2];                 // the state term of gB, rows of kWg
#pragma unroll
  for (int g = 0; g < kGh; ++g) zero(gh[g]);
  zero(sb);
  const int jr = 64 * kWg + f.r0;    // gu's rows jr, jr + 8

  for (int k = 0; k < hb; ++k) {
    const int s = k & 1;
    const bool more = k + 1 < hb;
    const long long cell = cell0 + k;
    const float* da_k =
        reinterpret_cast<const float*>(smem + L::kDa) + s * 2 * kQ;
    const float* dt_k = da_k + kQ;
    const uint32_t xs = base + L::kX + s * L::kXBytes;
    const uint32_t gys = base + L::kGy + s * 2 * L::kXBytes;
    const unsigned char* xt = smem + L::kX + s * L::kXBytes;
    float tj[2], ej[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = jr + 8 * half;
      tj[half] = dt_k[j];
      ej[half] = ex2((da_k[kQ - 1] - da_k[j]) * kLog2e);   // dA_last - dA_j
    }
    mbar_wait(bars + 8 * (kXFull + s), (k >> 1) & 1);

    // 2. gM^T per causal tile: R's sums into the exchange, gM o L into G^T
    if constexpr (kWg == 0) {
      gm_tile<kNb, true>(gh[0], sst, ex, 0, xs, gys, da_k, dt_k, 0, 0, q);
    } else {
      gm_tile<kNb, true>(gh[0], sst, ex, 2, xs, gys, da_k, dt_k, 1, 1, q);
      gm_tile<kNb, false>(gh[kGh - 1], sst, ex, 1, xs, gys, da_k, dt_k, 0, 1,
                          q);
    }

    // 3. gu = e o (B gS), r = e dt sum_p x (B gS), and the state term
    // sb += (e dt) o (x gS^T), N in columns of 64
    float gu[32];
    {
      const uint64_t dbm = descriptor(base + L::kB + 64 * kWg * 128, 16, 1024);
      const uint64_t dgm = descriptor(base + L::kGs, kNb * 128, 1024);
      zero(gu);
      pin(gu);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int kk = 0; kk < kNb / 16; ++kk)
          wgmma_ss<0, 1>(
              gu, dbm + (((kk >> 2) * kQ * 128 + (kk & 3) * 32) >> 4),
              dgm + ((u * L::kGsBytes + kk * 16 * 128) >> 4),
              (u | kk) ? accumulate : overwrite);
      wgmma_commit();
      wgmma_wait<0>();
      pin(gu);
      float rp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 xv = pair_at(xt, jr + 8 * half, 8 * jj + f.cq);
          rp[half] += xv.x * gu[4 * jj + 2 * half] +
                      xv.y * gu[4 * jj + 2 * half + 1];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float r = quad_sum(rp[half]);
        if ((f.lane & 3) == 0)
          ex[L::kREx + jr + 8 * half] = r * ej[half] * tj[half];
      }
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) gu[idx] *= ej[(idx >> 1) & 1];
      const uint64_t dx = descriptor(xs + 64 * kWg * 128, 16, 1024);
      const uint64_t dgk = descriptor(base + L::kGs, 16, 1024);
#pragma unroll
      for (int c = 0; c < kNb / 64; ++c) {
        float w[32];
        zero(w);
        pin(w);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(w, dx + ((kk * 32) >> 4),
                     dgk + ((u * L::kGsBytes + 64 * c * 128 + kk * 32) >> 4),
                     (u | kk) ? accumulate : overwrite);
        wgmma_commit();
        wgmma_wait<0>();
        pin(w);
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          sb[32 * c + idx] +=
              ej[(idx >> 1) & 1] * tj[(idx >> 1) & 1] * w[idx];
      }
    }
    // this warp is done with gS's terms; once all are, warpgroup 1's first
    // thread brings the next head's gS, float32, over them (warpgroup 0 has
    // the lighter step 2 and is there first)
    __syncwarp();
    if (f.lane == 0) mbar_arrive(bars + 8 * kGsEmpty);
    if (kWg == 1 && f.tw == 0 && more) {
      mbar_wait(bars + 8 * kGsEmpty, k & 1);
      mbar_expect_tx(bars + 8 * kGsFull, (uint32_t)(n * p * 4));
      bulk_load(base + L::kGs, gs + (cell + 1) * n * p, (uint32_t)(n * p * 4),
                bars + 8 * kGsFull);
    }

    // 4. gu += M^T gy
    if constexpr (kWg == 0) {
      gu_tile<kNb, true>(gu, sst, 0, gys, da_k, 0, 0, q);
      gu_tile<kNb, false>(gu, sst, 1, gys, da_k, 0, 1, q);
    } else {
      gu_tile<kNb, true>(gu, sst, 2, gys, da_k, 1, 1, q);
    }

    // 5. gx = gu dt (bf16) and gdt = sum_p gu x
    {
      bf16* gxg = gx + cell * q * p;
      float part_[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + f.cq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = jr + 8 * half;
          const float2 xv = pair_at(xt, j, c);
          const float a = gu[4 * jj + 2 * half], b = gu[4 * jj + 2 * half + 1];
          part_[half] += a * xv.x + b * xv.y;
          if (j < q && c < p)
            *reinterpret_cast<__nv_bfloat162*>(gxg + (long long)j * p + c) =
                __floats2bfloat162_rn(a * tj[half], b * tj[half]);
        }
      }
      if (dt != nullptr) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float g = quad_sum(part_[half]);
          const int j = jr + 8 * half;
          if ((f.lane & 3) == 0 && j < q) gdt[cell * q + j] = g;
        }
      }
    }

    // 6. the next head's gy and gS (stage s ^ 1; the one gS buffer) as their
    // terms, each split in place over its float32 rows once every thread
    // has read them; gdA between
    unsigned char* gy_next = smem + L::kGy + (s ^ 1) * 2 * L::kXBytes;
    float nda = 0.0f, ndt = 0.0f;    // its dA and dt (warpgroup 0, which
    if (more && tid < kQ) {          // waits at the next barrier anyway)
      const float* dg = dacum + (cell + 1) * q;
      nda = dg[tid < q ? tid : q - 1];
      ndt = dt ? (tid < q ? dt[(cell + 1) * q + tid] : 0.0f) : 1.0f;
    }
    Chunks<kQ> cy;
    if (more) {
      mbar_wait(bars + 8 * (kGyFull + (s ^ 1)), (k >> 1) & 1);
      cy.read(reinterpret_cast<const float*>(gy_next), q, p, tid);
    }
    sync_all();                      // gdA's exchange is complete
    if (more) cy.write(gy_next, tid);
    Chunks<kNb> cs;
    if (more) {
      mbar_wait(bars + 8 * kGsFull, k & 1);
      cs.read(reinterpret_cast<const float*>(smem + L::kGs), n, p, tid);
    }

    // 7. gdA_k = R's row sum at k - its column sum at k - r_k (+ sum r at
    // the last row), each sum in a fixed order
    if constexpr (kWg == 0) {
      const int kq = f.tw;
      const float* rows = ex + L::kRowsEx;
      const float* cols = ex + L::kColsEx;
      const float* rv = ex + L::kREx;
      float g = 0.0f;
      if (kq < 64) {
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) g += cols[w4 * 64 + kq];
        g -= rows[kq];
        g -= rows[64 + kq];
      } else {
#pragma unroll
        for (int t = 1; t < 3; ++t)
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) g += cols[(t * 4 + w4) * 64 + kq - 64];
        g -= rows[128 + kq - 64];
      }
      g -= rv[kq];
      // sum_j r_j: each warp's 32 by a fixed shuffle tree, then the four
      // warps' in order (r is 0 past q)
      float all = rv[kq];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        all += __shfl_xor_sync(0xffffffffu, all, off);
      named_sync(2, 128);            // warpgroup 0's reads of rows are done
      if (f.lane == 0) ex[L::kRowsEx + (f.tw >> 5)] = all;
      named_sync(2, 128);
      if (kq == q - 1)
        g += ((ex[L::kRowsEx] + ex[L::kRowsEx + 1]) + ex[L::kRowsEx + 2]) +
             ex[L::kRowsEx + 3];
      if (kq < q) ga[cell * q + kq] = g;
    }
    sync_all();                      // every thread has read the raw gS
    if (more) {
      cs.write(smem + L::kGs, tid);
      if (tid < kQ) {
        float* da = reinterpret_cast<float*>(smem + L::kDa) + (s ^ 1) * 2 * kQ;
        da[tid] = nda;
        da[kQ + tid] = ndt;
      }
      fence_async_smem();
    }
    sync_all();                      // head k's buffers are free
    if (tid == 0 && k + 2 < hb) {    // head k + 2's x and float32 gy
      const uint32_t full = bars + 8 * (kXFull + s);
      mbar_expect_tx(full, L::kXBytes);
      tma_load(xs, tx, full, 0, 0, (int)(cell + 2));
      const uint32_t gfull = bars + 8 * (kGyFull + s);
      mbar_expect_tx(gfull, (uint32_t)(q * p * 4));
      bulk_load(gys, gy + (cell + 2) * q * p, (uint32_t)(q * p * 4), gfull);
    }
  }

  // 8. the block's G^T tiles and state term to the per-slice buffer
  float* pf = part + (long long)blockIdx.x * Part<kNb>::kFloats;
#pragma unroll
  for (int g = 0; g < kGh; ++g) {
    const int tile = kWg == 0 ? 0 : (g == 0 ? 2 : 1);
#pragma unroll
    for (int r = 0; r < 32; ++r) pf[(tile * 32 + r) * 128 + f.tw] = gh[g][r];
  }
#pragma unroll
  for (int r = 0; r < kNb / 2; ++r)
    pf[3 * kTile + (kWg * (kNb / 2) + r) * 128 + f.tw] = sb[r];
}

// One block: (batch x chunk) * groups + group, then the slice of hb heads of
// that group, numbered slice-fastest (as ssd_wgmma).
template <int kNb>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_wg(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tb,
           const __grid_constant__ CUtensorMap tc,
           const float* __restrict__ dacum, const float* __restrict__ dt,
           const float* __restrict__ gy, const float* __restrict__ gs,
           bf16* __restrict__ gx, float* __restrict__ ga,
           float* __restrict__ gdt, float* __restrict__ part, int heads,
           int groups, int hb, int q, int n, int p) {
  using L = Smem<kNb>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;

  const int rep = heads / groups, slices = rep / hb;
  const long long bcg = blockIdx.x / slices;      // (batch x chunk, group)
  const long long cell0 = bcg / groups * heads + bcg % groups * rep +
                          blockIdx.x % slices * hb;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBarriers; ++i)
      mbar_init(bars + 8 * i, i == kGsEmpty ? kThreads / 32 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bc_full = bars + 8 * kBCFull;
    mbar_expect_tx(bc_full, 2 * kQ * kNb * 2);
#pragma unroll
    for (int cb = 0; cb < kNb / 64; ++cb) {
      tma_load(base + L::kB + cb * kQ * 128, &tb, bc_full, cb * 64, 0,
               (int)bcg);
      tma_load(base + L::kS + cb * kQ * 128, &tc, bc_full, cb * 64, 0,
               (int)bcg);
    }
    for (int k = 0; k < 2 && k < hb; ++k) {
      const uint32_t full = bars + 8 * (kXFull + k);
      mbar_expect_tx(full, L::kXBytes);
      tma_load(base + L::kX + k * L::kXBytes, &tx, full, 0, 0,
               (int)(cell0 + k));
    }
    if (hb > 1) {                    // head 1's float32 gy into stage 1
      const uint32_t gfull = bars + 8 * (kGyFull + 1);
      mbar_expect_tx(gfull, (uint32_t)(q * p * 4));
      bulk_load(base + L::kGy + 2 * L::kXBytes, gy + (cell0 + 1) * q * p,
                (uint32_t)(q * p * 4), gfull);
    }
  }
  stage_first<kNb>(smem, cell0, dacum, dt, gy, gs, q, n, p);
  // 0 or 1, warp-uniform to the compiler
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0)
    body<kNb, 0>(smem, base, bars, &tx, dacum, dt, gy, gs, gx, ga, gdt, part,
                 cell0, hb, q, n, p);
  else
    body<kNb, 1>(smem, base, bars, &tx, dacum, dt, gy, gs, gx, ga, gdt, part,
                 cell0, hb, q, n, p);
}

// gB (role 0, 1: rows j 0-63, 64-127) or gC (role 2, 3: rows i 0-63,
// 64-127) of one (batch x chunk, group): blockIdx.x = (batch x chunk) *
// groups + group, blockIdx.y the role.  G^T's causal tiles are 0 (j0, i0), 1
// (j0, i1) and 2 (j1, i1); gB's rows j use G^T's tiles of those rows (K = i,
// against C's rows i), gC's rows i those of its columns, transposed (K = j,
// against B's rows j).
template <int kNb>
__global__ void __launch_bounds__(kGbcThreads, 1)
ssd_bwd_gbc(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
            const float* __restrict__ part, bf16* __restrict__ gb,
            bf16* __restrict__ gc, int slices, int q, int n) {
  using L = GbcSmem<kNb>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const Frag f;
  const int role = blockIdx.y, row0 = 64 * (role & 1);
  const bool is_gc = role >= 2;
  const long long bcg = blockIdx.x;
  // its tiles and the first k (i for gB, j for gC) of each
  const int nt = (role == 0 || role == 3) ? 2 : 1;
  const int tiles[2] = {role == 1 ? 2 : (role == 3 ? 1 : 0), role == 0 ? 1 : 2};
  const int k0[2] = {role == 1 ? 64 : 0, 64};

  // C (gB) or B (gC), all 128 rows, swizzled; zeros past q and n; every
  // load issued before any store
  const bf16* op = (is_gc ? bm : cm) + bcg * q * n;
  {
    constexpr int kLoads = kQ * (kNb / 8) / kGbcThreads;
    uint4 v[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = f.tw + it * kGbcThreads;
      const int r = idx / (kNb / 8), c = 8 * (idx % (kNb / 8));
      v[it] = make_uint4(0u, 0u, 0u, 0u);
      if (r < q && c < n)
        v[it] = *reinterpret_cast<const uint4*>(op + (long long)r * n + c);
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = f.tw + it * kGbcThreads;
      const int r = idx / (kNb / 8), c = 8 * (idx % (kNb / 8));
      *reinterpret_cast<uint4*>(smem + L::kOp + swizzled(kQ, r, c)) = v[it];
    }
  }
  fence_async_smem();

  // G^T's tiles summed over the slices in order, as [64][kGtLd] matrices
  const long long per = Part<kNb>::kFloats;
  const float* pb = part + bcg * slices * per;
  float* gt = reinterpret_cast<float*>(smem + L::kGt);
  // (the slices' loop outside, so that a slice's 32 or 64 loads are in
  // flight together; each value summed in slice order)
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a >= nt) break;
    float v[32];
    zero(v);
    for (int sl = 0; sl < slices; ++sl) {
      const float* at = pb + sl * per + tiles[a] * 32 * 128 + f.tw;
#pragma unroll
      for (int r = 0; r < 32; ++r) v[r] += at[r * 128];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int row = f.r0 + 8 * ((r >> 1) & 1);
      const int col = 8 * (r >> 2) + f.cq + (r & 1);
      gt[a * 64 * kGtLd + row * kGtLd + col] = v[r];
    }
  }
  // gB starts from the state term summed over the slices, gC from zero
  float acc[kNb / 2];
  zero(acc);
  if (!is_gc) {
    for (int sl = 0; sl < slices; ++sl) {
      const float* at =
          pb + sl * per + 3 * kTile + (role & 1) * (kNb / 2) * 128 + f.tw;
#pragma unroll
      for (int r = 0; r < kNb / 2; ++r) acc[r] += at[r * 128];
    }
  }
  __syncthreads();

  // A fragments: rows r0, r0 + 8 of G^T (gB) or G^ (gC) as hi + lo
  uint32_t ah[8][4], al[8][4];       // [tile slot * 4 + k16 step][register]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int row = f.r0 + 8 * (rr & 1);
        const int col = 16 * kk + f.cq + 8 * (rr >> 1);
        const float* t = gt + a * 64 * kGtLd;
        float v0 = 0.0f, v1 = 0.0f;
        if (a < nt) {
          v0 = is_gc ? t[col * kGtLd + row] : t[row * kGtLd + col];
          v1 = is_gc ? t[(col + 1) * kGtLd + row] : t[row * kGtLd + col + 1];
        }
        split2(v0, v1, ah[4 * a + kk][rr], al[4 * a + kk][rr]);
      }
  const uint64_t dop = descriptor(base + L::kOp, kQ * 128, 1024);
  pin(acc);
  pin(ah);
  pin(al);
  wgmma_fence();
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a >= nt) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = dop + (((k0[a] + 16 * kk) * 128) >> 4);
      if constexpr (kNb == 128) {
        wgmma_rs_n128(acc, ah[4 * a + kk], d, 1);
        wgmma_rs_n128(acc, al[4 * a + kk], d, 1);
      } else {
        wgmma_rs_n64(acc, ah[4 * a + kk], d, 1);
        wgmma_rs_n64(acc, al[4 * a + kk], d, 1);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  pin(ah);
  pin(al);

  bf16* out = (is_gc ? gc : gb) + bcg * q * n;
#pragma unroll
  for (int jj = 0; jj < kNb / 8; ++jj) {
    const int c = 8 * jj + f.cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + f.r0 + 8 * half;
      if (row < q && c < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * n + c) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * half],
                                  acc[4 * jj + 2 * half + 1]);
    }
  }
}

template <int kNb>
int launch(const void* x, const void* b, const void* c, const float* dacum,
           const float* dt, const float* gy, const float* gs, void* gx,
           void* gb, void* gc, float* ga, float* gdt, float* part, int bc,
           int heads, int groups, int q, int n, int p, int slices,
           cudaStream_t stream) {
  const long long cells = (long long)bc * heads;
  const long long group_cells = (long long)bc * groups;
  const int rep = heads / groups;
  if (cells > 0x7fffffffLL || n > kNb || slices < 1 || rep % slices != 0 ||
      group_cells * slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  if (!(encode(&maps[0], x, (int)cells, q, p, kQ) &&
        encode(&maps[1], b, (int)group_cells, q, n, kQ) &&
        encode(&maps[2], c, (int)group_cells, q, n, kQ)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};        // one per build of the kernels
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_wg<kNb>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem<kNb>::kBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_bwd_gbc<kNb>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GbcSmem<kNb>::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  ssd_bwd_wg<kNb><<<(unsigned)(group_cells * slices), kThreads,
                    Smem<kNb>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], dacum, dt, gy, gs, static_cast<bf16*>(gx),
      ga, gdt, part, heads, groups, rep / slices, q, n, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_gbc<kNb><<<dim3((unsigned)group_cells, 4), kGbcThreads,
                     GbcSmem<kNb>::kBytes, stream>>>(
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), part,
      static_cast<bf16*>(gb), static_cast<bf16*>(gc), slices, q, n);
  return (int)cudaGetLastError();
}

}  // namespace wgb

}  // namespace

// x (or xdt), B, C in float32 or bf16 (bf16 != 0); dacum, dt (may be null),
// gy, gs float32; gx, gb, gc in the inputs' dtype; ga and gdt (null where dt
// is) float32.  slices > 0 (bf16 only; N and P multiples of 8, x, B, C, gy
// and gs 16-byte aligned) takes the tensor-core route with that many head
// slices a group and scratch bc * groups * slices * (3 * 4096 + 128 * Nb)
// floats, Nb = 64 for N <= 64, else 128; slices = 0 the SIMT route with
// scratch bc * heads * q * (q + n) floats.
extern "C" int ssd_inner_bwd(const void* xdt, const void* b, const void* c,
                             const float* dacum, const float* dt,
                             const float* gy, const float* gs, void* gx,
                             void* gb, void* gc, float* ga, float* gdt,
                             float* scratch, int bc, int heads, int groups,
                             int q, int n, int p, int bf16, int slices,
                             cudaStream_t stream) {
  if (bc == 0) return 0;
  if (bc < 0 || heads < 1 || groups < 1 || heads % groups != 0 || q < 1 ||
      q > kQ || n < 1 || n > kN || p < 1 || p > kP || (dt && !gdt) ||
      slices < 0 || (slices > 0 && !bf16))
    return (int)cudaErrorInvalidValue;
  if (slices > 0) {
    if (n % 8 != 0 || p % 8 != 0 ||
        ((uintptr_t)xdt | (uintptr_t)b | (uintptr_t)c | (uintptr_t)gy |
         (uintptr_t)gs) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return n <= 64 ? wgb::launch<64>(xdt, b, c, dacum, dt, gy, gs, gx, gb, gc,
                                     ga, gdt, scratch, bc, heads, groups, q, n,
                                     p, slices, stream)
                   : wgb::launch<128>(xdt, b, c, dacum, dt, gy, gs, gx, gb,
                                      gc, ga, gdt, scratch, bc, heads, groups,
                                      q, n, p, slices, stream);
  }
  return bf16 ? simt::launch<__nv_bfloat16>(xdt, b, c, dacum, dt, gy, gs, gx,
                                            gb, gc, ga, gdt, scratch, bc,
                                            heads, groups, q, n, p, stream)
              : simt::launch<float>(xdt, b, c, dacum, dt, gy, gs, gx, gb, gc,
                                    ga, gdt, scratch, bc, heads, groups, q, n,
                                    p, stream);
}
