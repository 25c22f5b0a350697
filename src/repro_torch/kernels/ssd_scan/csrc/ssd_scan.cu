// Mamba2 SSD within-chunk block, by hand for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::
// ssd_inner (body _ssd_kernel).  For each (batch, chunk, head) cell, with
// xdt [Q, P], the head's group's B and C [Q, N] and the in-chunk cumulative
// decay dA [Q]:
//
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(dA_i - dA_j) * xdt_j        [Q, P]
//   state = sum_j exp(dA_{Q-1} - dA_j) * B_j^T xdt_j                    [N, P]
//
// Head h of H reads group h / (H / G) of B and C ([B * Nc, G, Q, N]); G = H
// is the TPU kernel's per-head contract.  The cross-chunk recurrence and the
// off-diagonal term stay outside (ops.py).  Two kernels, chosen by dtype:
//
//   float32  ssd_inner_kernel (SIMT): the TPU kernel's float32 function.
//   bf16     ssd_wgmma (tensor cores): the same float32 function of bf16 x,
//            B and C and float32 dt and dA, x * dt never rounded: dt_j folds
//            into the operands.  M = (C.B^T) * exp(dA_i - dA_j) * dt_j, the
//            A operand of y = M x, and W_j = exp(dA_last - dA_j) * dt_j * x_j,
//            the B operand of state = B^T W, are float32 values, each carried
//            as three bf16 terms (8 significant bits a term: the value
//            exactly), and the products of every term accumulate in float32.
//            A single bf16 rounding of M, or of x * dt, more than doubles the
//            bf16 model's logit error at 2 layers (past
//            tests/test_torch_mamba2.py::
//            test_bf16_spread_grows_with_depth_like_reference).  The decays
//            are exp2 of (dA_i - dA_j) log2(e), the difference taken first
//            (never a product of exp(dA_i) and exp(-dA_j): dA falls by
//            hundreds over a chunk, and those factors overflow).
//
// Both kernels take either xdt = x * dt (dt null) or x with dt, Q <= 128,
// N <= 128 and P <= 64, any of them below (the chunk of a 200-token prompt
// is 100), zero-padding tiles and masking stores.
//
// float32 design (ssd_inner_kernel).  One block of 256 threads per cell, a
// 16 x 16 thread grid.  N is streamed in slices of 32: each slice of C and B
// is staged in shared memory k-major (row stride Q + 1, so the transposing
// store is free of bank conflicts), every thread accumulates its 8 x 8 scores
// C.B^T in registers (rows ty + 16r, columns tx + 16c), and the same slice
// of B, scaled by exp(dA_last - dA), gives that slice's 32 rows of the state
// against xdt, which stays in shared memory.  Then the decay mask is applied
// to the register scores, which go to shared memory once, and y = scores .
// xdt.  133 KB of dynamic shared memory (cudaFuncSetAttribute before the
// first launch); one block per SM.  It computes the full [Q, Q] score tile
// and masks it, as the TPU kernel does, and C.B^T once per head.  Bound on
// an H100 SXM at the mamba2-130m prefill (768 cells, Q = N = 128, P = 64,
// G = 1): operations, the function's 2.49 GFLOP of causal work (C.B^T once
// per group) at the 67 TFLOP/s float32 peak, 37 us.
//
// bf16 design (ssd_wgmma: tensor cores, warp-specialised).  One block per
// (batch x chunk, group, slice of hb heads of the group), hb the smallest
// divisor of H / G that keeps the grid within one wave of the card's SMs (6
// at the mamba2-130m prefill: 8 x 4 x 1 x 4 = 128 blocks on 132 SMs).  384
// threads: two consumer warpgroups, each owning 64 rows i of the chunk, and
// a producer warpgroup whose first warp issues every copy.  Shared memory
// (195 KB) holds C and B (128 x 128 bf16, 32 KB each, read once per block),
// a two-stage ring of x tiles (128 x 64 bf16) and of the three W tiles made
// from each, and the heads' dA and dt; every tile in the 128-byte swizzled
// layout of hopper.cuh.  The producer copies C
// and B once and then each head's x with TMA (3-D tensor maps, zeros out of
// range, so ragged Q, N and P are padded by the copy), so head h + 1 loads
// while head h computes; where TMA cannot describe a tensor (N or P not a
// multiple of 8, or a pointer not 16-byte aligned) a compile-time variant
// stages the same layout with ordinary loads.  mbarriers carry the hand-offs
// (bc_full; x_full and x_empty per stage).  The consumers:
//   1. once per block, S = C B^T by wgmma m64n64k16 from shared memory into
//      float32 registers, only its causal 64 x 64 tiles: rows 0-63 (first
//      warpgroup) columns 0-63, rows 64-127 (second) columns 0-127.  S stays
//      in registers for all hb heads;
//   2. per head, all 256 threads stage W = exp(dA_last - dA_j) dt_j x_j as
//      its three bf16 terms beside the x tile, and dA and dt, then a named
//      barrier;
//   3. the state, the sum over the terms u of B^T W_u: the A operand is the
//      B tile already in shared memory read MN-major ("transposed"), so B
//      is never rescaled per head; each warpgroup computes one half of the
//      N rows (24 k16 steps of m64n64k16) and stores it;
//   4. per 64-column tile of S, each warpgroup makes M = S * exp(dA_i -
//      dA_j) * dt_j (j <= i, else 0) in registers as its three bf16 terms
//      (S's accumulator fragment of 16 columns is the A fragment of one k16
//      step), and adds their products with the x tile, the B operand read
//      MN-major through its descriptor, to y: 12 k16 steps for the first
//      warpgroup (j < 64), 24 for the second; then the x stage is released
//      and y stored.
// The steps run one after another, so that the second warpgroup's S (64
// registers), one tile's M terms (48) and one accumulator (32) are live at a
// time; the two warpgroups overlap each other.  y and the state go out in
// float32 from registers (8-byte stores).
// Every input of a wgmma other than its accumulator is made before the wgmma
// fence (ptxas serialises the wgmmas otherwise, its warning C7513).
// Registers: ptxas counts them per SM sub-partition, so a block of 288
// threads starts at 168 a thread, as one of 384 does, and at 168 the second
// warpgroup spills and ptxas serialises its wgmmas (C7512).  So a producer
// warpgroup gives its registers to the consumers with setmaxnreg (24 and
// 240; 40 and 232 in the variant with ordinary loads), as in
// flash_attention.cu; launch() checks ptxas's 168 before the first launch.
//
// Bound of the bf16 kernel on an H100 SXM at the mamba2-130m prefill
// (x [8, 4, 24, 128, 64], N = 128, G = 1): bytes.  x 12.6 MB, B and C 2.1
// MB, dA and dt 0.4 MB each, y and states 25.2 MB each: 65.8 MB, 19.6 us at
// 3.35 TB/s; the causal work, 768 Q (Q + 1) P + 2 Q N P plus 32 Q (Q + 1) N
// flops = 2.49 GFLOP, is 2.5 us at 989 TFLOP/s (the three terms triple the
// products issued, not counted as needed work).  The float32 outputs are
// three quarters of the bytes.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns a cudaError_t code.

#include "../../csrc/hopper.cuh"  // wgmma, TMA and mbarrier helpers

namespace {

constexpr int kQ = 128;            // largest chunk
constexpr int kP = 64;             // largest head dim
constexpr int kN = 128;            // largest state dim

// ------------------------------------------------------------- float32
namespace simt {

constexpr int kNS = 32;            // N slice staged per step
constexpr int kLd = kQ + 1;        // padded row stride
constexpr int kThreads = 256;
constexpr int kSmemFloats = 2 * kNS * kLd + kQ * kLd + kQ * kP + 2 * kQ;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

// one block per cell = (batch x chunk) * heads + head
__global__ void __launch_bounds__(kThreads, 1)
ssd_inner_kernel(const float* __restrict__ xdt, const float* __restrict__ bm,
                 const float* __restrict__ cm,
                 const float* __restrict__ dacum,
                 const float* __restrict__ dt, float* __restrict__ y,
                 float* __restrict__ states, int heads, int groups, int q,
                 int n, int p) {
  extern __shared__ float smem[];
  float* cs = smem;                  // [kNS][kLd]  C slice, k-major
  float* bs = cs + kNS * kLd;        // [kNS][kLd]  B slice, k-major
  float* sc = bs + kNS * kLd;        // [kQ][kLd]   masked scores
  float* xs = sc + kQ * kLd;         // [kQ][kP]    xdt
  float* da = xs + kQ * kP;          // [kQ]        dA cumsum
  float* wl = da + kQ;               // [kQ]        exp(dA_last - dA)

  const long long cell = blockIdx.x;
  const long long gcell =            // the head's group's B and C
      cell / heads * groups + cell % heads / (heads / groups);
  const float* xg = xdt + cell * q * p;
  const float* bg = bm + gcell * q * n;
  const float* cg = cm + gcell * q * n;
  float* yg = y + cell * q * p;
  float* sg = states + cell * n * p;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  for (int i = t; i < kQ * kP; i += kThreads) {
    const int r = i / kP, col = i % kP;
    xs[i] = (r < q && col < p)
                ? xg[r * p + col] * (dt ? dt[cell * q + r] : 1.0f)
                : 0.0f;
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

int launch(const float* xdt, const float* b, const float* c,
           const float* dacum, const float* dt, float* y, float* states,
           int bc, int heads,
           int groups, int q, int n, int p, cudaStream_t stream) {
  const long long cells = (long long)bc * heads;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
      xdt, b, c, dacum, dt, y, states, heads, groups, q, n, p);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- bf16
namespace wg {

using namespace hopper;

constexpr int kConsumers = 256;              // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
// ptxas counts registers per SM sub-partition: a block of 288 or of 384
// threads starts at 168 a thread.  The producer warpgroup (whose first warp
// issues the copies, the other three exit) gives back 144, which lifts the
// 256 consumers to 240: 24 + 2 * 240 of each sub-partition's 512.  The
// variant with ordinary loads keeps 40 for the producer and 232 for them.
// launch() refuses a build that ptxas gave another count than kLaunchRegs:
// there a setmaxnreg.inc could wait forever for registers the block lacks.
constexpr int kLaunchRegs = 168;
template <bool kTma> constexpr int kProducerRegs = kTma ? 24 : 40;
template <bool kTma> constexpr int kConsumerRegs = kTma ? 240 : 232;
static_assert(128 * kProducerRegs<true> + kConsumers * kConsumerRegs<true> <=
                  kThreads * kLaunchRegs &&
              128 * kProducerRegs<false> + kConsumers * kConsumerRegs<false> <=
                  kThreads * kLaunchRegs,
              "setmaxnreg asks for more registers than the block holds");
constexpr float kLog2e = 1.4426950408889634f;

// byte offsets in the block's shared memory; every tile is 1024-byte aligned
constexpr int kBCBytes = kQ * kN * 2;        // C or B: 2 column blocks
constexpr int kXBytes = kQ * kP * 2;         // xdt or W: 1 column block
constexpr int kC = 0;
constexpr int kB = kC + kBCBytes;
constexpr int kX = kB + kBCBytes;            // 2 stages
constexpr int kW = kX + 2 * kXBytes;         // 2 stages of 3 W terms
constexpr int kA = kW + 6 * kXBytes;         // 2 x kQ floats: dA
constexpr int kDt = kA + 2 * kQ * 4;         // 2 x kQ floats: dt
constexpr int kBars = kDt + 2 * kQ * 4;
// mbarrier slots: bc_full, then x_full and x_empty per stage
constexpr int kBCFull = 0, kXFull = 1, kXEmpty = 3;
// + slack to align the dynamic shared memory's start to 1024 bytes
constexpr size_t kSmemBytes = kBars + 8 * 5 + 1024;

// a [rows x cols] row-major bf16 matrix into a [kRows x kCols] tile in the
// swizzled layout, zeros past rows and cols; for tensors TMA cannot describe
template <int kRows, int kCols>
__device__ void stage_tile(unsigned char* dst, const bf16* __restrict__ src,
                           int rows, int cols, int lane) {
  for (int i = lane; i < kRows * kCols; i += 32) {
    const int r = i / kCols, c = i % kCols;
    bf16 v = __float2bfloat16(0.0f);
    if (r < rows && c < cols) v = src[(long long)r * cols + c];
    *reinterpret_cast<bf16*>(dst + swizzled(kRows, r, c)) = v;
  }
  fence_async_smem();
}

// (v0, v1) as three bf16 pairs t[0] + t[1] + t[2], each the bf16 rounding
// of what the ones before leave: the float32 values exactly (8 significant
// bits a term; the remainders are exact in float32)
__device__ __forceinline__ void split3_bf16(float v0, float v1,
                                            uint32_t (&t)[3]) {
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    t[u] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// rows r0 and r0 + 8 (below `rows`) of a 64-row accumulator fragment
// (acc[4 jj + 2 half + {0, 1}]: row r0 + 8 half, columns 8 jj + 2 (lane % 4)
// and + 1) into a float32 [rows, cols] matrix, columns below `cols`
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float (&acc)[32], int r0,
                                           int rows, int cols) {
  const int cq = 2 * (threadIdx.x & 3);
  const bool pairs = (cols & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 8 * jj + cq;
    if (c >= cols) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= rows) continue;
      float* at = dst + (long long)r * cols + c;
      const float lo = acc[4 * jj + 2 * half], hi = acc[4 * jj + 2 * half + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(at) = make_float2(lo, hi);
      } else {
        at[0] = lo;
        if (c + 1 < cols) at[1] = hi;
      }
    }
  }
}

// The consumer warpgroup kWg (0: rows 0-63, 1: rows 64-127) of one block:
// its kWg + 1 causal 64 x 64 tiles of S, then every head of the block.
template <int kWg>
__device__ __forceinline__ void consume(
    unsigned char* smem, uint32_t base, uint32_t bars,
    const float* __restrict__ dacum, const float* __restrict__ dt,
    float* __restrict__ y, float* __restrict__ states, long long cell0,
    int hb, int q, int n, int p) {
  constexpr int kT = kWg + 1;                // score tiles of 64 columns
  constexpr int kSteps = 4 * kT;             // k16 steps of y = M xdt
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cq = 2 * (lane & 3);             // its column in each 8
  const int rw = 64 * kWg + 16 * (warp & 3) + (lane >> 2);  // rows rw, rw + 8
  float* da_s = reinterpret_cast<float*>(smem + kA);
  float* dt_s = reinterpret_cast<float*>(smem + kDt);

  // 1. S = C B^T over the causal tiles, once for all heads
  float s[kT][32];
  {
    uint64_t dc[kN / 16], db[kT][kN / 16];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kQ * 128 + (kk & 3) * 32;
      dc[kk] = descriptor(base + kC + off + 64 * kWg * 128, 16, 1024);
      asm volatile("" : "+l"(dc[kk]));
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        db[t][kk] = descriptor(base + kB + off + 64 * t * 128, 16, 1024);
        asm volatile("" : "+l"(db[t][kk]));
      }
    }
    int overwrite = 0, accumulate = 1;
    asm volatile("" : "+r"(overwrite), "+r"(accumulate));
    mbar_wait(bars + 8 * kBCFull, 0);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      zero(s[t]);
      pin(s[t]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_ss(s[t], dc[kk], db[t][kk], kk == 0 ? overwrite : accumulate);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kT; ++t) pin(s[t]);
  }

  for (int k = 0; k < hb; ++k) {
    const int stage = k & 1;
    const long long cell = cell0 + k;
    const uint32_t xa = base + kX + stage * kXBytes;
    const uint32_t wa = base + kW + 3 * stage * kXBytes;  // its 3 terms
    float* da_k = da_s + stage * kQ;
    float* dt_k = dt_s + stage * kQ;

    // 2. W = exp(dA_last - dA_j) dt_j x_j as three bf16 terms: thread tid
    // owns row j = tid / 2, columns 32 (tid & 1) to 32 (tid & 1) + 31 (four
    // 16-byte chunks)
    {
      const int j = tid >> 1;
      const float* dg = dacum + cell * q;
      const float d_last = dg[q - 1];
      const float d_j = j < q ? dg[j] : d_last;          // pad: W_j = 0
      const float t_j = dt ? (j < q ? dt[cell * q + j] : 0.0f) : 1.0f;
      if ((tid & 1) == 0) {
        da_k[j] = d_j;
        dt_k[j] = t_j;
      }
      const float wj = ex2((d_last - d_j) * kLog2e) * t_j;
      mbar_wait(bars + 8 * (kXFull + stage), (k >> 1) & 1);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const int chunk = 4 * (tid & 1) + ch;
        const uint32_t off = j * 128 + ((chunk ^ (j & 7)) << 4);
        const uint4 xv = *reinterpret_cast<const uint4*>(
            smem + kX + stage * kXBytes + off);
        const uint32_t in[4] = {xv.x, xv.y, xv.z, xv.w};
        uint32_t w3[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
          uint32_t terms[3];
          split3_bf16(wj * f.x, wj * f.y, terms);
#pragma unroll
          for (int u = 0; u < 3; ++u) w3[u][e] = terms[u];
        }
        unsigned char* w = smem + kW + 3 * stage * kXBytes + off;
#pragma unroll
        for (int u = 0; u < 3; ++u)
          *reinterpret_cast<uint4*>(w + u * kXBytes) =
              make_uint4(w3[u][0], w3[u][1], w3[u][2], w3[u][3]);
      }
      fence_async_smem();
      consumers_sync();
    }

    // 3. this warpgroup's half of the state rows, B^T W, one k16 step per
    // term and 16 rows j, with B read MN-major from the tile of step 1
    {
      float st[32];
      uint64_t dbt[kQ / 16], dw[3][kQ / 16];
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        dbt[ks] = descriptor(base + kB + kWg * kQ * 128 + ks * 16 * 128,
                             kQ * 128, 1024);
        asm volatile("" : "+l"(dbt[ks]));
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          dw[u][ks] =
              descriptor(wa + u * kXBytes + ks * 16 * 128, kQ * 128, 1024);
          asm volatile("" : "+l"(dw[u][ks]));
        }
      }
      int overwrite = 0, accumulate = 1;
      asm volatile("" : "+r"(overwrite), "+r"(accumulate));
      zero(st);
      pin(st);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int ks = 0; ks < kQ / 16; ++ks)
          wgmma_ss<1, 1>(st, dbt[ks], dw[u][ks],
                         u == 0 && ks == 0 ? overwrite : accumulate);
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      store_tile(states + cell * n * p, st, rw, n, p);
    }

    // 4-5. per 64-column tile t of S: M = S * exp(dA_i - dA_j) * dt_j for
    // j <= i, else 0, as three bf16 terms, then y += M_t x_t.  s[t][4 jj +
    // e] is row rw + 8 (e >> 1), column 64 t + 8 jj + cq + (e & 1); the
    // fragment of columns 16 kk .. 16 kk + 15 is the A fragment of the k16
    // step 4 t + kk of y = M x, whose B operand is the x tile read MN-major
    float ya[32];
    {
      const float di0 = da_k[rw], di1 = da_k[rw + 8];
      int overwrite = 0, accumulate = 1;
      asm volatile("" : "+r"(overwrite), "+r"(accumulate));
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        uint32_t mt[3][4][4];                // term, k16 step, register
        {
          float v[32];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j0 = 64 * t + 8 * jj + cq;
            const float2 dj = *reinterpret_cast<const float2*>(&da_k[j0]);
            const float2 tj = *reinterpret_cast<const float2*>(&dt_k[j0]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = rw + 8 * (e >> 1), j = j0 + (e & 1);
              const float x =
                  s[t][4 * jj + e] *
                  ex2((((e >> 1) ? di1 : di0) - ((e & 1) ? dj.y : dj.x)) *
                      kLog2e) *
                  ((e & 1) ? tj.y : tj.x);
              // the tile left of the diagonal has j < i throughout
              v[4 * jj + e] = (t < kWg || j <= i) ? x : 0.0f;
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              uint32_t terms[3];
              split3_bf16(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1], terms);
#pragma unroll
              for (int u = 0; u < 3; ++u) mt[u][kk][r] = terms[u];
            }
        }
        uint64_t dx[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          dx[kk] = descriptor(xa + (4 * t + kk) * 16 * 128, kQ * 128, 1024);
          asm volatile("" : "+l"(dx[kk]));
        }
        if (t == 0) zero(ya);
        pin(ya);
#pragma unroll
        for (int u = 0; u < 3; ++u) pin(mt[u]);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(ya, mt[u][kk], dx[kk],
                         t == 0 && u == 0 && kk == 0 ? overwrite
                                                     : accumulate);
        wgmma_commit();
        wgmma_wait<0>();
        pin(ya);
#pragma unroll
        for (int u = 0; u < 3; ++u) pin(mt[u]);
      }
    }
    __syncwarp();                     // this warp is done with the x stage
    if (lane == 0) mbar_arrive(bars + 8 * (kXEmpty + stage));
    store_tile(y + cell * q * p, ya, rw, q, p);
  }
}

// One block: (batch x chunk) * groups + group, then the slice of hb heads of
// that group, numbered slice-fastest.  kTma: TMA copies, else ordinary loads.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
ssd_wgmma(const __grid_constant__ CUtensorMap tx,
          const __grid_constant__ CUtensorMap tb,
          const __grid_constant__ CUtensorMap tc,
          const bf16* __restrict__ xdt, const bf16* __restrict__ bm,
          const bf16* __restrict__ cm, const float* __restrict__ dacum,
          const float* __restrict__ dt,
          float* __restrict__ y, float* __restrict__ states, int heads,
          int groups, int hb, int q, int n, int p) {
  constexpr int kFullArrivals = kTma ? 1 : 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kBars;

  const int rep = heads / groups, slices = rep / hb;
  const long long bcg = blockIdx.x / slices;      // (batch x chunk, group)
  const long long cell0 = bcg / groups * heads +
                          bcg % groups * rep + blockIdx.x % slices * hb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kBCFull, kFullArrivals);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * (kXFull + s), kFullArrivals);
      mbar_init(bars + 8 * (kXEmpty + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ----------------------------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 ::"n"(kProducerRegs<kTma>));
    if (warp != kConsumers / 32) return;       // one warp issues the copies
    if (kTma && lane != 0) return;
    const uint32_t bc_full = bars + 8 * kBCFull;
    if constexpr (kTma) {
      mbar_expect_tx(bc_full, 2 * kBCBytes);
#pragma unroll
      for (int cb = 0; cb < kN / 64; ++cb) {
        tma_load(base + kC + cb * kQ * 128, &tc, bc_full, cb * 64, 0,
                 (int)bcg);
        tma_load(base + kB + cb * kQ * 128, &tb, bc_full, cb * 64, 0,
                 (int)bcg);
      }
    } else {
      stage_tile<kQ, kN>(smem + kC, cm + bcg * q * n, q, n, lane);
      stage_tile<kQ, kN>(smem + kB, bm + bcg * q * n, q, n, lane);
      mbar_arrive(bc_full);
    }
    for (int k = 0; k < hb; ++k) {
      const int stage = k & 1;
      const uint32_t full = bars + 8 * (kXFull + stage);
      if (k >= 2)           // both warpgroups are done with head k - 2
        mbar_wait(bars + 8 * (kXEmpty + stage), ((k >> 1) - 1) & 1);
      if constexpr (kTma) {
        mbar_expect_tx(full, kXBytes);
        tma_load(base + kX + stage * kXBytes, &tx, full, 0, 0,
                 (int)(cell0 + k));
      } else {
        stage_tile<kQ, kP>(smem + kX + stage * kXBytes,
                           xdt + (cell0 + k) * q * p, q, p, lane);
        mbar_arrive(full);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
               ::"n"(kConsumerRegs<kTma>));
  // 0 or 1, warp-uniform to the compiler
  if (__shfl_sync(0xffffffffu, warp >> 2, 0) == 0)
    consume<0>(smem, base, bars, dacum, dt, y, states, cell0, hb, q, n, p);
  else
    consume<1>(smem, base, bars, dacum, dt, y, states, cell0, hb, q, n, p);
}

template <bool kTma>
int launch(const void* xdt, const void* b, const void* c, const float* dacum,
           const float* dt, float* y, float* states, int bc, int heads,
           int groups, int q, int n, int p, cudaStream_t stream) {
  const long long cells = (long long)bc * heads;
  const long long group_cells = (long long)bc * groups;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  if (kTma && !(encode(&maps[0], xdt, (int)cells, q, p, kQ) &&
                encode(&maps[1], b, (int)group_cells, q, n, kQ) &&
                encode(&maps[2], c, (int)group_cells, q, n, kQ)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};        // one per build of the kernel
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, ssd_wgmma<kTma>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != kLaunchRegs) return (int)cudaErrorInvalidKernelImage;
    err = cudaFuncSetAttribute(ssd_wgmma<kTma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  static int sms[64] = {};           // multiprocessors of each device
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  // hb: the fewest heads per block that keep the grid within one wave
  const int rep = heads / groups;
  int hb = rep;
  for (int d = 1; d <= rep; ++d)
    if (rep % d == 0 && group_cells * (rep / d) <= sms[dev]) {
      hb = d;
      break;
    }
  ssd_wgmma<kTma><<<(unsigned)(group_cells * (rep / hb)), kThreads,
                    kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(xdt),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c), dacum, dt, y,
      states, heads, groups, hb, q, n, p);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// xdt [bc, heads, q, p], b and c [bc, groups, q, n], dacum [bc, heads, q],
// dt [bc, heads, q] or null -> y [bc, heads, q, p], states [bc, heads, n, p]
// float32.  With dt, the first input is x and the block uses x * dt, formed
// in float32 (dt folds into M's columns and W's rows); without, it is xdt.
// xdt, b and c all float32 (bf16 = 0, the SIMT kernel) or all bf16 (bf16 =
// 1, the tensor-core kernel), dacum and dt float32, all contiguous.  bc =
// batch x chunks.
extern "C" int ssd_inner(const void* xdt, const void* b, const void* c,
                         const float* dacum, const float* dt, float* y,
                         float* states, int bc, int heads, int groups, int q,
                         int n, int p, int bf16, cudaStream_t stream) {
  if (bc == 0) return 0;
  if (bc < 0 || heads < 1 || groups < 1 || heads % groups != 0 || q < 1 ||
      q > kQ || n < 1 || n > kN || p < 1 || p > kP)
    return (int)cudaErrorInvalidValue;
  if (!bf16)
    return simt::launch(static_cast<const float*>(xdt),
                        static_cast<const float*>(b),
                        static_cast<const float*>(c), dacum, dt, y, states,
                        bc, heads, groups, q, n, p, stream);
  const bool tma = n % 8 == 0 && p % 8 == 0 &&
                   ((uintptr_t)xdt | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
  return tma ? wg::launch<true>(xdt, b, c, dacum, dt, y, states, bc, heads,
                                groups, q, n, p, stream)
             : wg::launch<false>(xdt, b, c, dacum, dt, y, states, bc, heads,
                                 groups, q, n, p, stream);
}
