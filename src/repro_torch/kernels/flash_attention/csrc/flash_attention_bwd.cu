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
//   dS  = P * (dP - D)     (tensor-core route: carried into dQ and dK as two
//                           bf16 terms, hi + lo, 16 significant bits)
//   dQ  = scale * dS K
//   dK  = scale * dS^T Q
//
// dK and dV sum over the G q heads of their kv head.  The three gradients are
// cast once to the inputs' dtype at the end.  The TPU kernel has no backward
// (the reference trains through jax.grad of plain attention); the port's
// models call the kernel, so its gradient is a kernel too.  No atomics: every
// sum is taken in an order fixed by the shapes, so a call is deterministic.
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
// At the paligemma-3b train step (q, o, dO [8, 8, 768, 256], k, v [8, 1,
// 768, 256], the prefix-LM mask over 256 image rows: 327,936 visible pairs a
// head) the same count gives 53.7 GFLOP, 54.3 us in bf16 and 802 us in
// float32, above the 113.5 MB of bf16 bytes (33.9 us): bound by operations.
//
// Two routes.  bf16 inputs that TMA can describe (hd a multiple of 8, q, k,
// v, o and dO 16-byte aligned), given the forward's LSE, take the tensor-core
// route; float32 inputs, and bf16 ones TMA cannot describe, the SIMT route.
//
// Tensor-core route (bf16; builds for hd 64, 128 and 256), four launches:
//   flash_bwd_rows     per q row, (LSE log2(e), D) into a float32 scratch
//                      [B H, Sq padded to 128]; padded rows (+inf, 0), so that
//                      their P is exactly 0.  The LSE is the one the forward
//                      wrote (flash_wgmma's lse output): no Q K^T here.
//   flash_bwd_dkdv_wg  dK and dV.  An item is one 64-row kv tile of one
//                      (batch, kv head) and one part of its G q heads; its
//                      pairs are the (head, 64-row q tile) that see the tile.
//                      Warp-specialised as the forward: a producer lane keeps
//                      K and V in shared memory for the item and streams each
//                      pair's Q, dO (TMA, 128-byte swizzle, the forward's 3-D
//                      tensor maps) and LSE/D rows (a 512-byte bulk copy)
//                      through a four-stage ring; two consumer warpgroups
//                      take the pairs in turn (even, odd).  Per pair a
//                      warpgroup issues S^T = K Q^T and dP^T = V dO^T (wgmma
//                      m64n64k16, both K-major), forms P^T and dS^T in the
//                      accumulator registers, rounds them to bf16 A fragments
//                      (dS^T as hi = bf16(dS^T) and lo = bf16(dS^T - hi))
//                      and issues dV += P^T dO and dK += (hi + lo) Q (wgmma
//                      m64n{hd}k16, A from registers, dO and Q MN-major from
//                      the same tiles).  At the item's end the warpgroups
//                      fold their dK and dV through shared memory (one
//                      float32 addition each, so the bits do not depend on
//                      timing).
//                      The hd-256 build cannot hold a 64 x 256 dK and dV
//                      in one warpgroup (256 float32 registers a thread,
//                      above the 240 setmaxnreg gives), nor a four-stage
//                      ring and the fold buffer (384 KB): there the two
//                      warpgroups split the columns instead of the pairs.
//                      Each takes every pair, issues the whole S^T and dP^T
//                      (over all 256 columns, so those two products are
//                      made twice a pair: the work of 7 products of 64 x
//                      64 x 256 a pair against 5), and sums dK and dV for
//                      its 128 columns (m64n128k16 from its half of Q and
//                      dO): 128 registers, as the hd-128 build's.  The columns
//                      are disjoint, so nothing is folded; K, V and a
//                      two-stage Q/dO ring take 193 KB.  Handing P^T and
//                      dS^T from one warpgroup to the other through shared
//                      memory would save the repeated products at the cost
//                      of a hand-off a pair; the simpler split came first.
//   flash_bwd_kv_sum   where the G heads were split into parts: the float32
//                      partials summed over the parts in order, cast.
//   flash_bwd_dq_wg    dQ: an item is a 128-row q tile of one (batch, head),
//                      Q and dO resident, K and V streamed through a
//                      three-stage ring; each warpgroup owns 64 rows and per
//                      kv tile issues S = Q K^T and dP = dO V^T (K-major),
//                      forms dS and issues dQ += (hi + lo) K (K MN-major).
//                      At hd 256 a consumer's dQ is 64 x 256 float32 (128
//                      registers) and Q and dO take 128 KB, so the K/V ring
//                      has one stage of 64 KB (192 KB in all): the producer
//                      loads the next tile once both warpgroups are done
//                      with this one, and the load is not hidden.
//   Rounding.  P is rounded to bf16 for dV, as the forward rounds it and as
//   the plain version does.  dS rounded once to bf16 left the kernel's dQ
//   and dK up to 2.12 times as far from the float32 plain version as the
//   bf16 plain version's own rounding (on an H100, the 2 x 4 x 70 x 16
//   case; 1.2-1.9 elsewhere), past the tests' spread rule of 2; as hi + lo
//   the ratio is 1.000 at every tested shape, for one more product in each
//   kernel (5 instead of 4 a pair in dK/dV, 4 instead of 3 a tile in dQ).
//   Balance (the dK/dV grid).  Under the causal mask kv tile 0 is seen by
//   every q tile and the last by one: at the train step 128 (batch, kv head,
//   kv tile) items of 6 heads x 8..1 q tiles, the longest 48 pairs against
//   a mean of 26.2 an SM.  So the G heads are split into `parts` (the
//   smallest divisor of G that gives at least one item an SM; 2 here) whose
//   float32 partials a second pass sums in a fixed order, and the items are
//   numbered longest first and dealt to persistent blocks (one an SM) in
//   rounds that alternate direction, as the forward's item_of: at the train
//   step 256 items of 24..3 pairs, the busiest SM 27 pairs against the mean
//   26.2.  The alternative, splitting the heads between the warpgroups of
//   one block, leaves kv tile 0's block with 48.  The partials cost 16.8 MB
//   written and read again (mostly in the 50 MB L2).
//   Registers: a consumer holds dK and dV (64 x hd float32: 128 registers at
//   hd 128), S^T and dP^T (32 each) and the A fragments (16 each, P^T's
//   packed while dS^T's two are formed from dP^T's registers); nothing
//   is pipelined across pairs (two pairs' S^T and dP^T would not fit), and
//   the two warpgroups' phases interleave instead.  setmaxnreg gives the
//   producer 24 and the consumers 240 of the 168 a thread at launch, as in
//   the forward; launch refuses another ptxas count (cudaErrorInvalid-
//   KernelImage).  Every input of a wgmma other than accumulators and
//   descriptor offsets is made before its fence, and nothing writes a
//   wgmma's registers while it runs (else ptxas serialises the wgmmas, its
//   warning C7513).
//
// SIMT route (float32 throughout, and bf16 that TMA cannot describe), three
// launches:
//   flash_bwd_prep  one block of 256 threads (16 x 16) per (batch, head, 64-row
//                   q tile).  It recomputes each row's LSE with the forward's
//                   online softmax over the kv tiles the rows see (one more
//                   Q K^T pass) and D, and writes both as float32 [B, H, Sq]
//                   scratch.
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
//   Tiles are float32 in shared memory, rows of Q, K, V and dO padded to hd + 4
//   floats so that 16-byte loads fall on distinct banks: 170 KB for dK/dV and
//   153 KB for dQ at hd 128, one block an SM.  At hd 256 four 64-row tiles
//   would take 266 KB, so the q tiles of flash_bwd_dkdv and flash_bwd_dq
//   have 32 rows (kQRowsOf: each thread 2 x 4 entries of S and dP), 212 KB
//   and 204 KB; a thread's dK and dV are then 4 rows by 16 columns each
//   (128 registers).  Builds for hd 64, 128 and 256; a smaller hd runs in
//   the next larger build with zero columns (hd 129-255 in the 256 build,
//   on both routes).  It keeps
//   the float32 gradient float32 (phase 25's card-vs-CPU step); it is far
//   from the float32 bound (240 us) by design.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing (the wrapper allocates the gradients and the
// scratch) and returns a cudaError_t code.

#include "../../csrc/hopper.cuh"  // wgmma, TMA and mbarrier helpers

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

// q rows of the dK/dV and dQ kernels' tiles: 64, or 32 at hd 256, where
// four 64-row float32 tiles (66.5 KB each) would not fit in shared memory
template <int HD> constexpr int kQRowsOf = HD > 128 ? 32 : 64;

// rows [r0, r0 + R) of a [rows, hd] matrix into an [R][HD + 4] float tile,
// zero past the rows and past hd
template <typename T, int HD, int R = kB>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int hd) {
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    dst[r * Ld<HD>::kRow + d] =
        (row < rows && d < hd) ? to_f32(src[(long long)row * hd + d]) : 0.0f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over an [16 MI][HD +
// 4] tile a and a [64][HD + 4] tile b
template <int HD, int MI = 4>
__device__ __forceinline__ void dot_tile(float (&acc)[MI][4], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int kL = Ld<HD>::kRow;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * kL + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * kL + d]);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// The kv tiles an R-row q tile from q0 sees.
template <int R = kB>
__device__ __forceinline__ int kv_tiles(int q0, int sq, int skv, bool causal,
                                        int prefix) {
  int n = (skv + kB - 1) / kB;
  if (causal) n = min(n, causal_limit(min(q0 + R, sq) - 1, prefix) / kB + 1);
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
template <int HD, int MI>
__device__ __forceinline__ void p_and_ds(float (&p)[MI][4], float (&ds)[MI][4],
                                         const float* qs, const float* ks,
                                         const float* dos, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         int sq, int skv, bool causal,
                                         int prefix, float scale, int tx,
                                         int ty) {
  dot_tile<HD, MI>(p, qs, ks, tx, ty);
  dot_tile<HD, MI>(ds, dos, vs, tx, ty);       // dP
#pragma unroll
  for (int i = 0; i < MI; ++i) {
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
  constexpr int kQr = kQRowsOf<HD>;  // q rows per tile
  constexpr int kMi = kQr / 16;      // of them a thread's in S and dP
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + Ld<HD>::kTile;
  float* qs = vs + Ld<HD>::kTile;      // [kQr][HD + 4]
  float* dos = qs + kQr * kL;          // [kQr][HD + 4]
  float* ps = dos + kQr * kL;          // [kQr q rows][kLdP]
  float* dss = ps + kQr * kLdP;        // [kQr q rows][kLdP]
  float* lse_s = dss + kQr * kLdP;     // [kQr]
  float* delta_s = lse_s + kQr;        // [kQr]

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
  const int qt0 = (causal && prefix - 1 < k0) ? k0 / kQr : 0;
  const int n_qt = (sq + kQr - 1) / kQr;
  for (int g = 0; g < group; ++g) {
    const long long bh = (long long)b * heads + hk * group + g;
    const long long q_base = bh * sq * hd;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kQr;
      __syncthreads();                 // the previous tile's Q, dO, P, dS used
      stage<T, HD, kQr>(qs, q + q_base, q0, sq, hd);
      stage<T, HD, kQr>(dos, dout + q_base, q0, sq, hd);
      if (t < kQr) {
        const int row = q0 + t;
        lse_s[t] = row < sq ? lse[bh * sq + row] : 0.0f;
        delta_s[t] = row < sq ? delta[bh * sq + row] : 0.0f;
      }
      __syncthreads();

      float p[kMi][4], ds[kMi][4];
      p_and_ds<HD, kMi>(p, ds, qs, ks, dos, vs, lse_s, delta_s, q0, k0, sq,
                        skv, causal, prefix, scale, tx, ty);
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * kLdP + tx + 16 * j] = round_p<T>(p[i][j]);
          dss[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV[kv row][d] += P[j][kv row] dO[j][d]; dK likewise from dS and Q
#pragma unroll 2
      for (int j = 0; j < kQr; ++j) {
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
  constexpr int kQr = kQRowsOf<HD>;  // q rows per tile
  constexpr int kMi = kQr / 16;      // of them a thread's
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [kQr][HD + 4]
  float* dos = qs + kQr * kL;                      // [kQr][HD + 4]
  float* ks = dos + kQr * kL;
  float* vs = ks + Ld<HD>::kTile;
  float* dss = vs + Ld<HD>::kTile;     // [kQr q rows][kLdP]
  float* lse_s = dss + kQr * kLdP;
  float* delta_s = lse_s + kQr;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQr;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  const long long q_base = bh * sq * hd;
  const long long kv_base =
      ((long long)b * (heads / group) + h / group) * skv * hd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;

  stage<T, HD, kQr>(qs, q + q_base, q0, sq, hd);
  stage<T, HD, kQr>(dos, dout + q_base, q0, sq, hd);
  if (t < kQr) {
    const int row = q0 + t;
    lse_s[t] = row < sq ? lse[bh * sq + row] : 0.0f;
    delta_s[t] = row < sq ? delta[bh * sq + row] : 0.0f;
  }

  float dqa[kMi][kNc];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c) dqa[i][c] = 0.0f;

  const int n_tiles = kv_tiles<kQr>(q0, sq, skv, causal, prefix);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                   // the previous K, V and dS are used
    stage<T, HD>(ks, k + kv_base, k0, skv, hd);
    stage<T, HD>(vs, v + kv_base, k0, skv, hd);
    __syncthreads();

    float p[kMi][4], ds[kMi][4];
    p_and_ds<HD, kMi>(p, ds, qs, ks, dos, vs, lse_s, delta_s, q0, k0, sq,
                      skv, causal, prefix, scale, tx, ty);
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ[q row][d] += dS[q row][j] K[j][d]
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float dsj[kMi], kv[kNc];
#pragma unroll
      for (int i = 0; i < kMi; ++i) dsj[i] = dss[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kNc; ++c) kv[c] = ks[j * kL + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int c = 0; c < kNc; ++c) dqa[i][c] = fmaf(dsj[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kMi; ++i) {
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
  constexpr int kQr = kQRowsOf<HD>;
  constexpr size_t tile = sizeof(float) * Ld<HD>::kTile;      // 64 rows
  constexpr size_t qtile = sizeof(float) * kQr * Ld<HD>::kRow;
  constexpr size_t pds = sizeof(float) * kQr * kLdP;
  constexpr size_t rows = sizeof(float) * 2 * kQr;
  constexpr size_t prep_bytes = 2 * tile;
  constexpr size_t dkdv_bytes = 2 * tile + 2 * qtile + 2 * pds + rows;
  constexpr size_t dq_bytes = 2 * tile + 2 * qtile + pds + rows;
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
  const dim3 dq_grid((unsigned)((sq + kQr - 1) / kQr), (unsigned)heads,
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
  flash_bwd_dq<T, HD><<<dq_grid, kThreads, dq_bytes, stream>>>(
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
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch,
                          heads, kv_heads, sq, skv, hd, causal, prefix, scale,
                          stream);
  return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, batch, heads,
                        kv_heads, sq, skv, hd, causal, prefix, scale, stream);
}

// ---------------------------------------------------------------- bf16
namespace wg {

using namespace hopper;

constexpr int kBn = 64;                // kv rows per tile
constexpr int kBq = 64;                // q rows per dK/dV pair
constexpr int kBm = 128;               // q rows per dQ item (64 a consumer)
constexpr int kPad = kBm;              // the rows scratch pads Sq to this
constexpr int kConsumers = 256;        // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// as the forward's flash_wgmma: one block of 384 threads an SM starts at 168
// registers a thread; the producer warpgroup gives back 144 (its first
// warp's lane 0 issues every copy, the rest exit), lifting the consumers to
// 240.  launch refuses a build that ptxas gave another count.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * kLaunchRegs,
              "setmaxnreg asks for more registers than the block holds");
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of flash_bwd_dkdv_wg (byte offsets; tiles 1024-aligned): K
// and V of the item's kv tile, the Q and dO ring, the warpgroups' fold
// buffer (64 x HD float32; none where they split the columns), the ring's
// LSE/D rows (64 float2 a stage), then mbarriers: kv_full, kv_empty, then
// per stage full and empty.  Up to hd 128 the warpgroups take the pairs in
// turn through a four-stage ring; at hd 256 (kSplit) each takes every pair
// and half of the columns, through a two-stage ring (193 KB; three stages
// would need 257 KB).
template <int HD>
struct KvSmem {
  static constexpr bool kSplit = HD > 128;
  static constexpr int kStages = kSplit ? 2 : 4;
  static constexpr int kTile = kBn * HD * 2;
  static constexpr int kK = 0, kV = kTile;
  static constexpr int kQ = 2 * kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kRed = kDo + kStages * kTile;
  static constexpr int kRows = kRed + (kSplit ? 0 : kBn * HD * 4);
  static constexpr int kBars = kRows + kStages * kBq * 8;
  static constexpr size_t kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
  static constexpr int kFull = 2, kEmpty = 2 + kStages;
  // the warps whose arrivals free a stage: the consuming warpgroup's, or
  // both warpgroups' where each takes every pair
  static constexpr int kEmptyArrivals = kSplit ? kConsumers / 32 : 4;
};
constexpr int kKvFull = 0, kKvEmpty = 1;

// shared memory of flash_bwd_dq_wg: the item's Q and dO (128 rows each),
// then the K and V ring; mbarriers q_full, q_empty, then per stage full and
// empty.  Three stages up to hd 128; one at 256, where Q and dO take 128 KB
// and a stage 64 KB (two would need 257 KB).
template <int HD>
struct QSmem {
  static constexpr int kStages = HD > 128 ? 1 : 3;
  static constexpr int kQTile = kBm * HD * 2;
  static constexpr int kTile = kBn * HD * 2;
  static constexpr int kQ = 0, kDo = kQTile;
  static constexpr int kK = 2 * kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr size_t kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
  static constexpr int kRingFull = 2, kRingEmpty = 2 + kStages;
};
constexpr int kQFull = 0, kQEmpty = 1;

// byte offset of k16 step kk (16 of hd's columns) in a K-major tile of
// `rows` rows: 64-column blocks of rows x 128 bytes
template <int rows>
__device__ __forceinline__ constexpr uint32_t k_step(int kk) {
  return (kk >> 2) * rows * 128 + (kk & 3) * 32;
}

// D[64 x 64] = A B^T over hd: HD / 16 wgmma m64n64k16, both operands K-major
// from shared memory through base descriptors of tiles of ra and rb rows;
// issued, not awaited.  The first step overwrites D.
template <int HD, int ra, int rb>
__device__ __forceinline__ void issue_dot(float (&d)[32], uint64_t a,
                                          uint64_t b, int overwrite,
                                          int accumulate) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(d, a + (k_step<ra>(kk) >> 4), b + (k_step<rb>(kk) >> 4),
             kk == 0 ? overwrite : accumulate);
}

// D[64 x N] += A B over 64 rows of B: four wgmma m64n{N}k16, A's bf16
// fragments from registers, B MN-major (a tile of 64 rows, its 64-column
// blocks 64 x 128 bytes apart) through its base descriptor; issued, not
// awaited
template <int N>
__device__ __forceinline__ void issue_acc(float (&d)[N / 2],
                                          const uint32_t (&a)[4][4],
                                          uint64_t b, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bk = b + ((kk * 16 * 128) >> 4);
    if constexpr (N == 256) wgmma_rs_n256(d, a[kk], bk, accumulate);
    else if constexpr (N == 128) wgmma_rs_n128(d, a[kk], bk, accumulate);
    else wgmma_rs_n64(d, a[kk], bk, accumulate);
  }
}

// an accumulator fragment of 64 columns rounded to bf16: columns 16 kk ..
// 16 kk + 15 are the A fragment of the kk-th k16 step of the next product
__device__ __forceinline__ void to_a(const float (&s)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// the same fragment as two bf16 terms, hi = bf16(s) and lo = bf16(s - hi):
// hi + lo carries 16 significant bits, so a product with both is within
// 2^-17 of one with s in float32
__device__ __forceinline__ void to_a2(const float (&s)[32],
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 f = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - f.x, b - f.y);
    }
}

// the n-th item of this block: rounds of gridDim.x, every other round in
// reverse, over items numbered longest first (the forward's item_of)
__device__ __forceinline__ int item_of(int n) {
  return n * gridDim.x +
         ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// ------------------------------------------------------------------ rows
// Per q row of the [B * H, sq_pad] scratch: (LSE log2(e), D = rowsum(dO * O))
// for rows < sq, (+inf, 0) past them, so that a padded row's P is exactly 0.
// A half warp per row, 16-byte vectors of O and of dO, a lane's at columns
// 8 l, 8 l + 128 (hd a multiple of 8, aligned rows).
__global__ void __launch_bounds__(256)
flash_bwd_rows(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float2* __restrict__ rows,
               int sq, int sq_pad, int hd) {
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) >> 4;
  const int l = threadIdx.x & 15;
  const long long bh = row / sq_pad;
  const int qpos = (int)(row % sq_pad);
  float d = 0.0f;
  if (qpos < sq)
    for (int c = 8 * l; c < hd; c += 128) {
      const long long at = (bh * sq + qpos) * hd + c;
      const uint4 a = *reinterpret_cast<const uint4*>(o + at);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
      const bf16* x = reinterpret_cast<const bf16*>(&a);
      const bf16* y = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d = fmaf(__bfloat162float(x[i]), __bfloat162float(y[i]), d);
    }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (l == 0)
    rows[row] = qpos < sq ? make_float2(lse[bh * sq + qpos] * kLog2e, d)
                          : make_float2(__int_as_float(0x7f800000), 0.0f);
}

// ------------------------------------------------------------------ dK, dV
// An item: one 64-row kv tile of one (batch, kv head) and one part of its G
// q heads (ng heads from g0); its pairs are (head, 64-row q tile) for the q
// tiles that see the kv tile, heads outer.
struct KvItem {
  int k0, bkvh, g0, ng, qt0, nq;
};

__device__ __forceinline__ KvItem kv_item(int w, int parts, int bkv_parts,
                                          int group, int sq, bool causal,
                                          int prefix) {
  KvItem it;
  const int r = w % bkv_parts;
  it.k0 = w / bkv_parts * kBn;
  it.bkvh = r / parts;
  it.ng = group / parts;
  it.g0 = r % parts * it.ng;
  // the first q tile that sees the kv tile: its diagonal's, or 0 where the
  // prefix reaches the tile
  it.qt0 = (causal && prefix - 1 < it.k0) ? it.k0 / kBq : 0;
  it.nq = max(0, (sq + kBq - 1) / kBq - it.qt0);
  return it;
}

// one warpgroup's 64 x HD accumulator (a summed dK or dV) to rows k0 + rw,
// k0 + rw + 8 of its kv head: bf16 times mult, or a float32 partial
template <int HD>
__device__ __forceinline__ void store_kv(const float (&a)[HD / 2],
                                         bf16* __restrict__ out,
                                         float* __restrict__ part, int row0,
                                         int cq, int skv, int hd,
                                         float mult) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= skv || c >= hd) continue;
      const float x = a[4 * j + 2 * half], y = a[4 * j + 2 * half + 1];
      const long long at = (long long)row * hd + c;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + at) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(x * mult, y * mult);
    }
  }
}

// dK and dV.  Persistent: a block per SM walks its items (item_of), each
// item's K and V staying in shared memory while the producer streams the
// pairs' Q, dO and LSE/D through a ring.  Up to hd 128 the two consumer
// warpgroups take the item's pairs in turn (even, odd) and fold their sums
// at the end; at hd 256 each takes every pair, forms the whole S^T and
// dP^T, and sums dK and dV for its half of the columns (128 registers a
// thread, as the hd-128 build's whole ones), so there is nothing to fold.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float2* __restrict__ rows, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ part,
                  int bkv_heads, int group, int sq, int sq_pad, int skv,
                  int hd, bool causal, int prefix, int parts,
                  float scale_log2, float scale) {
  using L = KvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;
#define BAR(i) (bars + 8u * (uint32_t)(i))

  const int bkv_parts = bkv_heads * parts;
  const int n_items = (skv + kBn - 1) / kBn * bkv_parts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  constexpr int kStages = L::kStages, kFull = L::kFull, kEmpty = L::kEmpty;
  if (threadIdx.x == 0) {
    mbar_init(BAR(kKvFull), 1);
    mbar_init(BAR(kKvEmpty), kConsumers / 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(BAR(kFull + s), 1);
      mbar_init(BAR(kEmpty + s), L::kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ----------------------------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0) return;
    int t = 0;                                  // pairs loaded so far
    for (int n = 0, w = item_of(0); w < n_items; w = item_of(++n)) {
      const KvItem it = kv_item(w, parts, bkv_parts, group, sq, causal,
                                prefix);
      if (n > 0)           // both warpgroups are done with the last K, V
        mbar_wait(BAR(kKvEmpty), (n - 1) & 1);
      mbar_expect_tx(BAR(kKvFull), 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        tma_load(base + L::kK + c * kBn * 128, &tk, BAR(kKvFull), c * 64,
                 it.k0, it.bkvh);
        tma_load(base + L::kV + c * kBn * 128, &tv, BAR(kKvFull), c * 64,
                 it.k0, it.bkvh);
      }
      for (int g = 0; g < it.ng; ++g) {
        const int bh = it.bkvh * group + it.g0 + g;
        for (int qt = it.qt0; qt < it.qt0 + it.nq; ++qt, ++t) {
          const int s = t % kStages;
          if (t >= kStages)   // its consumers are done with pair t - S
            mbar_wait(BAR(kEmpty + s), ((t / kStages) & 1) ^ 1);
          mbar_expect_tx(BAR(kFull + s), 2 * L::kTile + kBq * 8);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            tma_load(base + L::kQ + s * L::kTile + c * kBq * 128, &tq,
                     BAR(kFull + s), c * 64, qt * kBq, bh);
            tma_load(base + L::kDo + s * L::kTile + c * kBq * 128, &tdo,
                     BAR(kFull + s), c * 64, qt * kBq, bh);
          }
          bulk_load(base + L::kRows + s * kBq * 8,
                    rows + (long long)bh * sq_pad + qt * kBq, kBq * 8,
                    BAR(kFull + s));
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // 0 or 1, warp-uniform to the compiler, so that addresses stay uniform
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int cq = 2 * (lane & 3);      // its column in each 8-column group
  const int rw = 16 * (warp & 3) + (lane >> 2);  // its kv rows rw, rw + 8
  // the columns of its dK and dV: all, or its half where the warpgroups
  // split them (c0 = 0 or 128)
  constexpr int kN = L::kSplit ? HD / 2 : HD;
  const int c0 = L::kSplit ? wgi * kN : 0;
  const uint64_t kd = descriptor(base + L::kK, 16, 1024);
  const uint64_t vd = descriptor(base + L::kV, 16, 1024);
  auto release = [&](uint32_t bar) {   // this warp is done with a buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int t = 0;                                     // ring position of pair 0
  for (int n = 0, w = item_of(0); w < n_items; w = item_of(++n)) {
    const KvItem it = kv_item(w, parts, bkv_parts, group, sq, causal,
                              prefix);
    const int np = it.ng * it.nq;
    float dka[kN / 2], dva[kN / 2];
    zero(dka);
    zero(dva);
    mbar_wait(BAR(kKvFull), n & 1);
    for (int p = L::kSplit ? 0 : wgi; p < np; p += L::kSplit ? 1 : 2) {
      const int pt = t + p, s = pt % kStages;
      const int q0 = (it.qt0 + p % it.nq) * kBq;
      mbar_wait(BAR(kFull + s), (pt / kStages) & 1);
      const uint32_t qb = base + L::kQ + s * L::kTile;
      const uint32_t db = base + L::kDo + s * L::kTile;
      uint64_t qd = descriptor(qb, 16, 1024), dd = descriptor(db, 16, 1024);
      // Q's and dO's 64-column blocks from column c0, MN-major
      uint64_t qm = descriptor(qb + c0 / 64 * kBq * 128, kBq * 128, 1024);
      uint64_t dm = descriptor(db + c0 / 64 * kBq * 128, kBq * 128, 1024);
      int overwrite = 0, accumulate = 1;
      asm volatile("" : "+l"(qd), "+l"(dd), "+l"(qm), "+l"(dm),
                   "+r"(overwrite), "+r"(accumulate));
      // S^T = K Q^T and dP^T = V dO^T (64 kv rows x 64 q columns)
      float st[32], dpt[32];
      zero(st);
      zero(dpt);
      pin(st);
      pin(dpt);
      wgmma_fence();
      issue_dot<HD, kBn, kBq>(st, kd, qd, overwrite, accumulate);
      issue_dot<HD, kBn, kBq>(dpt, vd, dd, overwrite, accumulate);
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      pin(dpt);
      // P^T = exp2(S^T scale log2(e) - LSE log2(e)), 0 where masked;
      // dS^T = P^T (dP^T - D)
      const float4* rd4 =
          reinterpret_cast<const float4*>(smem + L::kRows + s * kBq * 8);
      const bool masked =
          causal && it.k0 + kBn - 1 > causal_limit(q0, prefix);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 rd = rd4[(8 * j + cq) >> 1];   // columns cq, cq + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = (e & 1) ? rd.z : rd.x;
          const float dd_ = (e & 1) ? rd.w : rd.y;
          float pe = ex2(fmaf(st[4 * j + e], scale_log2, -l2));
          if (masked) {
            const int kpos = it.k0 + rw + 8 * (e >> 1);
            const int qpos = q0 + 8 * j + cq + (e & 1);
            if (kpos > causal_limit(qpos, prefix)) pe = 0.0f;
          }
          st[4 * j + e] = pe;
          dpt[4 * j + e] = pe * (dpt[4 * j + e] - dd_);
        }
      }
      uint32_t pa[4][4], da[4][4], dl[4][4];
      to_a(st, pa);
      to_a2(dpt, da, dl);
      // dV += P^T dO, dK += dS^T Q (Q and dO MN-major; dS^T as hi + lo)
      pin(dva);
      pin(dka);
      pin(pa);
      pin(da);
      pin(dl);
      wgmma_fence();
      issue_acc<kN>(dva, pa, dm, accumulate);
      issue_acc<kN>(dka, da, qm, accumulate);
      issue_acc<kN>(dka, dl, qm, accumulate);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dva);
      pin(dka);
      pin(pa);
      pin(da);
      pin(dl);
      release(BAR(kEmpty + s));
    }
    t += np;
    release(BAR(kKvEmpty));            // its products with K and V are done

    const long long head = (long long)it.bkvh * skv * hd;
    const long long pstride = (long long)bkv_heads * skv * hd;
    const int pi = it.g0 / it.ng;            // this item's part
    float* dv_part = parts > 1 ? part + (parts + pi) * pstride + head
                               : nullptr;
    float* dk_part = parts > 1 ? part + pi * pstride + head : nullptr;
    if constexpr (L::kSplit) {
      // its own columns of both: nothing to fold
      store_kv<kN>(dva, dv + head, dv_part, it.k0 + rw, c0 + cq, skv, hd,
                   1.0f);
      store_kv<kN>(dka, dk + head, dk_part, it.k0 + rw, c0 + cq, skv, hd,
                   scale);
    } else {
      // fold: dV = dV_0 + dV_1 in warpgroup 0, dK = dK_1 + dK_0 in
      // warpgroup 1 (each a single float32 addition, so the bits do not
      // depend on which warpgroup finished first), through red, thread by
      // thread
      const int tid = threadIdx.x & 127;
      float* red = reinterpret_cast<float*>(smem + L::kRed);
      if (wgi == 1) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) red[i * 128 + tid] = dva[i];
      }
      named_sync(1, kConsumers);
      if (wgi == 0) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) {
          dva[i] += red[i * 128 + tid];
        }
      }
      named_sync(1, kConsumers);
      if (wgi == 0) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) red[i * 128 + tid] = dka[i];
      }
      named_sync(1, kConsumers);
      if (wgi == 0) {
        store_kv<HD>(dva, dv + head, dv_part, it.k0 + rw, cq, skv, hd, 1.0f);
      } else {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) dka[i] += red[i * 128 + tid];
        store_kv<HD>(dka, dk + head, dk_part, it.k0 + rw, cq, skv, hd, scale);
      }
    }
  }
#undef BAR
}

// dK = scale sum_p dK_p, dV = sum_p dV_p over the parts in order, two
// columns a thread; part [2][parts][n]
__global__ void __launch_bounds__(256)
flash_bwd_kv_sum(const float* __restrict__ part, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, long long n, int parts, float scale) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 2;
  if (i >= n) return;
  float2 a = make_float2(0.0f, 0.0f), b = a;
  for (int p = 0; p < parts; ++p) {
    const float2 x = *reinterpret_cast<const float2*>(part + p * n + i);
    const float2 y =
        *reinterpret_cast<const float2*>(part + (parts + p) * n + i);
    a.x += x.x;
    a.y += x.y;
    b.x += y.x;
    b.y += y.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + i) =
      __floats2bfloat162_rn(a.x * scale, a.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv + i) = __floats2bfloat162_rn(b.x, b.y);
}

// --------------------------------------------------------------------- dQ
// An item: one 128-row q tile of one (batch, head), numbered longest first
// (the forward's Item and item_at).
struct QItem {
  int q0, qh, kvh, n_tiles;
};

__device__ __forceinline__ QItem q_item(int w, int n_qt, int batch_heads,
                                        int heads, int group, int sq, int skv,
                                        bool causal, int prefix) {
  QItem it;
  it.q0 = (n_qt - 1 - w / batch_heads) * kBm;
  it.qh = w % batch_heads;
  it.kvh = it.qh / heads * (heads / group) + it.qh % heads / group;
  it.n_tiles = (skv + kBn - 1) / kBn;
  if (causal)
    it.n_tiles = min(it.n_tiles,
                     causal_limit(min(it.q0 + kBm, sq) - 1, prefix) / kBn + 1);
  return it;
}

// dQ.  Persistent as the forward: a block per SM walks (q tile, head)
// items; Q and dO (128 rows) stay while the producer streams K and V
// through a ring; each consumer warpgroup owns 64 of the rows.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float2* __restrict__ rows, bf16* __restrict__ dq,
                int batch, int heads, int group, int sq, int sq_pad, int skv,
                int hd, bool causal, int prefix, float scale_log2,
                float scale) {
  using L = QSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBars;
#define BAR(i) (bars + 8u * (uint32_t)(i))

  const int n_qt = (sq + kBm - 1) / kBm, batch_heads = batch * heads;
  const int n_items = n_qt * batch_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  constexpr int kStages = L::kStages, kRingFull = L::kRingFull,
                kRingEmpty = L::kRingEmpty;
  if (threadIdx.x == 0) {
    mbar_init(BAR(kQFull), 1);
    mbar_init(BAR(kQEmpty), kConsumers / 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(BAR(kRingFull + s), 1);
      mbar_init(BAR(kRingEmpty + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ----------------------------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0) return;
    int t = 0;                                  // tiles copied so far
    for (int n = 0, w = item_of(0); w < n_items; w = item_of(++n)) {
      const QItem it = q_item(w, n_qt, batch_heads, heads, group, sq, skv,
                              causal, prefix);
      if (n > 0)           // both warpgroups are done with the last Q, dO
        mbar_wait(BAR(kQEmpty), (n - 1) & 1);
      mbar_expect_tx(BAR(kQFull), 2 * L::kQTile);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        tma_load(base + L::kQ + c * kBm * 128, &tq, BAR(kQFull), c * 64,
                 it.q0, it.qh);
        tma_load(base + L::kDo + c * kBm * 128, &tdo, BAR(kQFull), c * 64,
                 it.q0, it.qh);
      }
      for (int i = 0; i < it.n_tiles; ++i, ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // both warpgroups are done with tile t - S
          mbar_wait(BAR(kRingEmpty + s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(BAR(kRingFull + s), 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load(base + L::kK + s * L::kTile + c * kBn * 128, &tk,
                   BAR(kRingFull + s), c * 64, i * kBn, it.kvh);
          tma_load(base + L::kV + s * L::kTile + c * kBn * 128, &tv,
                   BAR(kRingFull + s), c * 64, i * kBn, it.kvh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int cq = 2 * (lane & 3);
  const int rw = 64 * wgi + 16 * (warp & 3) + (lane >> 2);  // row in tile
  const uint64_t qd = descriptor(base + L::kQ + wgi * 64 * 128, 16, 1024);
  const uint64_t dd = descriptor(base + L::kDo + wgi * 64 * 128, 16, 1024);
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int t = 0;
  for (int n = 0, w = item_of(0); w < n_items; w = item_of(++n)) {
    const QItem it = q_item(w, n_qt, batch_heads, heads, group, sq, skv,
                            causal, prefix);
    const int w0 = it.q0 + 64 * wgi;             // its first q row
    const int last = min(w0 + 63, sq - 1);       // < w0: no rows at all
    const int r0 = it.q0 + rw;                   // its rows r0 and r0 + 8
    int n_mine = 0;
    if (w0 <= last)
      n_mine = causal ? min(it.n_tiles, causal_limit(last, prefix) / kBn + 1)
                      : it.n_tiles;
    const float2 ra = rows[(long long)it.qh * sq_pad + r0];
    const float2 rb = rows[(long long)it.qh * sq_pad + r0 + 8];
    float dqa[HD / 2];
    zero(dqa);
    mbar_wait(BAR(kQFull), n & 1);
    for (int i = 0; i < n_mine; ++i) {
      const int k0 = i * kBn, tt = t + i, s = tt % kStages;
      mbar_wait(BAR(kRingFull + s), (tt / kStages) & 1);
      const uint32_t kb = base + L::kK + s * L::kTile;
      uint64_t kd = descriptor(kb, 16, 1024);
      uint64_t vd = descriptor(base + L::kV + s * L::kTile, 16, 1024);
      uint64_t km = descriptor(kb, kBn * 128, 1024);
      int overwrite = 0, accumulate = 1;
      asm volatile("" : "+l"(kd), "+l"(vd), "+l"(km), "+r"(overwrite),
                   "+r"(accumulate));
      // S = Q K^T and dP = dO V^T (64 q rows x 64 kv columns)
      float sa[32], dpa[32];
      zero(sa);
      zero(dpa);
      pin(sa);
      pin(dpa);
      wgmma_fence();
      issue_dot<HD, kBm, kBn>(sa, qd, kd, overwrite, accumulate);
      issue_dot<HD, kBm, kBn>(dpa, dd, vd, overwrite, accumulate);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sa);
      pin(dpa);
      const bool masked = k0 + kBn > skv ||
                          (causal && k0 + kBn - 1 > causal_limit(w0, prefix));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 rd = (e < 2) ? ra : rb;
          float pe = ex2(fmaf(sa[4 * j + e], scale_log2, -rd.x));
          if (masked) {
            const int kpos = k0 + 8 * j + cq + (e & 1);
            const int qpos = r0 + 8 * (e >> 1);
            if (kpos >= skv || (causal && kpos > causal_limit(qpos, prefix)))
              pe = 0.0f;
          }
          dpa[4 * j + e] = pe * (dpa[4 * j + e] - rd.y);
        }
      uint32_t da[4][4], dl[4][4];
      to_a2(dpa, da, dl);
      // dQ += dS K (K MN-major; dS as hi + lo)
      pin(dqa);
      pin(da);
      pin(dl);
      wgmma_fence();
      issue_acc<HD>(dqa, da, km, accumulate);
      issue_acc<HD>(dqa, dl, km, accumulate);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dqa);
      pin(da);
      pin(dl);
      release(BAR(kRingEmpty + s));
    }
    release(BAR(kQEmpty));             // its products with Q and dO are done
    for (int i = n_mine; i < it.n_tiles; ++i) {  // tiles it does not compute
      const int tt = t + i, s = tt % kStages;
      mbar_wait(BAR(kRingFull + s), (tt / kStages) & 1);
      release(BAR(kRingEmpty + s));
    }
    t += it.n_tiles;

    bf16* dst = dq + (long long)it.qh * sq * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + cq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= sq || c >= hd) continue;
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * hd + c) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * half] * scale,
                                  dqa[4 * j + 2 * half + 1] * scale);
      }
    }
  }
#undef BAR
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t ready_kernel(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != kLaunchRegs) return cudaErrorInvalidKernelImage;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const float* lse,
           float2* rows, float* part, int batch, int heads, int kv_heads,
           int sq, int skv, int hd, bool causal, int prefix, int parts,
           float scale, cudaStream_t stream) {
  const int bh = batch * heads, bkv = batch * kv_heads;
  const int sq_pad = (sq + kPad - 1) / kPad * kPad;
  // the device's context current on this thread before
  // cuTensorMapEncodeTiled encodes the tensor maps: autograd runs the
  // backward on a thread of its own, where nothing may have bound it yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  CUtensorMap m[6] = {};
  if (!(encode(&m[0], q, bh, sq, hd, kBq) &&
        encode(&m[1], dout, bh, sq, hd, kBq) &&
        encode(&m[2], q, bh, sq, hd, kBm) &&
        encode(&m[3], dout, bh, sq, hd, kBm) &&
        encode(&m[4], k, bkv, skv, hd, kBn) &&
        encode(&m[5], v, bkv, skv, hd, kBn)))
    return (int)cudaErrorInvalidValue;
  static bool ready[64] = {};        // one per build of the kernels
  static int sms[64] = {};
  if (!ready[dev]) {
    if ((err = ready_kernel(flash_bwd_dkdv_wg<HD>, KvSmem<HD>::kBytes)) !=
            cudaSuccess ||
        (err = ready_kernel(flash_bwd_dq_wg<HD>, QSmem<HD>::kBytes)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms[dev],
                                      cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return (int)err;
    ready[dev] = true;
  }
  const long long n_rows = (long long)bh * sq_pad;     // a multiple of 16
  if (n_rows / 16 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_rows<<<(unsigned)(n_rows / 16), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, rows,
      sq, sq_pad, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const float scale_log2 = scale * kLog2e;
  const int group = heads / kv_heads;
  const long long kv_items = (long long)(skv + kBn - 1) / kBn * bkv * parts;
  if (kv_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_dkdv_wg<HD><<<(unsigned)(kv_items < sms[dev] ? kv_items : sms[dev]),
                          kThreads, KvSmem<HD>::kBytes, stream>>>(
      m[0], m[1], m[4], m[5], rows, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, bkv, group, sq, sq_pad, skv, hd, causal,
      prefix, parts, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (parts > 1) {
    const long long n = (long long)bkv * skv * hd;       // even: hd % 8 == 0
    flash_bwd_kv_sum<<<(unsigned)((n / 2 + 255) / 256), 256, 0, stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, parts,
        scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const long long q_items = (long long)(sq + kBm - 1) / kBm * bh;
  if (q_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_wg<HD><<<(unsigned)(q_items < sms[dev] ? q_items : sms[dev]),
                        kThreads, QSmem<HD>::kBytes, stream>>>(
      m[2], m[3], m[4], m[5], rows, static_cast<bf16*>(dq), batch, heads,
      group, sq, sq_pad, skv, hd, causal, prefix, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace

// q, o, dout, dq [batch, heads, sq, hd]; k, v, dk, dv [batch, kv_heads, skv,
// hd]; all float32 (bf16 = 0) or all bf16 (bf16 = 1), contiguous; hd <= 256;
// prefix as the forward's (0 <= prefix <= skv, only with causal).
//   lse NULL: the SIMT route; scratch float32 [2, batch * heads * sq] (the
//     recomputed LSE, then D); part and parts unused.
//   lse the forward's float32 [batch, heads, sq]: the tensor-core route (bf16
//     only, hd a multiple of 8, q, k, v, o, dout 16-byte aligned); scratch
//     float32 [batch * heads, sq rounded up to 128, 2]; parts divides heads /
//     kv_heads; part float32 [2, parts, batch * kv_heads, skv, hd] where
//     parts > 1 (else unused).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, const void* lse, void* scratch,
                                   void* part, int batch, int heads,
                                   int kv_heads, int sq, int skv, int hd,
                                   int causal, int prefix, int bf16,
                                   int parts, float scale,
                                   cudaStream_t stream) {
  if (batch == 0 || sq == 0) return 0;
  if (batch < 0 || batch > 65535 || heads < 1 || heads > 65535 ||
      kv_heads < 1 || heads % kv_heads != 0 || sq < 0 || skv < 1 || hd < 1 ||
      hd > 256 || prefix < 0 || prefix > skv || (prefix > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  if (lse != nullptr) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                           (uintptr_t)o | (uintptr_t)dout;
    if (!bf16 || hd % 8 != 0 || ptrs % 16 != 0 || parts < 1 ||
        (heads / kv_heads) % parts != 0 || (parts > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    const float* l = static_cast<const float*>(lse);
    float2* rows = reinterpret_cast<float2*>(s);
    float* pp = static_cast<float*>(part);
    if (hd <= 64)
      return wg::launch<64>(q, k, v, o, dout, dq, dk, dv, l, rows, pp, batch,
                            heads, kv_heads, sq, skv, hd, causal != 0, prefix,
                            parts, scale, stream);
    if (hd <= 128)
      return wg::launch<128>(q, k, v, o, dout, dq, dk, dv, l, rows, pp, batch,
                             heads, kv_heads, sq, skv, hd, causal != 0,
                             prefix, parts, scale, stream);
    return wg::launch<256>(q, k, v, o, dout, dq, dk, dv, l, rows, pp, batch,
                           heads, kv_heads, sq, skv, hd, causal != 0, prefix,
                           parts, scale, stream);
  }
  float* dl = s + (long long)batch * heads * sq;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, s, dl, batch,
                                   heads, kv_heads, sq, skv, hd, causal != 0,
                                   prefix, scale, stream);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, s, dl, batch, heads,
                         kv_heads, sq, skv, hd, causal != 0, prefix, scale,
                         stream);
}
