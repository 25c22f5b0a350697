// Causal or non-causal GQA flash attention, by hand for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (body _flash_kernel).  q [B, H, Sq, hd], k and v [B, Hkv, Skv, hd], float32
// or bf16, all of one dtype; q head h reads kv head h / (H / Hkv); the output
// has q's layout and dtype.  Both dtypes share the mask (top-left causal,
// kpos <= qpos counted from 0, or with a prefix of P rows the prefix-LM mask
// kpos <= max(qpos, P - 1) of src/repro/models/attention.py:115-118, where
// the first P positions see each other; columns past Skv masked; masked
// scores become -1e30), an online softmax whose running max m and normaliser
// l are float32, a float32 accumulator, and the output acc / max(l, 1e-20)
// cast once.  Any Sq, Skv >= 1 and any hd from 1 to 256 are taken; P = 0 is
// the plain causal mask.  The dtypes differ where the products are rounded:
//
//   float32  q is multiplied by scale = 1/sqrt(hd) and the scores q.k^T are
//            float32, P stays float32 for P.V: the TPU kernel's function.
//   bf16     the scores are q.k^T of the bf16 inputs accumulated in float32,
//            then scaled by 1/sqrt(hd) in float32 (as the model does,
//            src/repro/models/attention.py:107); P = exp(s - m) is rounded to
//            bf16 for the P.V product, which accumulates in float32.  The
//            model rounds the normalised probabilities to bf16 instead
//            (attention.py:127); the two differ by where that one rounding
//            falls, which tests/test_torch_flash_attention.py bounds.
//
// Bound on an H100 SXM.  A causal head of S rows needs S (S + 1) / 2 (q, k)
// pairs at 4 hd flops each (q.k and p.v): at the qwen2-1.5b prefill (B = 8,
// H = 12, Hkv = 2, S = 512, hd = 128) 6.45 GFLOP.  In float32 that is 96 us at
// the 67 TFLOP/s FMA peak, so float32 is bound by operations.  In bf16 it is
// 6.5 us at the 989 TFLOP/s dense tensor-core peak, below the 29.4 MB of bf16
// q, k, v and output at 3.35 TB/s (8.8 us): bf16 is bound by bytes.  Both
// kernels compute whole 64 x 64 tiles on the diagonal: 1.125 times the
// causal work at S = 512.  At the paligemma-3b prefill (B = 8, H = 8, Hkv =
// 1, S = 768 of which a prefix of 256, hd = 256) a head has 327,936 visible
// pairs: 21.5 GFLOP, 21.7 us at the bf16 peak, above the 56.6 MB of bf16
// inputs and output at 3.35 TB/s (16.9 us): bound by operations.
//
// float32 design (flash_kernel, SIMT).  One block of 256 threads (a 16 x 16
// grid) per (batch, head, 64-row q tile) walks the kv tiles of 64 rows in a
// loop, which takes the place of the TPU's sequential ("arbitrary") kv grid
// axis.  The q tile (pre-scaled), a K tile and a V tile are staged in shared
// memory as float32, Q and K rows padded to hd + 4 floats so that 16-byte
// loads fall on distinct banks.  Each thread owns 4 rows and 4 columns of the
// 64 x 64 score tile, sums their dot products with float32 FMAs, reduces row
// max and row sum over the 16 threads of its row with shuffles, writes P over
// the K tile, and adds P.V for its rows and hd / 16 accumulator columns.  98 KB
// of shared memory at hd 128; builds for hd 16, 32, 64, 128 and 256.  At hd
// 256 the tiles take 198.7 KB, so one block fits an SM, and the build may
// use up to 255 registers for its 64 accumulator columns a thread.
//
// bf16 design (flash_wgmma: warp-specialised, tensor cores, persistent).  A
// block of 384 threads: two consumer warpgroups, each owning 64 rows of a
// 128-row q tile, and a producer warpgroup whose first warp issues every
// copy (its other three warps exit).  Shared memory holds Q (128 x hd bf16,
// 32 KB at hd 128) and a three-stage ring of K and V tiles of 64 kv rows (16
// KB each): 128 KB at hd 128.  Every tile is stored in the 128-byte swizzled
// layout that wgmma's shared-memory descriptors read: 64-column blocks of
// 128-byte rows, the 16-byte chunk j of row r at chunk j ^ (r % 8).  The
// producer writes it with TMA (one cp.async.bulk.tensor per 64 columns of a
// tile, through a 3-D tensor map [B * heads, S, hd] whose out-of-range rows
// and columns read as zeros, so ragged Sq, Skv and a head dim below the
// build's are padded by the copy), encoded on the host with
// cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint (no
// -lcuda).  Where TMA cannot express the tensor (hd not a multiple of 8, so
// rows are not 16-byte multiples, or a pointer not 16-byte aligned), a
// compile-time variant of the same kernel has the producer warp stage the
// tiles with ordinary loads into the same layout.  At hd 256 the ring has
// two stages (Q 64 KB and two stages of 32 KB K and V tiles: 192 KB of the
// 227 KB; three would need 256 KB): two stages keep the 64-row tiles, and so
// the m64n64 scores, the softmax and the P fragments of the other builds,
// where 32-row tiles would need another score shape and twice the hand-offs
// per kv row.  mbarriers carry the hand-offs: q_full and k_full / v_full per
// stage (the TMA's transaction count, or the 32 lanes' arrivals), q_empty and
// empty per stage (one arrival per consumer warp).  Each consumer warpgroup, per kv tile i:
//   1. issues S = Q K^T (64 x 64, float32): hd / 16 wgmma m64n64k16, both
//      operands K-major from shared memory; then, as a second group, tile
//      i - 1's P V: four wgmma m64n{hd}k16, P's bf16 A fragments from
//      registers, V MN-major ("transposed") through its descriptor;
//      at hd 256 the 64 x 256 float32 O takes 128 registers a thread, so
//      the 32 descriptors of Q and K (64 more) are not held: each k16
//      step's is formed from one base per operand where it is issued;
//   2. once S is done (wgmma.wait_group 1), while P V still runs: scales S
//      by log2(e) / sqrt(hd), masks it only where the tile crosses the
//      diagonal or Skv, and updates m and l with exp2, in place (row max
//      over the row's four threads by shuffles; l summed per thread and
//      reduced once at the end);
//   3. once P V is done: frees tile i - 1's stage, rescales O (64 x hd
//      float32, in registers) by exp2(m_old - m_new), and rounds P to bf16:
//      the accumulator fragment of S is the A fragment of the next P V, so
//      P never touches shared memory.
// Every input of a wgmma other than its accumulator is made before the
// wgmma fence (but for the hd-256 build's Q and K descriptors), and nothing
// writes a wgmma's registers while it runs: else ptxas serialises every
// wgmma of the kernel (its warning C7513).
// Under the causal mask the kv loop stops at the tile that holds the q
// tile's last diagonal element (with a prefix, at least the prefix's last
// tile), and the first warpgroup skips the products of a tile wholly above
// its rows (it still waits for the tile and frees it).  The grid is
// persistent: one block per SM (132 on an H100 SXM) walks the (batch, head,
// q tile) items, numbered longest first and dealt in rounds that alternate
// direction (item_of), so that the long causal tiles spread over the SMs;
// the K/V ring runs on across items, and Q is reloaded as soon as both
// warpgroups' last S is done, so an item's last P V and its stores overlap
// the next item's loads.  At the qwen2-1.5b prefill there are
// 4 x 12 x 8 = 384 items, about 2.9 per block.  Where the caller passes an
// lse buffer (a training forward), the epilogue also writes each row's
// natural-log logsumexp, (m + log2 l) ln 2 from the log2-domain m and l,
// which the backward (flash_attention_bwd.cu) reads instead of recomputing
// Q K^T; with none (every serve) the kernel computes the same bits as
// before.
//
// Occupancy (ptxas -v, sm_90a): 168 registers a thread at launch, one block
// of 384 threads per SM; setmaxnreg gives the producer warpgroup 24 and the
// consumers 240 (40 and 232 in the variant with ordinary loads, whose
// producer spills at 24); no spills in the TMA variants.  Two blocks of 288
// threads (one producer warp) would start at 96 registers a thread, as
// ptxas counts them per SM sub-partition, and the consumers' 64 x hd float32
// accumulator alone takes 64; so one block per SM, with a deeper ring (three
// stages instead of two) in the shared memory the second block would have
// used.  Builds for hd 64, 128 and 256.
//
// Plain C interface for ctypes: enqueues on the given stream, does not
// synchronise, allocates nothing and returns a cudaError_t code.

#include "../../csrc/hopper.cuh"  // wgmma, TMA and mbarrier helpers

namespace {

// ------------------------------------------------------------- float32


constexpr int kBq = 64;             // q rows per block
constexpr int kBk = 64;             // kv rows per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLdP = kBk + 4;       // P row stride (floats)
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

// the last key a query at qpos sees under the causal mask: kpos <=
// max(qpos, prefix - 1) (prefix 0: kpos <= qpos)
__device__ __forceinline__ int causal_limit(int qpos, int prefix) {
  return max(qpos, prefix - 1);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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

// HD: the build's head dim; hd <= HD the inputs' (extra columns are zero).
// Two blocks an SM up to hd 128; one at 256, whose tiles fill the SM.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD > 128 ? 1 : 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int heads,
             int group, int sq, int skv, int hd, bool causal, int prefix,
             float scale) {
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
  if (causal)       // up to the tile of the last row's limit (diagonal, prefix)
    n_tiles = min(n_tiles,
                  causal_limit(min(q0 + kBq, sq) - 1, prefix) / kBk + 1);
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
        if (kpos >= skv || (causal && kpos > causal_limit(qpos, prefix)))
          s[r][c] = kNegInf;
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
           int prefix, float scale, cudaStream_t stream) {
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
      heads / kv_heads, sq, skv, hd, causal, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int heads, int kv_heads, int sq, int skv, int hd,
             bool causal, int prefix, float scale, cudaStream_t stream) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal, prefix, scale, stream);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal, prefix, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal, prefix, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                          causal, prefix, scale, stream);
  return launch<T, 256>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                        causal, prefix, scale, stream);
}


// ---------------------------------------------------------------- bf16
namespace wg {

using namespace hopper;

constexpr int kBm = 128;               // q rows per block
constexpr int kBn = 64;                // kv rows per tile (S is m64n64)
// K/V ring depth: three stages up to hd 128; two at 256, where a stage is
// 64 KB and Q 64 KB (the barrier slots are laid out for kMaxStages)
template <int HD> constexpr int kStagesOf = HD > 128 ? 2 : 3;
constexpr int kMaxStages = 3;
constexpr int kConsumers = 256;        // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// one block of 384 threads on an SM starts at 168 registers a thread; the
// producer warpgroup (whose first warp issues the copies, the other three
// exit) gives back 144, which lifts the 256 consumers to 240: 24 + 2 * 240
// of each SM sub-partition's 512.  The variant with ordinary loads keeps 40
// for the producer (its address arithmetic spills at 24) and 232 for them.
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
constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// byte offsets in the block's shared memory; every tile is 1024-byte aligned
template <int HD>
struct Smem {
  static constexpr int kStages = kStagesOf<HD>;
  static constexpr int kQBytes = kBm * HD * 2;
  static constexpr int kTileBytes = kBn * HD * 2;
  static constexpr int kK = kQBytes;                       // Q, then K ring
  static constexpr int kV = kK + kStages * kTileBytes;     // then V ring
  static constexpr int kBars = kV + kStages * kTileBytes;  // then mbarriers
  // + slack to align the dynamic shared memory's start to 1024 bytes
  static constexpr size_t kBytes = kBars + 8 * (2 + 3 * kMaxStages) + 1024;
};
// mbarrier slots: q_full, q_empty, then per stage k_full, v_full and empty
constexpr int kQFull = 0, kQEmpty = 1, kKFull = 2, kVFull = 2 + kMaxStages,
              kEmpty = 2 + 2 * kMaxStages;

// rows [row0, row0 + rows) of one head (n_rows x hd, row-major) into a tile
// in the swizzled layout, zeros past n_rows and hd; for tensors TMA cannot
// describe.  The fence makes the stores visible to wgmma (the async proxy).
template <int HD>
__device__ void stage_rows(unsigned char* dst, const bf16* __restrict__ src,
                           int rows, int row0, int n_rows, int hd, int lane) {
  for (int i = lane; i < rows * HD; i += 32) {
    const int r = i / HD, c = i % HD, g = row0 + r;
    bf16 v = __float2bfloat16(0.0f);
    if (g < n_rows && c < hd) v = src[(long long)g * hd + c];
    *reinterpret_cast<bf16*>(dst + swizzled(rows, r, c)) = v;
  }
  fence_async_smem();
}

// The inputs of a warpgroup's products with one kv tile other than the
// accumulators and P: shared-memory descriptors and the scale-d flags (0:
// overwrite, 1: accumulate), made before the wgmma fence.  ptxas
// serialises the wgmmas of a stage if an input of one is computed between
// the fence and it (its warning C7513), a constant flag included.  At hd 256
// (kBased) Q and K keep one base each, and each k16 step's descriptor is
// the base plus the step's offset in 16-byte units (shared addresses stay
// below 2^18, so the 14-bit address field never carries): 32 descriptors
// would take 64 of the consumers' registers beside O's 128.
template <int HD>
struct Descs {
  static constexpr bool kBased = HD > 128;
  static constexpr int kSteps = kBased ? 1 : HD / 16;
  uint64_t q[kSteps], k[kSteps], v[kBn / 16];
  int overwrite, accumulate;
};

// byte offsets of k16 step kk in Q (128 rows) and in a K tile (64 rows)
__device__ __forceinline__ constexpr uint32_t q_step(int kk) {
  return (kk >> 2) * kBm * 128 + (kk & 3) * 32;
}
__device__ __forceinline__ constexpr uint32_t k_step(int kk) {
  return (kk >> 2) * kBn * 128 + (kk & 3) * 32;
}

template <int HD>
__device__ __forceinline__ uint64_t q_desc(const Descs<HD>& d, int kk) {
  if constexpr (Descs<HD>::kBased) return d.q[0] + (q_step(kk) >> 4);
  else return d.q[kk];
}
template <int HD>
__device__ __forceinline__ uint64_t k_desc(const Descs<HD>& d, int kk) {
  if constexpr (Descs<HD>::kBased) return d.k[0] + (k_step(kk) >> 4);
  else return d.k[kk];
}

// Q (its 64 rows at qa) and a K tile (at kb): K-major, the k16 step kk at
// byte 32 (kk % 4) of the 64-column block kk / 4; a V tile (at vb): MN-major,
// the k16 step kk at row 16 kk, 8-row groups 1024 bytes apart and 64-column
// blocks kBn * 128 bytes apart
template <int HD>
__device__ __forceinline__ void describe(Descs<HD>& d, uint32_t qa,
                                         uint32_t kb, uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < Descs<HD>::kSteps; ++kk) {
    d.q[kk] = descriptor(qa + q_step(kk), 16, 1024);
    d.k[kk] = descriptor(kb + k_step(kk), 16, 1024);
    asm volatile("" : "+l"(d.q[kk]), "+l"(d.k[kk]));
  }
#pragma unroll
  for (int kk = 0; kk < kBn / 16; ++kk) {
    d.v[kk] = descriptor(vb + kk * 16 * 128, kBn * 128, 1024);
    asm volatile("" : "+l"(d.v[kk]));
  }
  d.overwrite = 0;
  d.accumulate = 1;
  asm volatile("" : "+r"(d.overwrite), "+r"(d.accumulate));
}

// S = Q K^T for this warpgroup's 64 rows and one kv tile: hd / 16 steps of
// wgmma m64n64k16, Q and K from shared memory; issued, not awaited.  The
// first step overwrites S.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[kBn / 2],
                                             const Descs<HD>& d) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(s, q_desc(d, kk), k_desc(d, kk),
             kk == 0 ? d.overwrite : d.accumulate);
}

// O += P V over one kv tile: kBn / 16 steps of wgmma m64n{hd}k16, P from
// registers, V from shared memory; issued, not awaited
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[kBn / 16][4],
                                         const Descs<HD>& d) {
#pragma unroll
  for (int kk = 0; kk < kBn / 16; ++kk) {
    if constexpr (HD == 256) wgmma_rs_n256(o, p[kk], d.v[kk], d.accumulate);
    else if constexpr (HD == 128)
      wgmma_rs_n128(o, p[kk], d.v[kk], d.accumulate);
    else wgmma_rs_n64(o, p[kk], d.v[kk], d.accumulate);
  }
}

// The online softmax of one tile of scores, in place: s[4 j + e] (row r0 +
// 8 (e >> 1), column k0 + 8 j + cq + (e & 1)) becomes exp2(s * log2(e) /
// sqrt(hd) - m_new), masked where the tile crosses the causal limit (from
// the warpgroup's first row w0; causal_limit) or Skv.  Updates the rows' m
// and l (l per thread, reduced at the end) and returns their rescale factors
// in a0, a1.
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBn / 2], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, int k0, int w0, int r0, int cq, int skv,
    bool causal, int prefix, float scale_log2) {
  const bool masked = k0 + kBn > skv ||
                      (causal && k0 + kBn - 1 > causal_limit(w0, prefix));
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (masked) {
        const int kpos = k0 + 8 * j + cq + (e & 1);
        const int qpos = r0 + 8 * (e >> 1);
        if (kpos >= skv || (causal && kpos > causal_limit(qpos, prefix)))
          x = kNegInf;
      }
      s[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {    // over the row's 4 threads
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  a0 = ex2(m0 - n0);
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(s[4 * j + e] - (e < 2 ? n0 : n1));
      s[4 * j + e] = pe;
      if (e < 2) sum0 += pe;
      else sum1 += pe;
    }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// P rounded to bf16: the S fragment of kv columns 16 kk .. 16 kk + 15 is
// the A fragment of the kk-th k16 step of P V
__device__ __forceinline__ void round_p(const float (&s)[kBn / 2],
                                        uint32_t (&p)[kBn / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBn / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// A work item: one 128-row q tile of one (batch, head), row qh of the
// [B * H] heads.  Items are numbered longest first (under the causal mask
// the last q tiles walk the most kv tiles; with a prefix every tile walks at
// least to the prefix's last tile, so the count still never falls from one
// q tile to the next, and tiles of equal count keep their order), and dealt
// to the blocks in
// rounds of gridDim.x, every other round in reverse, so that a block that
// drew a long item draws a short one next: the n-th item of block j.
__device__ __forceinline__ int item_of(int n) {
  return n * gridDim.x +
         ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

struct Item {
  int q0, qh, kvh, n_tiles;
};

__device__ __forceinline__ Item item_at(int w, int n_qt, int batch_heads,
                                        int heads, int group, int sq, int skv,
                                        bool causal, int prefix) {
  Item it;
  it.q0 = (n_qt - 1 - w / batch_heads) * kBm;
  it.qh = w % batch_heads;
  it.kvh = it.qh / heads * (heads / group) + it.qh % heads / group;
  it.n_tiles = (skv + kBn - 1) / kBn;
  if (causal)       // up to the tile of the last row's limit (diagonal, prefix)
    it.n_tiles = min(it.n_tiles,
                     causal_limit(min(it.q0 + kBm, sq) - 1, prefix) / kBn + 1);
  return it;
}

// HD: the build's head dim (64, 128 or 256); hd <= HD the inputs' (the copies pad
// the rest with zeros).  kTma: TMA copies, else ordinary loads.  Persistent:
// each block walks its items (item_of); the K/V ring and its barriers
// run on across items, and Q is reloaded as soon as both warpgroups are
// done with its products, so one item's last P V and stores overlap the
// next one's loads.
template <int HD, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out,
            float* __restrict__ lse, int batch, int heads, int group, int sq,
            int skv, int hd, bool causal, int prefix, float scale_log2) {
  using L = Smem<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kFullArrivals = kTma ? 1 : 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBars;
#define BAR(i) (bars + 8u * (uint32_t)(i))

  const int n_qt = (sq + kBm - 1) / kBm, batch_heads = batch * heads;
  const int n_items = n_qt * batch_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(BAR(kQFull), kFullArrivals);
    mbar_init(BAR(kQEmpty), kConsumers / 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(BAR(kKFull + s), kFullArrivals);
      mbar_init(BAR(kVFull + s), kFullArrivals);
      mbar_init(BAR(kEmpty + s), kConsumers / 32);
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
    int t = 0;                                  // tiles copied so far
    for (int n = 0, w = item_of(0); w < n_items; w = item_of(++n)) {
      const Item it = item_at(w, n_qt, batch_heads, heads, group, sq, skv,
                              causal, prefix);
      if (n > 0)           // both warpgroups are done with the last Q
        mbar_wait(BAR(kQEmpty), (n - 1) & 1);
      if constexpr (kTma) {
        mbar_expect_tx(BAR(kQFull), L::kQBytes);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          tma_load(base + c * kBm * 128, &tq, BAR(kQFull), c * 64, it.q0,
                   it.qh);
      } else {
        stage_rows<HD>(smem, q + (long long)it.qh * sq * hd, kBm, it.q0, sq,
                       hd, lane);
        mbar_arrive(BAR(kQFull));
      }
      for (int i = 0; i < it.n_tiles; ++i, ++t) {
        const int s = t % kStages;
        if (t >= kStages)  // both warpgroups are done with tile t - kStages
          mbar_wait(BAR(kEmpty + s), ((t / kStages) & 1) ^ 1);
        const uint32_t kdst = base + L::kK + s * L::kTileBytes;
        const uint32_t vdst = base + L::kV + s * L::kTileBytes;
        if constexpr (kTma) {
          mbar_expect_tx(BAR(kKFull + s), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            tma_load(kdst + c * kBn * 128, &tk, BAR(kKFull + s), c * 64,
                     i * kBn, it.kvh);
          mbar_expect_tx(BAR(kVFull + s), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            tma_load(vdst + c * kBn * 128, &tv, BAR(kVFull + s), c * 64,
                     i * kBn, it.kvh);
        } else {
          const long long head = (long long)it.kvh * skv * hd;
          stage_rows<HD>(smem + (kdst - base), k + head, kBn, i * kBn, skv,
                         hd, lane);
          mbar_arrive(BAR(kKFull + s));
          stage_rows<HD>(smem + (vdst - base), v + head, kBn, i * kBn, skv,
                         hd, lane);
          mbar_arrive(BAR(kVFull + s));
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
               ::"n"(kConsumerRegs<kTma>));
  // 0 or 1, warp-uniform to the compiler, so that addresses stay uniform
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int cq = 2 * (lane & 3);      // its column in each 8-column group
  const int rw = 64 * wgi + 16 * (warp & 3) + (lane >> 2);  // row in the tile
  const uint32_t qa = base + wgi * 64 * 128;     // its 64 rows of Q

  auto kfull = [&](int t) {
    mbar_wait(BAR(kKFull + t % kStages), (t / kStages) & 1);
  };
  auto vfull = [&](int t) {
    mbar_wait(BAR(kVFull + t % kStages), (t / kStages) & 1);
  };
  auto release = [&](uint32_t bar) {   // this warp is done with a buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto k_at = [&](int t) {
    return base + L::kK + (t % kStages) * L::kTileBytes;
  };
  auto v_at = [&](int t) {
    return base + L::kV + (t % kStages) * L::kTileBytes;
  };

  int t = 0;                                     // ring position of tile 0
  for (int n = 0, w = item_of(0); w < n_items; w = item_of(++n)) {
    const Item it = item_at(w, n_qt, batch_heads, heads, group, sq, skv,
                            causal, prefix);
    const int w0 = it.q0 + 64 * wgi;             // its first q row
    const int last = min(w0 + 63, sq - 1);       // < w0: no rows at all
    const int r0 = it.q0 + rw;                   // its rows r0 and r0 + 8
    // the tiles it computes, the first of the item's: under the causal mask
    // the first warpgroup may skip the last one, wholly above its rows
    int n_mine = 0;
    if (w0 <= last)
      n_mine = causal ? min(it.n_tiles, causal_limit(last, prefix) / kBn + 1)
                      : it.n_tiles;

    float o[HD / 2], s[kBn / 2], m0 = kNegInf, m1 = kNegInf, l0 = 0.0f,
        l1 = 0.0f, a0, a1;
    uint32_t p[kBn / 16][4];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.0f;

    Descs<HD> desc;
    mbar_wait(BAR(kQFull), n & 1);
    if (n_mine > 0) {
      kfull(t);
      describe(desc, qa, k_at(t), v_at(t));
      zero(s);
      pin(s);
      wgmma_fence();
      issue_scores<HD>(s, desc);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      softmax_tile(s, m0, m1, l0, l1, a0, a1, 0, w0, r0, cq, skv, causal,
                   prefix, scale_log2);
      round_p(s, p);
      // Tile i's scores run on the tensor cores while tile i - 1's P V
      // does too; the softmax of tile i then overlaps that P V.
      for (int i = 1; i < n_mine; ++i) {
        kfull(t + i);
        vfull(t + i - 1);
        describe(desc, qa, k_at(t + i), v_at(t + i - 1));
        zero(s);
        pin(s);
        wgmma_fence();
        issue_scores<HD>(s, desc);
        wgmma_commit();
        pin(o);
        pin(p);
        wgmma_fence();
        issue_pv<HD>(o, p, desc);
        wgmma_commit();
        wgmma_wait<1>();                 // the scores are done
        pin(s);
        softmax_tile(s, m0, m1, l0, l1, a0, a1, i * kBn, w0, r0, cq, skv,
                     causal, prefix, scale_log2);
        wgmma_wait<0>();                 // and P V
        pin(o);
        pin(p);
        release(BAR(kEmpty + (t + i - 1) % kStages));
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        round_p(s, p);
      }
    }
    release(BAR(kQEmpty));             // its products with Q are done
    if (n_mine > 0) {
      vfull(t + n_mine - 1);
      describe(desc, qa, k_at(t), v_at(t + n_mine - 1));
      pin(o);
      pin(p);
      wgmma_fence();
      issue_pv<HD>(o, p, desc);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      pin(p);
      release(BAR(kEmpty + (t + n_mine - 1) % kStages));
    }
    for (int i = n_mine; i < it.n_tiles; ++i) {  // tiles it does not compute
      kfull(t + i);
      vfull(t + i);
      release(BAR(kEmpty + (t + i) % kStages));
    }
    t += it.n_tiles;

    // l summed per thread over its columns: reduce over the row's 4 threads
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    if (lse != nullptr && (lane & 3) == 0) {   // (m + log2 l) ln 2 per row
      float* at = lse + (long long)it.qh * sq;
      if (r0 < sq) at[r0] = (m0 + log2f(l0)) * kLn2;
      if (r0 + 8 < sq) at[r0 + 8] = (m1 + log2f(l1)) * kLn2;
    }
    bf16* dst = out + (long long)it.qh * sq * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + cq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= sq || c >= hd) continue;
        const float d = half ? d1 : d0;
        const float x = o[4 * j + 2 * half] / d;
        const float y = o[4 * j + 2 * half + 1] / d;
        bf16* at = dst + (long long)row * hd + c;
        if constexpr (kTma) {  // hd a multiple of 8: c + 1 < hd, aligned
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(x, y);
        } else {
          at[0] = __float2bfloat16(x);
          if (c + 1 < hd) at[1] = __float2bfloat16(y);
        }
      }
    }
  }
#undef BAR
}

template <int HD, bool kTma>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int heads, int kv_heads, int sq, int skv, int hd,
           bool causal, int prefix, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  // the device's context current on this thread before
  // cuTensorMapEncodeTiled encodes the tensor maps (a backward's thread
  // may call this first; see flash_attention_bwd.cu)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[3] = {};
  if (kTma && !(encode(&maps[0], q, batch * heads, sq, hd, kBm) &&
                encode(&maps[1], k, batch * kv_heads, skv, hd, kBn) &&
                encode(&maps[2], v, batch * kv_heads, skv, hd, kBn)))
    return (int)cudaErrorInvalidValue;
  static bool ready[64] = {};       // one per build of the kernel
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_wgmma<HD, kTma>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != kLaunchRegs) return (int)cudaErrorInvalidKernelImage;
    err = cudaFuncSetAttribute(flash_wgmma<HD, kTma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  static int sms[64] = {};           // multiprocessors of each device
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  // one persistent block per SM, or one per item if there are fewer
  const long long items = (long long)((sq + kBm - 1) / kBm) * batch * heads;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(items < sms[dev] ? items : sms[dev]);
  flash_wgmma<HD, kTma><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, batch, heads, heads / kv_heads, sq, skv,
      hd, causal, prefix, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_tma(bool tma, const void* q, const void* k, const void* v,
                 void* out, float* lse, int batch, int heads, int kv_heads,
                 int sq, int skv, int hd, bool causal, int prefix,
                 float scale, cudaStream_t stream) {
  return tma ? launch<HD, true>(q, k, v, out, lse, batch, heads, kv_heads, sq,
                                skv, hd, causal, prefix, scale, stream)
             : launch<HD, false>(q, k, v, out, lse, batch, heads, kv_heads,
                                 sq, skv, hd, causal, prefix, scale, stream);
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int batch, int heads, int kv_heads, int sq, int skv,
             int hd, bool causal, int prefix, float scale,
             cudaStream_t stream) {
  const bool tma = hd % 8 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (hd <= 64)
    return dispatch_tma<64>(tma, q, k, v, out, lse, batch, heads, kv_heads,
                            sq, skv, hd, causal, prefix, scale, stream);
  if (hd <= 128)
    return dispatch_tma<128>(tma, q, k, v, out, lse, batch, heads, kv_heads,
                             sq, skv, hd, causal, prefix, scale, stream);
  return dispatch_tma<256>(tma, q, k, v, out, lse, batch, heads, kv_heads,
                           sq, skv, hd, causal, prefix, scale, stream);
}

}  // namespace wg

}  // namespace

// q [batch, heads, sq, hd], k and v [batch, kv_heads, skv, hd] -> out [batch,
// heads, sq, hd]; all float32 (bf16 = 0, the SIMT kernel) or all bf16 (bf16 =
// 1, the tensor-core kernel), contiguous.  prefix: the prefix-LM boundary
// (0 <= prefix <= skv, only with causal; 0 is the plain causal mask).  lse:
// NULL, or (bf16 only) float32 [batch, heads, sq] that receives each row's
// natural-log logsumexp of its scaled, masked scores for the backward; the
// output is the same bits either way.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int batch, int heads,
                               int kv_heads, int sq, int skv, int hd,
                               int causal, int prefix, int bf16, float scale,
                               cudaStream_t stream) {
  if (batch == 0 || sq == 0) return 0;
  if (batch < 0 || batch > 65535 || heads < 1 || heads > 65535 ||
      kv_heads < 1 || heads % kv_heads != 0 || sq < 0 || skv < 1 || hd < 1 ||
      hd > 256 || prefix < 0 || prefix > skv || (prefix > 0 && !causal) ||
      (lse != nullptr && !bf16))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return wg::dispatch(q, k, v, out, static_cast<float*>(lse), batch, heads,
                        kv_heads, sq, skv, hd, causal != 0, prefix, scale,
                        stream);
  return dispatch<float>(q, k, v, out, batch, heads, kv_heads, sq, skv, hd,
                         causal != 0, prefix, scale, stream);
}
