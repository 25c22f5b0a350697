// Link-load segment sum for the Dragonfly phase pipeline, by hand for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/segment_sum/segment_sum.py::segment_sum_pallas (body
// _segment_sum_kernel): out[s] += sum of values[i] over the pairs i of segment
// s.  The TPU form is a blocked one-hot reduction whose sequential grid carries
// each output block across the pair sweep -- a workaround for the TPU's lack of
// a fast scatter.  Hopper has neither that problem nor a sequential grid, so the
// design starts over from what the phase pipeline hands over:
//
//   segment_sum_sorted   the plan-pinned pair list, sorted by link id once per
//                        plan, with its [n_segments + 1] offsets.  One warp per
//                        segment (grid-stride over segments) sums its range
//                        lane-strided, folds the lanes with a shuffle tree and
//                        writes once.  No atomics and a fixed order, so the
//                        result is bitwise reproducible from run to run.
//   segment_sum_scatter  unsorted ids: the NIC injection links, the per-phase
//                        background tail, planless phases.  One thread per
//                        pair loads the id and the value together and issues
//                        one fire-and-forget atomic add (red.global.add.f32);
//                        ids outside [0, n) are skipped (the tail padding
//                        relies on it).  Blocks are one warp, so a short call
//                        (a background tail of a few hundred pairs) spreads
//                        over as many SMs as it has warps.  The order of the
//                        atomics varies, so the sums vary in the last bits
//                        from run to run.
//
// Both ACCUMULATE into out, so the sorted head and the scattered tail of one
// link-load sum write the same buffer.
//
// Bound on an H100 SXM: memory.  A sorted call reads 4 bytes of value per pair
// and 4 bytes of offset per segment and reads and writes 4 bytes per segment; a
// scatter call reads 8 bytes per pair and reads and writes 4 bytes per link it
// touches.  At 3.35 TB/s a phase's ~3-4M pairs over 56,448 links come to a few
// microseconds, about the launch latency, so at this size launch latency and
// the L2's atomic units, not bandwidth, set the time: the scatter form's
// 120,000 NIC ids take 0.3 us of bytes, but their adds land on 4,608
// consecutive links, 144 cache lines, about 830 adds each, and on the card
// they take as long whatever the shape of the grid or the loads (PERF.md,
// section 6).  The floating-point work (one add per pair) is negligible.
//
// Plain C interface for ctypes: every entry point enqueues on the given stream,
// does not synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 65535;
constexpr int kScatterThreads = 32;   // scatter: one-warp blocks

__global__ void segment_sum_sorted_kernel(const float* __restrict__ values,
                                          const int* __restrict__ seg_off,
                                          int n_segments,
                                          float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  for (int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       s < n_segments; s += n_warps) {
    const int lo = seg_off[s];
    const int hi = seg_off[s + 1];
    float acc = 0.0f;
    for (int i = lo + lane; i < hi; i += 32) acc += values[i];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, d);
    if (lane == 0 && hi > lo) out[s] += acc;
  }
}

// out[s] += v without reading the result back.  No "memory" clobber: the
// kernel never reads out, so its loads may be issued ahead of its adds.
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v));
}

__global__ void __launch_bounds__(kScatterThreads)
segment_sum_scatter_kernel(const float* __restrict__ values,
                           const int* __restrict__ ids, long long n_pairs,
                           int n_segments, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_pairs; i += stride) {
    const int s = ids[i];
    const float v = values[i];
    if ((unsigned)s < (unsigned)n_segments) red_add(out + s, v);
  }
}

int blocks_for(long long work_items, int items_per_block) {
  const long long b = (work_items + items_per_block - 1) / items_per_block;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int segment_sum_sorted(const float* values, const int* seg_off,
                                  int n_segments, float* out,
                                  cudaStream_t stream) {
  if (n_segments > 0) {
    segment_sum_sorted_kernel<<<blocks_for(n_segments, kWarpsPerBlock),
                                kThreads, 0, stream>>>(values, seg_off,
                                                       n_segments, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_scatter(const float* values, const int* ids,
                                   long long n_pairs, int n_segments,
                                   float* out, cudaStream_t stream) {
  if (n_pairs > 0) {
    segment_sum_scatter_kernel<<<blocks_for(n_pairs, kScatterThreads),
                                 kScatterThreads, 0, stream>>>(
        values, ids, n_pairs, n_segments, out);
  }
  return (int)cudaGetLastError();
}
