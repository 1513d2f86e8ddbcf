// Selection compaction order for Hopper (sm_90a).
//
// Replaces the TPU kernel of spark_rapids_tpu/ops/pallas/compact.py:
//   compaction_order <- _order_trace (compact.py:53, pallas_call at :79)
//
// What it computes: for a keep mask over `cap` rows, the int32 order
// that brings the kept rows to the front stably, and the kept count.
// Slot j < count holds the j-th kept row; every slot j >= count holds j
// itself (identity tail), exactly the reference's contract.
//
// The TPU kernel takes the inclusive prefix sum of `keep` outside the
// kernel and binary-searches it once per output slot (log2(cap) rounds
// of gathers).  Here the scan is the kernel: a grid-wide exclusive scan
// of `keep` in three passes (tile_scan.cuh) -- per-tile counts, one
// block scanning the tile counts into carries (which also yields the
// count), and a pass that rescans each tile's rows, scatters each kept
// row i to order[carry + rank] and writes the identity tail.  No search.
//
// What bounds it on this card: it reads the mask twice (1 byte a row
// each time), writes 4 bytes a row, and the tile counts are tiny, so
// the floor is bandwidth, cap * (1 + 4) bytes at 3.35 TB/s (HBM3).
// What the design does about it: every pass streams its rows once with
// neighbouring threads on neighbouring rows; kept rows scatter to
// increasing addresses, so the writes stay nearly coalesced.  The
// second read of the mask is the price of the simple three-pass scan;
// a single-pass decoupled look-back would drop it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_scan.cuh"

namespace {

using tile_scan::kItems;
using tile_scan::kThreads;
using tile_scan::kTileRows;

__global__ void tile_count_kernel(const bool* __restrict__ keep,
                                  long long cap, int* __restrict__ tiles) {
  const long long base = static_cast<long long>(blockIdx.x) * kTileRows +
                         static_cast<long long>(threadIdx.x) * kItems;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < cap && keep[i]) ++n;
  }
  int total;
  tile_scan::block_exclusive_scan<kThreads>(n, 0, tile_scan::Add(), &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

__global__ void scatter_kernel(const bool* __restrict__ keep, long long cap,
                               const int* __restrict__ carries,
                               const int* __restrict__ count,
                               int* __restrict__ order) {
  const long long base = static_cast<long long>(blockIdx.x) * kTileRows +
                         static_cast<long long>(threadIdx.x) * kItems;
  bool k_[kItems];
  int n = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    k_[k] = i < cap && keep[i];
    n += k_[k];
  }
  int total;
  int rank = tile_scan::block_exclusive_scan<kThreads>(n, 0, tile_scan::Add(),
                                                       &total) +
             carries[blockIdx.x];
  const int kept = *count;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i >= cap) break;
    if (k_[k]) order[rank++] = static_cast<int>(i);
    if (i >= kept) order[i] = static_cast<int>(i);
  }
}

}  // namespace

// Launches on the caller's stream (PyTorch's current stream), allocates
// nothing, does not synchronise, and returns cudaGetLastError() after
// its launches (0 = success).  `tiles` is int32 scratch of
// ceil(cap / 1024) entries; `order` int32[cap]; `count` one int32.
extern "C" int compact_order(const bool* keep, long long cap, int* tiles,
                             int* order, int* count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = tile_scan::tiles_for(cap);
  tile_count_kernel<<<ntiles, kThreads, 0, st>>>(keep, cap, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_scan::carry_kernel<<<1, 1024, 0, st>>>(tiles, ntiles, 0, 0,
                                              tile_scan::Add(), count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<<<ntiles, kThreads, 0, st>>>(keep, cap, tiles, count, order);
  return static_cast<int>(cudaGetLastError());
}
