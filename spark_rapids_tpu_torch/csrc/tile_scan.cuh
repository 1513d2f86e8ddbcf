// Block-wide scans shared by the tile-scan kernels (compact.cu,
// hashjoin.cu).  A "tile" is kTileRows consecutive rows handled by one
// block of kThreads threads, kItems rows per thread.  A grid-wide scan
// runs in three passes: a per-tile reduction, one block scanning the
// tile totals into per-tile carries, and a per-tile pass that scans
// its own rows and adds the carry.
#pragma once

#include <cuda_runtime.h>

namespace tile_scan {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTileRows = kThreads * kItems;  // 1024 rows per block
constexpr int kWarps = kThreads / 32;

struct Add {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
};

struct Max {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

// Exclusive block scan of one int per thread (blockDim.x == kBlock,
// a multiple of 32 up to 1024).  `ident` is the identity of `op`;
// *total receives the combine of all kBlock values.  Every thread of
// the block must call it; it synchronises internally and may be called
// again right after.
template <int kBlock, typename Op>
__device__ __forceinline__ int block_exclusive_scan(int v, int ident, Op op,
                                                    int* total) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "block size");
  constexpr int kW = kBlock / 32;
  __shared__ int warp_tot[kW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(y, x);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kW ? warp_tot[lane] : ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op(y, w);
    }
    if (lane < kW) warp_tot[lane] = w;
  }
  __syncthreads();
  // exclusive prefix of this thread: the warps before it, then the
  // lanes before it inside its warp
  int excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) excl = ident;
  if (warp > 0) excl = op(warp_tot[warp - 1], excl);
  *total = warp_tot[kW - 1];
  __syncthreads();
  return excl;
}

// Pass 2 of a grid-wide scan: one block of 1024 threads turns the
// per-tile totals in `tiles` (in place) into exclusive per-tile carries
// seeded with `seed`, and writes the grand combine (seed included) to
// *grand when it is not null.
template <typename Op>
__global__ void carry_kernel(int* __restrict__ tiles, int ntiles, int seed,
                             int ident, Op op, int* __restrict__ grand) {
  __shared__ int running;
  if (threadIdx.x == 0) running = seed;
  __syncthreads();
  for (int base = 0; base < ntiles; base += 1024) {
    const int t = base + static_cast<int>(threadIdx.x);
    const int v = t < ntiles ? tiles[t] : ident;
    int total;
    const int excl = block_exclusive_scan<1024>(v, ident, op, &total);
    const int carry = running;
    if (t < ntiles) tiles[t] = op(carry, excl);
    __syncthreads();
    if (threadIdx.x == 0) running = op(carry, total);
    __syncthreads();
  }
  if (threadIdx.x == 0 && grand != nullptr) *grand = running;
}

inline int tiles_for(long long rows) {
  return static_cast<int>((rows + kTileRows - 1) / kTileRows);
}

}  // namespace tile_scan
