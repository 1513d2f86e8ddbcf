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
// of gathers).  Here the scan is the kernel, in one pass over the mask
// (lookback.cuh): a tile is 8,192 rows (so at most 512 tiles a 4M-row
// mask for the look-back to walk), each thread loads 32 with two 16-byte
// loads, a warp ranks its rows from six ballots of the lanes' kept
// counts (the mask is one bit a row, so no shuffle scan), the tile's
// rank offset comes from the decoupled look-back, and the tile's kept
// row ids are staged in shared memory and written out contiguously.
// The tile that draws the last id writes the count.
//
// The identity tail needs the count, which only the last tile knows, and
// a tile cannot write its own rows' tail slots: a later tile's kept rows
// may land there after it.  Two designs finish it: (a) one persistent
// cooperative grid with a grid-wide barrier before the tail, or (b) a
// second launch that reads the count on the device and writes only
// slots [count, cap).  This is (b).  Measured on an H100 (700 W) at a
// 4M-row mask with 5 % kept, the tail launch takes 0.0053 ms of the
// call's 0.0119: it writes its 16 MB at about 3 TB/s, near the card's
// rate, so (a) could save only the gap between the launches, and it
// would cap the grid at the resident blocks and make every block wait
// for the slowest at the barrier.
//
// What bounds it on this card: bytes.  It must read the mask (1 byte a
// row) and write the order (4 bytes a row) and the count, so the floor
// is cap * 5 bytes at 3.35 TB/s (HBM3).  The design reads the mask once
// and writes every order slot once, in 128-byte runs; the status words
// (8 bytes a 8,192-row tile) stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using lookback::kChunk;
using lookback::kThreads;
using lookback::kWarps;

constexpr int kChunks = 2;                               // 32 rows a thread
constexpr int kTileRows = kThreads * kChunk * kChunks;   // 8192 rows a tile

__global__ void __launch_bounds__(kThreads)
    compact_order_kernel(const bool* __restrict__ keep, long long cap,
                         int mis, int ntiles, int* __restrict__ order,
                         int* __restrict__ count,
                         unsigned long long* __restrict__ status,
                         int* __restrict__ counter, unsigned epoch) {
  __shared__ int s_tile;
  __shared__ unsigned s_warp[2 * kWarps];
  __shared__ int s_rows[kTileRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = lookback::draw_tile(counter, ntiles);
  __syncthreads();
  const int tile = s_tile;
  const long long chunk =
      (static_cast<long long>(tile) * kThreads + tid) * kChunks;
  unsigned bits = lookback::load_flags16(keep, cap, mis, chunk) |
                  lookback::load_flags16(keep, cap, mis, chunk + 1) << 16;
  unsigned warp_total;
  const unsigned lane_excl =
      lookback::warp_ballot_scan<6>(__popc(bits), &warp_total);
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();
  unsigned before = 0;
  unsigned agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned v = s_warp[w];
    before += w < warp ? v : 0u;
    agg += v;
  }
  lookback::publish_aggregate(status, tile, agg, epoch);
  // stage the tile's kept row ids in row order
  unsigned rank = before + lane_excl;
  const int row0 = static_cast<int>(chunk * kChunk - mis);
  while (bits != 0) {
    const int k = __ffs(bits) - 1;
    bits &= bits - 1;
    s_rows[rank++] = row0 + k;
  }
  __syncthreads();                 // s_warp read; s_rows staged
  const unsigned excl =
      lookback::block_exclusive_prefix(status, tile, agg, epoch, s_warp);
  for (unsigned j = tid; j < agg; j += kThreads) order[excl + j] = s_rows[j];
  if (tile == ntiles - 1 && tid == 0) *count = static_cast<int>(excl + agg);
}

// Slots [count, cap) get their own index: 4 slots a thread, one 16-byte
// store where the 4 lie inside the tail and `order` is aligned; at most
// kTailBlocks blocks (4 an SM of a 132-SM H100), striding past them.
constexpr long long kTailBlocks = 528;

__global__ void __launch_bounds__(kThreads)
    compact_tail_kernel(long long cap, const int* __restrict__ count,
                        int* __restrict__ order) {
  const long long kept = *count;
  const bool vec = (reinterpret_cast<uintptr_t>(order) & 15) == 0;
  const long long groups = (cap + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = (kept >> 2) + static_cast<long long>(blockIdx.x) *
                                       kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long s = g * 4;
    if (vec && s >= kept && s + 4 <= cap) {
      const int i = static_cast<int>(s);
      *reinterpret_cast<int4*>(order + s) = make_int4(i, i + 1, i + 2, i + 3);
    } else {
      for (long long j = s < kept ? kept : s; j < s + 4 && j < cap; ++j)
        order[j] = static_cast<int>(j);
    }
  }
}

}  // namespace

// Two launches on the caller's stream (PyTorch's current stream): the
// look-back scan and the identity tail.  Allocates nothing, does not
// synchronise, and returns the CUDA error of a refused call or launch
// (0 = success).  `keep` bool[cap]; `mis` = keep's address mod 16 and
// `ntiles` = ceil((cap + mis) / 8192), as the wrapper computed them;
// `order` int32[cap + 1], the count in its last entry; `status` at
// least `ntiles` look-back words and `counter` the look-back ticket
// (ops/hopper StreamScratch), `epoch` in [1, 2^30) new to `status`.
extern "C" int compact_order(const bool* keep, long long cap, int mis,
                             int ntiles, int* order,
                             unsigned long long* status, int* counter,
                             unsigned epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL ||
      mis != static_cast<int>(reinterpret_cast<uintptr_t>(keep) & 15) ||
      ntiles != lookback::tiles_for(cap, mis, kTileRows) || epoch == 0 ||
      epoch >= lookback::kEpochs)
    return static_cast<int>(cudaErrorInvalidValue);
  int* count = order + cap;
  compact_order_kernel<<<ntiles, kThreads, 0, st>>>(
      keep, cap, mis, ntiles, order, count, status, counter, epoch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = (cap + 3) / 4;
  long long grid = (groups + kThreads - 1) / kThreads;
  if (grid > kTailBlocks) grid = kTailBlocks;
  compact_tail_kernel<<<static_cast<int>(grid), kThreads, 0, st>>>(
      cap, count, order);
  return static_cast<int>(cudaGetLastError());
}
