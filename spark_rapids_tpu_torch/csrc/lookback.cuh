// Single-pass decoupled look-back scan (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016), shared by the
// scans over a row mask in compact.cu (compaction_order) and hashjoin.cu
// (probe_counts), and by build_layout's running max (hashjoin.cu).
//
// A tile is a run of consecutive rows, one block of kThreads threads,
// one or more 16-row chunks a thread.  Each block draws its tile id
// from a ticket counter, not from blockIdx.x, so every tile before it
// has already been taken by a running block: a tile waits only on tiles
// whose blocks run, and blocks scheduled out of order cannot deadlock.
// The last ticket a launch draws resets the counter, so the next launch
// on the stream finds it at zero without a fill.
//
// Each tile owns one 64-bit status word: the int32 value in the high
// half, and (epoch << 2 | flag) in the low half, flag 1 = the tile's
// own aggregate, 2 = its inclusive prefix.  The word is written and
// read as one aligned 64-bit access (st/ld.relaxed.gpu, single-copy
// atomic), so a flag is never seen without its value.  The word carries
// all a successor needs, so no acquire/release ordering against other
// data is required and the polls stay plain loads.  The wrapper raises
// the epoch every launch (ops/hopper StreamScratch), so words left by
// an earlier launch read as "not yet" and the status array is reused
// without a fill.  The values combine with an operator: Add (modulo
// 2^32, as an int32 cumulative sum does) or Max (of int32 values).
//
// The mask is read through a virtual row index v = row + mis, where
// mis = the mask pointer's offset from 16-byte alignment: thread chunk c
// covers virtual rows [16c, 16c + 16), which start at an aligned
// address, so a chunk wholly inside the mask is one 16-byte load and
// only the chunk holding the head and the one holding the tail load
// byte by byte.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

constexpr int kThreads = 256;
constexpr int kChunk = 16;                     // rows of one uint4 load
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;
constexpr unsigned kEpochs = 1u << 30;

// The scan's operators on a status word's 32-bit value, each with its
// identity.
struct Add {
  static constexpr unsigned kIdentity = 0u;
  __device__ __forceinline__ unsigned operator()(unsigned a,
                                                 unsigned b) const {
    return a + b;
  }
};

struct Max {                      // of the values read as int32
  static constexpr unsigned kIdentity = 0x80000000u;
  __device__ __forceinline__ unsigned operator()(unsigned a,
                                                 unsigned b) const {
    return static_cast<int>(a) > static_cast<int>(b) ? a : b;
  }
};

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long pack(unsigned value,
                                                   unsigned flag,
                                                   unsigned epoch) {
  return (static_cast<unsigned long long>(value) << 32) | (epoch << 2) |
         flag;
}

// Thread 0 of a block: its tile id.  A launch draws `draws` tickets in
// all; the last of them resets the counter, every other having been
// drawn.
__device__ __forceinline__ int draw_tile(int* counter, int draws) {
  const int t = atomicAdd(counter, 1);
  if (t == draws - 1) atomicExch(counter, 0);
  return t;
}

// Bits 0-3: whether each byte of a 4-byte word of bools is set.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// Bit k: whether row 16 * chunk - mis + k of the `cap`-row mask `p` is
// set (rows outside [0, cap) read as unset).
__device__ __forceinline__ unsigned load_flags16(const bool* __restrict__ p,
                                                 long long cap, int mis,
                                                 long long chunk) {
  const long long r0 = chunk * kChunk - mis;
  if (r0 >= 0 && r0 + kChunk <= cap) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p + r0));
    return nibble(w.x) | nibble(w.y) << 4 | nibble(w.z) << 8 |
           nibble(w.w) << 12;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const long long r = r0 + k;
    if (r >= 0 && r < cap && p[r]) bits |= 1u << k;
  }
  return bits;
}

// Exclusive prefix of a value below 2^kBits over the lanes of a warp,
// and the warp's total, from one ballot a bit of the value (no shuffle
// scan).
template <int kBits>
__device__ __forceinline__ unsigned warp_ballot_scan(unsigned n,
                                                     unsigned* total) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1;
  unsigned excl = 0;
  unsigned tot = 0;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const unsigned m = __ballot_sync(kFull, (n >> b) & 1u);
    excl += static_cast<unsigned>(__popc(m & lt)) << b;
    tot += static_cast<unsigned>(__popc(m)) << b;
  }
  *total = tot;
  return excl;
}

// Publishes the tile's aggregate (thread 0; tile 0 publishes its
// inclusive prefix at once).
__device__ __forceinline__ void publish_aggregate(
    unsigned long long* __restrict__ status, int tile, unsigned agg,
    unsigned epoch) {
  if (threadIdx.x == 0)
    store_word(&status[tile],
               pack(agg, tile == 0 ? kInclusive : kAggregate, epoch));
}

// All kThreads threads of a block, after publish_aggregate: the tile's
// exclusive prefix under `Op` (its identity for tile 0), published as
// its inclusive prefix (op(excl, agg)) and returned to every thread.
// One round reads kThreads predecessors (thread i the one at distance
// i + 1) back to the nearest inclusive prefix; while one nearer than it
// has not published, thread 0 alone polls that one, with a growing
// pause, and the round is read again.
// So a wave of tiles that publish together resolves in a few rounds,
// and waiting blocks load the L2 with one word a poll, not a window
// (a warp-wide window of 32 a round, all lanes polling, measured
// slower: the chain of rounds grows with the tiles in flight, and the
// polls contend with the other blocks' loads).  `s_red` is 2 * kWarps
// words of shared scratch.
template <typename Op = Add>
__device__ __forceinline__ unsigned block_exclusive_prefix(
    unsigned long long* __restrict__ status, int tile, unsigned agg,
    unsigned epoch, unsigned* s_red) {
  const Op op{};
  if (tile == 0) return Op::kIdentity;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned excl = Op::kIdentity;
  unsigned pause = 32;
  for (int base = tile - 1;;) {
    const int pred = base - tid;
    unsigned flag = kInclusive;     // before tile 0: an inclusive identity
    unsigned value = Op::kIdentity;
    if (pred >= 0) {
      const unsigned long long w = load_word(&status[pred]);
      const unsigned low = static_cast<unsigned>(w);
      flag = (low >> 2) == epoch ? (low & 3u) : 0u;
      value = static_cast<unsigned>(w >> 32);
    }
    const unsigned incl = __ballot_sync(kFull, flag == kInclusive);
    const unsigned none = __ballot_sync(kFull, flag == 0);
    if (lane == 0) {
      s_red[warp] = incl != 0 ? warp * 32 + __ffs(incl) - 1 : kThreads;
      s_red[kWarps + warp] =
          none != 0 ? warp * 32 + __ffs(none) - 1 : kThreads;
    }
    __syncthreads();
    int stop = kThreads;            // distance - 1 of the nearest inclusive
    int wait = kThreads;            // and of the nearest unpublished
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      stop = min(stop, static_cast<int>(s_red[w]));
      wait = min(wait, static_cast<int>(s_red[kWarps + w]));
    }
    __syncthreads();
    if (wait < stop) {
      if (tid == 0) {
        const unsigned long long* p = &status[base - wait];
        while ((static_cast<unsigned>(load_word(p)) >> 2) != epoch) {
          __nanosleep(pause);
          pause = min(2 * pause, 1024u);
        }
      }
      __syncthreads();
      continue;                     // read the round again
    }
    unsigned v = tid <= stop ? value : Op::kIdentity;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = op(v, __shfl_xor_sync(kFull, v, d));
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) excl = op(excl, s_red[w]);
    __syncthreads();
    if (stop < kThreads) break;
    base -= kThreads;
  }
  if (tid == 0)
    store_word(&status[tile], pack(op(excl, agg), kInclusive, epoch));
  return excl;
}

inline int tiles_for(long long cap, int mis, int tile_rows) {
  return static_cast<int>((cap + mis + tile_rows - 1) / tile_rows);
}

}  // namespace lookback
