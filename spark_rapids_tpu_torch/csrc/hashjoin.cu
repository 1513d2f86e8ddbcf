// Hash-table join kernels for Hopper (sm_90a): the table layout, the
// unique-build probe, and the counted probe and pair expansion of
// non-unique builds.
//
// Replaces the TPU kernels of spark_rapids_tpu/ops/pallas/hashjoin.py:
//   build_layout <- _build_trace        (hashjoin.py:111, pallas_call :147)
//   probe_first  <- _probe_first_trace  (hashjoin.py:182, pallas_call :214)
//   probe_counts <- _probe_counts_trace (hashjoin.py:253, pallas_call :289)
//   expand_pairs <- _expand_trace       (hashjoin.py:324, pallas_call :354)
//
// The table is open addressing in hash order over one canonical int64
// key lane: keys int64[span] and rows int32[span] (row -1 = empty),
// span = S + cap with S = 2^nbits home slots and a cap-slot overflow
// tail, so runs never wrap.  The home slot of a key is the top nbits of
// the murmur3 fmix64 finalizer (a bijection on 64 bits: equal hashes
// mean equal keys, so a probe never verifies twice).
//
// build_layout: the caller sorts the build rows by (dead, hash) stably
// outside the kernel (PyTorch, as the reference does outside its
// kernel), giving per sorted row i its ideal slot (S for dead rows), its
// key and its build row id (-1 for dead rows).  Linear probing in hash
// order puts row i at final = i + max(-2^31 + 1, max_{k <= i}(ideal_k -
// k)): strictly increasing, equal to ideal when nothing pushed it, and
// contiguous behind a pushed run, so equal keys sit in consecutive slots
// in ascending build-row order.  The running max is a grid-wide scan:
// per-tile maxima, one block turning them into per-tile carries, then a
// pass that rescans its tile, adds the carry and stores (key, row) at
// clip(final, 0, span - 1).  A block-local max alone would be wrong as
// soon as a run crosses a tile.
//
// probe_first: one thread per probe row walks from the home slot until
// it finds its key (writes the build row) or an empty slot (writes -1),
// for at most span steps.
//
// probe_counts: each probe row walks the same way but counts the run of
// equal keys: it stops at an empty slot or at the first slot after the
// run that holds another key, and writes the run's first slot (0
// without a match) and its length.  Equal keys are consecutive, so the
// run is the row's whole match set.  The reference clamps its walk at
// span - 1 and re-reads that slot until span steps are spent; the
// kernel reproduces that count in closed form (the layout never stores
// a live row there, so it only matters for tables built otherwise).
// The int32 inclusive prefix sum of the counts (`cum`, the reference's
// blocked_cumsum) comes out of the same launch: a tile of 4,096 probe
// rows compacts its valid rows so that every lane of a warp walks one
// (a join's probe batch is often mostly invalid: m2m's first batch has
// 14 % valid rows), and the tile's sum of counts feeds a single-pass
// decoupled look-back scan (lookback.cuh) that gives the tile its
// offset.  A thread walks one row at a time: walking two or four at
// once, so that their misses overlap, measured slower (the walks are
// bound by the table's random sectors, not by their latency, and the
// wider walk costs registers).  Each walked slot reads a 32-byte sector
// from each of two arrays, and the card serves random sectors far below
// its streaming rate; a table that keeps a key and its row in one
// 16-byte slot would halve them.
//
// expand_pairs: one thread per output slot j.  A live slot (j < total)
// finds its probe row p by the reference's fixed-round binary search of
// the inclusive prefix sum `cum` (the least p with cum[p] > j) and its
// build row at table slot first[p] + j - (cum[p] - counts[p]); a dead
// slot writes (0, 0, false) and searches nothing.
//
// What bounds them on this card: all four are bandwidth-bound.
// build_layout reads 16 bytes a build row (ideal, key, row id; ideal
// twice) and scatters 12; probe_first reads 9 bytes a probe row and
// writes 5, probe_counts reads 1 byte a probe row (8 more for a valid
// one) and writes 12, and each valid probe row reads at least one
// 12-byte table slot (probe_counts: its run and one slot past it), a
// random access that usually misses the 50 MB L2 for tables of
// millions of rows and costs a 32-byte sector in each of the two
// arrays.  expand_pairs writes 9 bytes an output slot and reads one
// 4-byte table row at random; its search reads `cum` log2(probe
// capacity) times, of which the first levels stay in L1/L2.  The
// design keeps the walks short (load factor at most 0.5), makes the
// layout writes land in increasing slots, gives dead output slots no
// work, and lets only valid probe rows load their key.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"
#include "tile_scan.cuh"

namespace {

using tile_scan::kItems;
using tile_scan::kThreads;
using tile_scan::kTileRows;

constexpr int kSeed = -2147483647;  // -2^31 + 1, the reference's carry seed

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}

__global__ void tile_max_kernel(const int* __restrict__ ideal, long long cap,
                                int* __restrict__ tiles) {
  const long long base = static_cast<long long>(blockIdx.x) * kTileRows +
                         static_cast<long long>(threadIdx.x) * kItems;
  int m = kSeed;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < cap) {
      const int rel = ideal[i] - static_cast<int>(i);
      m = rel > m ? rel : m;
    }
  }
  int total;
  tile_scan::block_exclusive_scan<kThreads>(m, kSeed, tile_scan::Max(),
                                            &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

__global__ void layout_kernel(const int* __restrict__ ideal,
                              const long long* __restrict__ lane,
                              const int* __restrict__ rid, long long cap,
                              const int* __restrict__ carries, long long span,
                              long long* __restrict__ keys,
                              int* __restrict__ rows) {
  const long long base = static_cast<long long>(blockIdx.x) * kTileRows +
                         static_cast<long long>(threadIdx.x) * kItems;
  int rel[kItems];
  int m = kSeed;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    rel[k] = i < cap ? ideal[i] - static_cast<int>(i) : kSeed;
    m = rel[k] > m ? rel[k] : m;
  }
  int total;
  int prefix = tile_scan::block_exclusive_scan<kThreads>(
      m, kSeed, tile_scan::Max(), &total);
  const int carry = carries[blockIdx.x];
  prefix = prefix > carry ? prefix : carry;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i >= cap) break;
    prefix = rel[k] > prefix ? rel[k] : prefix;
    long long slot = i + prefix;
    slot = slot < 0 ? 0 : (slot > span - 1 ? span - 1 : slot);
    keys[slot] = lane[i];
    rows[slot] = rid[i];
  }
}

__global__ void probe_first_kernel(const long long* __restrict__ tkeys,
                                   const int* __restrict__ trows,
                                   long long span, int nbits,
                                   const long long* __restrict__ lane,
                                   const bool* __restrict__ valid,
                                   long long cap, int* __restrict__ row_out,
                                   bool* __restrict__ ok_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += stride) {
    int out = -1;
    if (valid[i]) {
      const long long key = lane[i];
      long long slot = static_cast<long long>(
          mix64(static_cast<unsigned long long>(key)) >> (64 - nbits));
      for (long long step = 0; step < span; ++step) {
        const int r = trows[slot];
        if (r < 0) break;
        if (tkeys[slot] == key) {
          out = r;
          break;
        }
        if (slot == span - 1) break;  // the walk never wraps
        ++slot;
      }
    }
    row_out[i] = out;
    ok_out[i] = out >= 0;
  }
}

// One probe key's walk over its run (probe_counts): (first slot of the
// run, 0 without one; the run's length).  The row and key of a slot load
// together, with no branch between them, so a step is one round trip to
// memory, not two.  The walk ends at an empty slot, at the first slot
// after its run, or at the last slot (span - 1), where the reference
// re-reads the clamped slot for the steps it has left: each re-read of a
// hit counts again, and the steps left are span - 1 - (slot - home) =
// home.
__device__ __forceinline__ int2 count_run(const long long* __restrict__ tkeys,
                                          const int* __restrict__ trows,
                                          long long span, int nbits,
                                          long long key) {
  const long long home = static_cast<long long>(
      mix64(static_cast<unsigned long long>(key)) >> (64 - nbits));
  int first = 0;
  int cnt = 0;
  for (long long slot = home;; ++slot) {
    const int r = trows[slot];
    const long long k = tkeys[slot];
    if (r < 0) break;                           // an empty slot ends it
    const bool hit = k == key;
    if (hit) {
      if (cnt == 0) first = static_cast<int>(slot);
      ++cnt;
    } else if (cnt > 0) {
      break;                                    // the run has ended
    }
    if (slot == span - 1) {
      if (hit) cnt += static_cast<int>(home);
      break;
    }
  }
  return make_int2(first, cnt);
}

// The counted probe over one 4,096-row tile (lookback.cuh): the valid
// flags load 16 rows a thread; the valid rows compact into a shared
// list so every lane walks a valid row; the walks' (first, count) land
// in shared memory at the row's
// own position; the tile publishes its sum of counts, first and counts
// leave (they need no prefix), and only then does the block wait for
// its exclusive prefix and write cum.  Every output leaves in coalesced
// 16-byte stores, a warp 128 consecutive rows.
constexpr int kProbeTileRows = lookback::kThreads * lookback::kChunk;

// Coalesced out: each thread writes 4 consecutive rows a pass, a warp
// 128; `vec` when every address is 16-byte aligned.
__device__ __forceinline__ void store_rows(int* __restrict__ out,
                                           const int* __restrict__ tile_vals,
                                           long long base, long long cap,
                                           bool vec) {
  constexpr int kT = lookback::kThreads;
#pragma unroll
  for (int m = 0; m < kProbeTileRows / (4 * kT); ++m) {
    const int v = 4 * (threadIdx.x + kT * m);
    const int4 x = *reinterpret_cast<const int4*>(&tile_vals[v]);
    const long long r = base + v;
    if (vec && r + 4 <= cap) {
      *reinterpret_cast<int4*>(out + r) = x;
    } else {
      const int xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r + k >= 0 && r + k < cap) out[r + k] = xs[k];
    }
  }
}

__global__ void __launch_bounds__(lookback::kThreads) probe_counts_kernel(
    const long long* __restrict__ tkeys, const int* __restrict__ trows,
    long long span, int nbits, const long long* __restrict__ lane,
    const bool* __restrict__ valid, long long cap, int mis, int ntiles,
    int* __restrict__ first_out, int* __restrict__ count_out,
    int* __restrict__ cum_out, unsigned long long* __restrict__ status,
    int* __restrict__ counter, unsigned epoch) {
  using lookback::kChunk;
  constexpr int kT = lookback::kThreads;
  constexpr int kTile = kProbeTileRows;
  constexpr int kW = lookback::kWarps;
  __shared__ int s_tile;
  __shared__ unsigned s_warp[2 * kW];
  __shared__ unsigned short s_walk[kTile];
  __shared__ __align__(16) int s_first[kTile];
  __shared__ __align__(16) int s_count[kTile];   // counts, then cum
  const int tid = threadIdx.x;
  const int ln = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = lookback::draw_tile(counter, ntiles);
  __syncthreads();
  const int tile = s_tile;
  const long long chunk = static_cast<long long>(tile) * kT + tid;
  const unsigned bits = lookback::load_flags16(valid, cap, mis, chunk);
  unsigned warp_total;
  const unsigned lane_excl =
      lookback::warp_ballot_scan<5>(__popc(bits), &warp_total);
  if (ln == 0) s_warp[warp] = warp_total;
  __syncthreads();
  unsigned pos = 0;
  unsigned nvalid = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const unsigned v = s_warp[w];
    pos += w < warp ? v : 0u;
    nvalid += v;
  }
  pos += lane_excl;
  for (unsigned b = bits; b != 0; b &= b - 1)
    s_walk[pos++] = static_cast<unsigned short>(tid * kChunk + __ffs(b) - 1);
  __syncthreads();
  // the dense walks: row v of the tile is real row base + v
  const long long base = static_cast<long long>(tile) * kTile - mis;
  for (unsigned j = tid; j < nvalid; j += kT) {
    const int v = s_walk[j];
    const int2 run = count_run(tkeys, trows, span, nbits, lane[base + v]);
    s_first[v] = run.x;
    s_count[v] = run.y;
  }
  __syncthreads();
  // this thread's 16 rows: zero the invalid ones (never written), and
  // their counts' sum, then the tile's sum
  unsigned c[kChunk];
  unsigned own = 0;
#pragma unroll
  for (int k = 0; k < kChunk; k += 4) {
    int4* fp = reinterpret_cast<int4*>(&s_first[tid * kChunk + k]);
    int4* cp = reinterpret_cast<int4*>(&s_count[tid * kChunk + k]);
    int4 f4 = *fp;
    int4 c4 = *cp;
    const unsigned m = bits >> k;
    f4.x = m & 1u ? f4.x : 0, c4.x = m & 1u ? c4.x : 0;
    f4.y = m & 2u ? f4.y : 0, c4.y = m & 2u ? c4.y : 0;
    f4.z = m & 4u ? f4.z : 0, c4.z = m & 4u ? c4.z : 0;
    f4.w = m & 8u ? f4.w : 0, c4.w = m & 8u ? c4.w : 0;
    *fp = f4;
    *cp = c4;
    c[k] = c4.x, c[k + 1] = c4.y, c[k + 2] = c4.z, c[k + 3] = c4.w;
    own += c[k] + c[k + 1] + c[k + 2] + c[k + 3];
  }
  unsigned incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(lookback::kFull, incl, d);
    if (ln >= d) incl += y;
  }
  if (ln == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  unsigned agg = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const unsigned v = s_warp[w];
    before += w < warp ? v : 0u;
    agg += v;
  }
  lookback::publish_aggregate(status, tile, agg, epoch);
  const bool vec =
      mis == 0 &&
      ((reinterpret_cast<uintptr_t>(first_out) |
        reinterpret_cast<uintptr_t>(count_out) |
        reinterpret_cast<uintptr_t>(cum_out)) & 15) == 0;
  store_rows(first_out, s_first, base, cap, vec);
  store_rows(count_out, s_count, base, cap, vec);
  __syncthreads();                 // s_warp read; s_count out
  unsigned run = lookback::block_exclusive_prefix(status, tile, agg, epoch,
                                                  s_warp) +
                 before + incl - own;
  // each count turned into its cum, in place
#pragma unroll
  for (int k = 0; k < kChunk; k += 4) {
    int4 s4;
    s4.x = static_cast<int>(run += c[k]);
    s4.y = static_cast<int>(run += c[k + 1]);
    s4.z = static_cast<int>(run += c[k + 2]);
    s4.w = static_cast<int>(run += c[k + 3]);
    *reinterpret_cast<int4*>(&s_count[tid * kChunk + k]) = s4;
  }
  __syncthreads();
  store_rows(cum_out, s_count, base, cap, vec);
}

__global__ void expand_pairs_kernel(const int* __restrict__ trows,
                                    long long span,
                                    const int* __restrict__ first,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ cum, int pcap,
                                    int rounds, long long total,
                                    long long out_cap,
                                    int* __restrict__ probe_out,
                                    int* __restrict__ build_out,
                                    bool* __restrict__ ok_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < out_cap; j += stride) {
    int p = 0;
    int b = 0;
    const bool live = j < total;
    if (live) {
      const long long tgt = j + 1;
      int lo = 0;
      int hi = pcap;
      for (int r = 0; r < rounds; ++r) {
        int mid = (lo + hi) / 2;
        mid = mid < pcap - 1 ? mid : pcap - 1;
        if (cum[mid] < tgt) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      p = lo < pcap - 1 ? lo : pcap - 1;
      const long long start = static_cast<long long>(cum[p]) - counts[p];
      long long pos = first[p] + (j - start);
      pos = pos < 0 ? 0 : (pos > span - 1 ? span - 1 : pos);
      const int r = trows[pos];
      b = r > 0 ? r : 0;
    }
    probe_out[j] = p;
    build_out[j] = b;
    ok_out[j] = live;
  }
}

int grid_for(long long rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  long long want = (rows + kThreads - 1) / kThreads;
  const long long most = 16LL * sms;
  if (want < 1) want = 1;
  return static_cast<int>(want < most ? want : most);
}

}  // namespace

// Each entry point launches on the caller's stream (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = success).

// ideal/rid int32[cap], lane int64[cap] in (dead, hash) order; `tiles`
// int32 scratch of ceil(cap / 1024); keys int64[span] pre-filled with 0
// and rows int32[span] pre-filled with -1 by the caller.
extern "C" int hashjoin_build_layout(const int* ideal, const long long* lane,
                                     const int* rid, long long cap, int* tiles,
                                     long long span, long long* keys,
                                     int* rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL || span < cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = tile_scan::tiles_for(cap);
  tile_max_kernel<<<ntiles, kThreads, 0, st>>>(ideal, cap, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_scan::carry_kernel<<<1, 1024, 0, st>>>(tiles, ntiles, kSeed, kSeed,
                                              tile_scan::Max(), nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  layout_kernel<<<ntiles, kThreads, 0, st>>>(ideal, lane, rid, cap, tiles,
                                             span, keys, rows);
  return static_cast<int>(cudaGetLastError());
}

// keys int64[span] / rows int32[span] from hashjoin_build_layout; lane
// int64[cap] and valid bool[cap] the probe rows; row_out int32[cap]
// (-1 = no match) and ok_out bool[cap].
extern "C" int hashjoin_probe_first(const long long* keys, const int* rows,
                                    long long span, int nbits,
                                    const long long* lane, const bool* valid,
                                    long long cap, int* row_out, bool* ok_out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || span <= 0 || nbits < 1 || nbits > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_first_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      keys, rows, span, nbits, lane, valid, cap, row_out, ok_out);
  return static_cast<int>(cudaGetLastError());
}

// keys/rows/span/nbits as for hashjoin_probe_first; first_out,
// count_out and cum_out int32[cap] (first = 0 and count = 0 where
// nothing matches; cum the inclusive prefix sum of the counts, modulo
// 2^32); `mis` = valid's address mod 16 and `ntiles` = ceil((cap + mis)
// / 4096) as the wrapper computed them; `status`, `counter` and `epoch`
// the look-back scratch (lookback.cuh).  One launch.
extern "C" int hashjoin_probe_counts(const long long* keys, const int* rows,
                                     long long span, int nbits,
                                     const long long* lane, const bool* valid,
                                     long long cap, int mis, int ntiles,
                                     int* first_out, int* count_out,
                                     int* cum_out, unsigned long long* status,
                                     int* counter, unsigned epoch,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL || span <= 0 || nbits < 1 ||
      nbits > 62 ||
      mis != static_cast<int>(reinterpret_cast<uintptr_t>(valid) & 15) ||
      ntiles != lookback::tiles_for(cap, mis, kProbeTileRows) ||
      epoch == 0 || epoch >= lookback::kEpochs)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_counts_kernel<<<ntiles, lookback::kThreads, 0, st>>>(
      keys, rows, span, nbits, lane, valid, cap, mis, ntiles, first_out,
      count_out, cum_out, status, counter, epoch);
  return static_cast<int>(cudaGetLastError());
}

// rows int32[span] from hashjoin_build_layout; first, counts and cum
// (inclusive prefix sum of counts) int32[pcap] from hashjoin_probe_counts;
// `rounds` binary-search rounds (bit_length(pcap - 1) + 1); probe_out,
// build_out int32[out_cap] and ok_out bool[out_cap], live below `total`.
extern "C" int hashjoin_expand_pairs(const int* rows, long long span,
                                     const int* first, const int* counts,
                                     const int* cum, long long pcap,
                                     int rounds, long long total,
                                     long long out_cap, int* probe_out,
                                     int* build_out, bool* ok_out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pcap <= 0 || pcap > 0x7fffffffLL || span <= 0 || out_cap <= 0 ||
      out_cap > 0x7fffffffLL || total < 0 || total > out_cap || rounds < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  expand_pairs_kernel<<<grid_for(out_cap), kThreads, 0, st>>>(
      rows, span, first, counts, cum, static_cast<int>(pcap), rounds, total,
      out_cap, probe_out, build_out, ok_out);
  return static_cast<int>(cudaGetLastError());
}
