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
// key lane, span = S + cap slots with S = 2^nbits home slots and a
// cap-slot overflow tail, so runs never wrap.  A slot is 16 bytes: the
// key as int64 at byte 0, the build row as int32 at byte 8 (-1 =
// empty; an empty slot's key is 0) and zero at byte 12, so a walked
// slot is one aligned 16-byte load, one 32-byte sector, with no branch
// between its key and its row (the reference keeps two arrays, keys
// and rows; the wrapper reads them back as strided views).  The home
// slot of a key is the top nbits of the murmur3 fmix64 finalizer (a
// bijection on 64 bits: equal hashes mean equal keys, so a probe never
// verifies twice).
//
// build_layout: the caller sorts the build rows by (dead, hash) stably
// outside the kernel (PyTorch, as the reference does outside its
// kernel), giving per sorted row i its ideal slot (S for dead rows), its
// key and its build row id (-1 for dead rows).  Linear probing in hash
// order puts row i at final = clip(i + max(-2^31 + 1, max_{k <= i}(ideal_k
// - k)), 0, span - 1): increasing, equal to ideal when nothing pushed it,
// and contiguous behind a pushed run, so equal keys sit in consecutive
// slots in ascending build-row order.  Where clipping gives rows one
// slot (only for hand-built inputs), the last of them keeps it, as
// serial stores leave it.  Two launches write every slot exactly once:
//   1. layout_final_kernel: a single-pass decoupled look-back max-scan
//      (lookback.cuh, 4,096-row tiles staged in shared memory, 16 rows
//      a thread) of max(ideal - i, -2^31 + 1) gives each row its final,
//      stored as int32 scratch.  Each chunk of kChunkSlots slots that
//      some row lands in gets the first such row from that row's thread
//      (the row whose predecessor lands before the chunk), as a word
//      tagged with the launch's epoch after the look-back's status
//      words; a chunk no row lands in keeps a stale word.
//   2. layout_slots_kernel: one block a chunk.  A chunk with a current
//      word stages its slots as empty in shared memory, places the rows
//      from its first row while they land in it (at most kChunkSlots,
//      as finals increase; more only where clipping stacks them), and
//      writes the chunk out; a chunk without one writes empty slots.
//      Both in coalesced 16-byte stores.
// So the buffer needs no fill, and no slot is written twice.  The chunk
// words replace a search of `final` a block (22 dependent loads at 4M
// rows), and their writers do one store a chunk, so a long gap between
// two finals (a sparse build) costs no thread a loop.
//
// probe_first: a block takes a tile of 2,048 probe rows, loads their
// valid flags 16 a thread and compacts the valid rows into a shared
// list, so that every lane of a warp walks a valid row (q3's probe
// batch has 54 % valid rows).  A walk goes from the home slot until it
// finds its key (the build row), an empty slot or the last slot (span -
// 1; -1 for both).  A thread walks four rows in lock step, so four
// independent chains of loads are in flight.  The results land in
// shared memory at the row's own position and leave in coalesced
// 16-byte stores.  There is no prefix across tiles, so the grid is a
// plain grid of tiles.
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
// blocked_cumsum) comes out of the same launch: tiles as in
// probe_first, and the tile's sum of counts feeds a single-pass
// decoupled look-back scan (lookback.cuh) that gives the tile its
// offset.  A thread walks one row at a time: walking two or four at
// once, so that their misses overlap, measured slower (the walks are
// bound by the table's random sectors, not by their latency, and the
// wider walk costs registers).
//
// expand_pairs: a load-balanced expansion (merge path).  The live
// output slots 0..total-1 and the probe rows 0..pcap-1 merge into one
// order in which the end of row p precedes slot j iff cum[p] <= j; slot
// j then pairs with the least p with cum[p] > j, the reference's search
// result.  Each block owns 1,024 items of that order, whatever mix of
// slots and rows they are: it finds where its range starts and ends
// with a 32-way search of `cum` by one warp each (five rounds at four
// million rows), loads its rows' cum into shared memory, and every
// thread merges 8 items from its own split of the block's range.  A
// run of rows that own no pairs costs a block only its share of cum,
// and a row that owns more pairs than a block holds is split over
// blocks.  Slot j's build row is the row at table slot first[p] + j -
// (cum[p] - counts[p]) (clipped to the table), so the slots of one run
// read consecutive table slots; the outputs leave four slots a thread
// in 16-byte stores.  Blocks past the merge fill the dead slots
// [total, out_cap) with (0, 0, false) in coalesced 16-byte stores.
//
// What bounds them on this card: all four are bandwidth-bound.
// build_layout must read 16 bytes a build row (ideal, key, row id) and
// write 16 a slot (it also writes and reads back 4 bytes a row of
// `final`, which the L2 mostly holds); probe_first reads 1 byte a probe
// row and 8 more for a valid one, writes 5, and each valid row reads at
// least its home slot; probe_counts writes 12 bytes a probe row, and a
// valid row reads its run and one slot past it.  A walked slot is a
// random access that misses the 50 MB L2 for tables of millions of
// rows, and the card serves such 32-byte sectors far below its
// streaming rate: one sector a slot is what the interleaved layout
// buys.  expand_pairs writes 9
// bytes an output slot, reads cum once, first and counts at the rows
// that own pairs, and one table row a pair.  The design keeps the walks
// short (load factor at most 0.5), writes the table once in whole
// chunks, walks only valid probe rows, and gives the expansion no
// per-slot search.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kSeed = -2147483647;  // -2^31 + 1, the reference's carry seed

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}

__device__ __forceinline__ long long home_slot(long long key, int nbits) {
  return static_cast<long long>(
      mix64(static_cast<unsigned long long>(key)) >> (64 - nbits));
}

// A table slot as one 16-byte word: .x the key, the low half of .y the
// build row (-1 = empty), its high half zero.
__device__ __forceinline__ longlong2 load_slot(
    const longlong2* __restrict__ table, long long slot) {
  return __ldg(table + slot);
}

__device__ __forceinline__ int slot_row(longlong2 s) {
  return static_cast<int>(static_cast<unsigned>(s.y));
}

// build_layout's look-back tile (lookback.cuh: 256 threads, 16 rows
// each) and the slots a block of layout_slots_kernel owns.
constexpr int kFinalTileRows = lookback::kThreads * lookback::kChunk;
constexpr int kChunkSlots = 2048;
constexpr int kSlotThreads = 256;
constexpr int kSlotsPerThread = kChunkSlots / kSlotThreads;

__device__ __forceinline__ longlong2 empty_slot() {
  return make_longlong2(0, 0xffffffffLL);
}

// A row of a look-back tile in shared memory: 4 ints of padding after
// every 16, so that a thread's 16 rows (16-byte accesses, 4 rows each)
// meet no bank twice in a quarter warp, and a warp's 128 consecutive
// rows at most twice.
__device__ __forceinline__ int padded_row(int r) {
  return r + (r >> 4) * 4;
}

// max(ideal - i, seed) in 64 bits: it fits int32 after the seed.
__device__ __forceinline__ int rel_of(int ideal, long long i) {
  const long long d = static_cast<long long>(ideal) - i;
  return d > kSeed ? static_cast<int>(d) : kSeed;
}

// Launch 1 of build_layout: each row's final slot, and each occupied
// chunk's first row (the design note above).  The tile's ideal comes in
// and its finals go out through shared memory in coalesced 16-byte
// accesses, 128 rows a warp (16 bytes at a 64-byte stride a thread
// would write partial sectors); a thread scans its own 16 rows there.
// `vec`: ideal and final are 16-byte aligned.
__global__ void __launch_bounds__(lookback::kThreads) layout_final_kernel(
    const int* __restrict__ ideal, long long cap, long long span, bool vec,
    int ntiles, int* __restrict__ final_out,
    unsigned long long* __restrict__ status, int* __restrict__ counter,
    unsigned epoch, unsigned long long* __restrict__ chunk_first) {
  constexpr int kT = lookback::kThreads;
  constexpr int kC = lookback::kChunk;
  __shared__ __align__(16) int s_rows[kFinalTileRows + kFinalTileRows / 4];
  __shared__ int s_tile;
  __shared__ int s_warp[lookback::kWarps];
  __shared__ unsigned s_red[2 * lookback::kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = lookback::draw_tile(counter, ntiles);
  __syncthreads();
  const int tile = s_tile;
  const long long t0 = static_cast<long long>(tile) * kFinalTileRows;
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const int v = 4 * (tid + kT * q);
    const long long r = t0 + v;
    int4 x;
    if (vec && r + 4 <= cap) {
      x = __ldg(reinterpret_cast<const int4*>(ideal + r));
    } else {                        // the tail: rows past cap scan as seed
      x.x = r < cap ? ideal[r] : kSeed;
      x.y = r + 1 < cap ? ideal[r + 1] : kSeed;
      x.z = r + 2 < cap ? ideal[r + 2] : kSeed;
      x.w = r + 3 < cap ? ideal[r + 3] : kSeed;
    }
    *reinterpret_cast<int4*>(&s_rows[padded_row(v)]) = x;
  }
  __syncthreads();
  int4* const mine =
      reinterpret_cast<int4*>(&s_rows[padded_row(tid * kC)]);
  const long long r0 = t0 + tid * kC;
  int m = kSeed;
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const int4 x = mine[q];
    const long long i = r0 + 4 * q;
    m = max(m, max(max(rel_of(x.x, i), rel_of(x.y, i + 1)),
                   max(rel_of(x.z, i + 2), rel_of(x.w, i + 3))));
  }
  // the running max over the tile's threads
  int x = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(lookback::kFull, x, d);
    if (lane >= d) x = max(x, y);
  }
  if (lane == 31) s_warp[warp] = x;
  int prefix = __shfl_up_sync(lookback::kFull, x, 1);
  if (lane == 0) prefix = kSeed;
  __syncthreads();
  int agg = kSeed;
#pragma unroll
  for (int w = 0; w < lookback::kWarps; ++w) {
    const int v = s_warp[w];
    if (w < warp) prefix = max(prefix, v);
    agg = max(agg, v);
  }
  lookback::publish_aggregate(status, tile, static_cast<unsigned>(agg),
                              epoch);
  const int carry = static_cast<int>(
      lookback::block_exclusive_prefix<lookback::Max>(
          status, tile, static_cast<unsigned>(agg), epoch, s_red));
  prefix = max(prefix, carry);
  // prefix is now the max over every row before r0: row r0 - 1's final
  long long prev = r0 - 1 + prefix;
  prev = prev < 0 ? 0 : (prev > span - 1 ? span - 1 : prev);
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const int4 w = mine[q];
    int v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = r0 + 4 * q + e;
      prefix = max(prefix, rel_of(v[e], i));
      long long f = i + prefix;
      f = f < 0 ? 0 : (f > span - 1 ? span - 1 : f);
      if (i < cap && (i == 0 || f / kChunkSlots != prev / kChunkSlots))
        chunk_first[f / kChunkSlots] = lookback::pack(
            static_cast<unsigned>(i), lookback::kInclusive, epoch);
      v[e] = static_cast<int>(f);
      prev = f;
    }
    mine[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const int v = 4 * (tid + kT * q);
    const long long r = t0 + v;
    const int4 f = *reinterpret_cast<const int4*>(&s_rows[padded_row(v)]);
    if (vec && r + 4 <= cap) {
      *reinterpret_cast<int4*>(final_out + r) = f;
    } else {
      if (r < cap) final_out[r] = f.x;
      if (r + 1 < cap) final_out[r + 1] = f.y;
      if (r + 2 < cap) final_out[r + 2] = f.z;
      if (r + 3 < cap) final_out[r + 3] = f.w;
    }
  }
}

// Launch 2 of build_layout: block c writes slots [c * kChunkSlots,
// (c + 1) * kChunkSlots) of the span, each once (the design note
// above).
__global__ void __launch_bounds__(kSlotThreads) layout_slots_kernel(
    const int* __restrict__ final_in, const long long* __restrict__ lane,
    const int* __restrict__ rid, long long cap, long long span,
    const unsigned long long* __restrict__ chunk_first, unsigned epoch,
    longlong2* __restrict__ table) {
  __shared__ longlong2 s_slots[kChunkSlots];
  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunkSlots;
  const long long c1 = c0 + kChunkSlots;
  const unsigned long long word = chunk_first[blockIdx.x];
  if ((static_cast<unsigned>(word) >> 2) != epoch) {
    // no row lands here
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      const long long s = c0 + k * kSlotThreads + tid;
      if (s < span) table[s] = empty_slot();
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k)
    s_slots[k * kSlotThreads + tid] = empty_slot();
  __syncthreads();
  for (long long base = word >> 32;; base += kChunkSlots) {
    int fin[kSlotsPerThread];
    int next[kSlotsPerThread];
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      const long long i = base + k * kSlotThreads + tid;
      fin[k] = i < cap ? __ldg(final_in + i) : 0x7fffffff;
      next[k] = i + 1 < cap ? __ldg(final_in + i + 1) : 0x7fffffff;
    }
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      const long long i = base + k * kSlotThreads + tid;
      // rows from the chunk's first land in it while final < c1; of
      // rows that clipping stacks on one slot, the last keeps it
      if (i < cap && fin[k] < c1 && next[k] != fin[k])
        s_slots[fin[k] - c0] = make_longlong2(
            __ldg(lane + i),
            static_cast<long long>(static_cast<unsigned>(__ldg(rid + i))));
    }
    // more rows land here only where clipping stacked them
    const long long after = base + kChunkSlots;
    if (after >= cap || __ldg(final_in + after) >= c1) break;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const long long s = c0 + k * kSlotThreads + tid;
    if (s < span) table[s] = s_slots[k * kSlotThreads + tid];
  }
}

// probe_counts' tile: 256 threads, 16 rows each (lookback.cuh);
// probe_first's: 128 threads, 16 rows each (a tile is a block's work,
// and a smaller one shortens the grid's last wave).
constexpr int kProbeTileRows = lookback::kThreads * lookback::kChunk;
constexpr int kFirstThreads = 128;
constexpr int kFirstTileRows = kFirstThreads * lookback::kChunk;
// probe_first's walks a thread in lock step: four independent chains
// of loads in flight where one waited on each miss (one, two or eight
// measured slower at both q3's and semi's shapes)
constexpr int kFirstWalks = 4;

// Compacts a tile's valid rows into `s_walk` (their positions in the
// tile, in order) from each thread's 16 valid flags; returns how many.
// All kT threads call it; `s_warp` is kT / 32 words.  The caller
// synchronises before reading s_walk.
template <int kT>
__device__ __forceinline__ unsigned compact_valid(unsigned bits,
                                                  unsigned short* s_walk,
                                                  unsigned* s_warp) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  unsigned warp_total;
  const unsigned lane_excl =
      lookback::warp_ballot_scan<5>(__popc(bits), &warp_total);
  if ((tid & 31) == 0) s_warp[warp] = warp_total;
  __syncthreads();
  unsigned pos = 0;
  unsigned nvalid = 0;
#pragma unroll
  for (int w = 0; w < kT / 32; ++w) {
    const unsigned v = s_warp[w];
    pos += w < warp ? v : 0u;
    nvalid += v;
  }
  pos += lane_excl;
  for (unsigned b = bits; b != 0; b &= b - 1)
    s_walk[pos++] =
        static_cast<unsigned short>(tid * lookback::kChunk + __ffs(b) - 1);
  return nvalid;
}

// Coalesced out of a kT-thread tile of 16 * kT rows: each thread writes
// 4 consecutive rows a pass, a warp 128; `vec` when every address is
// 16-byte aligned.
template <int kT>
__device__ __forceinline__ void store_rows(int* __restrict__ out,
                                           const int* __restrict__ tile_vals,
                                           long long base, long long cap,
                                           bool vec) {
#pragma unroll
  for (int m = 0; m < lookback::kChunk / 4; ++m) {
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

// The unique-build probe over one 2,048-row tile (blockIdx.x; rows
// tile * 2048 - mis .. + 2047): every row starts unmatched in shared
// memory, the valid rows walk densely, four a thread in lock step, and
// the rows and found flags leave coalesced, rows four a thread a pass
// and flags 16 a thread.  A walk ends on its key (the build row), at an
// empty slot or at the last slot, span - 1 (-1 for both).
__global__ void __launch_bounds__(kFirstThreads) probe_first_kernel(
    const longlong2* __restrict__ table, long long span, int nbits,
    const long long* __restrict__ lane, const bool* __restrict__ valid,
    long long cap, int mis, int* __restrict__ row_out,
    bool* __restrict__ ok_out) {
  using lookback::kChunk;
  constexpr int kT = kFirstThreads;
  constexpr int kTile = kFirstTileRows;
  constexpr int kW = kFirstWalks;
  constexpr int kPending = -2;          // a walk still going
  __shared__ unsigned s_warp[kT / 32];
  __shared__ unsigned short s_walk[kTile];
  __shared__ __align__(16) int s_row[kTile];
  __shared__ __align__(16) unsigned char s_ok[kTile];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const unsigned bits =
      lookback::load_flags16(valid, cap, mis, tile * kT + tid);
#pragma unroll
  for (int m = 0; m < kChunk / 4; ++m)
    *reinterpret_cast<int4*>(&s_row[4 * (tid + kT * m)]) =
        make_int4(-1, -1, -1, -1);
  *reinterpret_cast<uint4*>(&s_ok[tid * kChunk]) = make_uint4(0, 0, 0, 0);
  const unsigned nvalid = compact_valid<kT>(bits, s_walk, s_warp);
  __syncthreads();
  // the dense walks: row v of the tile is real row base + v
  const long long base = tile * kTile - mis;
  for (unsigned j = tid; j < nvalid; j += kW * kT) {
    int v[kW];
    int r[kW];
    long long key[kW];
    long long slot[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const unsigned jw = j + w * kT;
      v[w] = jw < nvalid ? s_walk[jw] : -1;
      key[w] = v[w] >= 0 ? lane[base + v[w]] : 0;
      slot[w] = home_slot(key[w], nbits);
      r[w] = v[w] >= 0 ? kPending : -1;
    }
    for (bool pending = true; pending;) {
      pending = false;
      longlong2 sl[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w)
        if (r[w] == kPending) sl[w] = load_slot(table, slot[w]);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (r[w] != kPending) continue;
        const int row = slot_row(sl[w]);
        if (row < 0 || (slot[w] == span - 1 && sl[w].x != key[w])) {
          r[w] = -1;                    // an empty slot, or the walk's end
        } else if (sl[w].x == key[w]) {
          r[w] = row;
        } else {
          ++slot[w];
          pending = true;
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      if (v[w] < 0) continue;
      s_row[v[w]] = r[w];
      s_ok[v[w]] = r[w] >= 0;
    }
  }
  __syncthreads();
  const bool vec =
      mis == 0 && ((reinterpret_cast<uintptr_t>(row_out) |
                    reinterpret_cast<uintptr_t>(ok_out)) & 15) == 0;
  store_rows<kT>(row_out, s_row, base, cap, vec);
  const long long r0 = base + tid * kChunk;
  if (vec && r0 + kChunk <= cap) {
    *reinterpret_cast<uint4*>(ok_out + r0) =
        *reinterpret_cast<const uint4*>(&s_ok[tid * kChunk]);
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (r0 + k >= 0 && r0 + k < cap) ok_out[r0 + k] = s_ok[tid * kChunk + k];
  }
}

// One probe key's walk over its run (probe_counts): (first slot of the
// run, 0 without one; the run's length).  The walk ends at an empty
// slot, at the first slot after its run, or at the last slot (span -
// 1), where the reference re-reads the clamped slot for the steps it has
// left: each re-read of a hit counts again, and the steps left are
// span - 1 - (slot - home) = home.
__device__ __forceinline__ int2 count_run(const longlong2* __restrict__ table,
                                          long long span, int nbits,
                                          long long key) {
  const long long home = home_slot(key, nbits);
  int first = 0;
  int cnt = 0;
  for (long long slot = home;; ++slot) {
    const longlong2 s = load_slot(table, slot);
    if (slot_row(s) < 0) break;                 // an empty slot ends it
    const bool hit = s.x == key;
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
// in shared memory at the row's own position; the tile publishes its
// sum of counts, first and counts leave (they need no prefix), and only
// then does the block wait for its exclusive prefix and write cum.
// Every output leaves in coalesced 16-byte stores, a warp 128
// consecutive rows.
__global__ void __launch_bounds__(lookback::kThreads) probe_counts_kernel(
    const longlong2* __restrict__ table, long long span, int nbits,
    const long long* __restrict__ lane, const bool* __restrict__ valid,
    long long cap, int mis, int ntiles, int* __restrict__ first_out,
    int* __restrict__ count_out, int* __restrict__ cum_out,
    unsigned long long* __restrict__ status, int* __restrict__ counter,
    unsigned epoch) {
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
  const unsigned nvalid = compact_valid<kT>(bits, s_walk, s_warp);
  __syncthreads();
  // the dense walks: row v of the tile is real row base + v
  const long long base = static_cast<long long>(tile) * kTile - mis;
  for (unsigned j = tid; j < nvalid; j += kT) {
    const int v = s_walk[j];
    const int2 run = count_run(table, span, nbits, lane[base + v]);
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
  store_rows<kT>(first_out, s_first, base, cap, vec);
  store_rows<kT>(count_out, s_count, base, cap, vec);
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
  store_rows<kT>(cum_out, s_count, base, cap, vec);
}

// The expansion's blocks: 128 threads merging 8 items each (larger
// blocks measured slower: a block's phases wait on each other, so more
// and shorter blocks overlap better).
constexpr int kExpandThreads = 128;
constexpr int kMergeItems = 8;
constexpr int kBlockItems = kExpandThreads * kMergeItems;   // 1,024
constexpr int kFillSlots = 16;                // dead slots a fill thread
constexpr int kFillRows = kExpandThreads * kFillSlots;      // 2,048

// The merge path's split at diagonal d (one full warp, every lane gets
// the result): how many row ends come before the d-th item of the
// order that merges slots 0..total-1 with the ends of rows 0..pcap-1,
// where the end of row k precedes slot j iff cum[k] <= j.  Row k's end
// comes among the first d items iff cum[k] <= d - 1 - k, which holds
// for every k below the split and for none above it; a round tests 32
// evenly spaced k and keeps the gap where the answer changes.
__device__ __forceinline__ long long merge_split(const int* __restrict__ cum,
                                                 long long pcap,
                                                 long long total,
                                                 long long d) {
  const int ln = threadIdx.x & 31;
  long long lo = d - total > 0 ? d - total : 0;
  long long hi = d < pcap ? d : pcap;           // the split is in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long k = lo + ln * step;
    const bool before = k < hi && __ldg(cum + k) <= d - 1 - k;
    const int c = __popc(__ballot_sync(lookback::kFull, before));
    if (c == 0) break;                          // the split is lo
    const long long next = lo + c * step;       // the first k tested false
    lo += (c - 1) * step + 1;
    if (next < hi) hi = next;
  }
  return lo;
}

// Blocks [0, merge_blocks) expand the live slots, 1,024 items of the
// merged order each; the rest fill the dead slots [total, out_cap),
// 2,048 slots a block from the 16-slot group that holds `total`, in
// coalesced 16-byte stores (a thread's 16 flags, and four slots a pass
// of each lane).
__global__ void __launch_bounds__(kExpandThreads) expand_pairs_kernel(
    const int* __restrict__ trows, long long span,
    const int* __restrict__ first, const int* __restrict__ counts,
    const int* __restrict__ cum, long long pcap, long long total,
    long long out_cap, long long merge_blocks, bool vec,
    int* __restrict__ probe_out, int* __restrict__ build_out,
    bool* __restrict__ ok_out) {
  const int tid = threadIdx.x;
  if (blockIdx.x >= merge_blocks) {
    const long long b0 = (total & ~static_cast<long long>(kFillSlots - 1)) +
                         (blockIdx.x - merge_blocks) *
                             static_cast<long long>(kFillRows);
    if (vec && b0 >= total && b0 + kFillRows <= out_cap) {
      const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int m = 0; m < kFillSlots / 4; ++m) {
        const long long q = b0 + 4LL * (tid + kExpandThreads * m);
        *reinterpret_cast<int4*>(probe_out + q) = z;
        *reinterpret_cast<int4*>(build_out + q) = z;
      }
      *reinterpret_cast<uint4*>(ok_out + b0 + kFillSlots * tid) =
          make_uint4(0, 0, 0, 0);
    } else {
      for (int m = 0; m < kFillSlots; ++m) {
        const long long j = b0 + tid + kExpandThreads * m;
        if (j >= total && j < out_cap) {
          probe_out[j] = 0;
          build_out[j] = 0;
          ok_out[j] = false;
        }
      }
    }
    return;
  }
  // s_cum[x]: cum of row k0 + x (clamped to the last row), for the rows
  // whose ends fall in this block and the one after them; s_probe[j -
  // g0]: the local row that owns slot j
  __shared__ long long s_split[2];
  __shared__ int s_cum[kBlockItems + 1];
  __shared__ __align__(16) int s_probe[kBlockItems + 4];
  const long long items = total + pcap;
  const long long d0 = static_cast<long long>(blockIdx.x) * kBlockItems;
  const long long d1 = d0 + kBlockItems < items ? d0 + kBlockItems : items;
  const int warp = tid >> 5;
  if (warp < 2) {
    const long long k = merge_split(cum, pcap, total, warp == 0 ? d0 : d1);
    if ((tid & 31) == 0) s_split[warp] = k;
  }
  __syncthreads();
  const long long k0 = s_split[0];
  const int nk = static_cast<int>(s_split[1] - k0);
  const long long i0 = d0 - k0;                 // slots [i0, i1) are here
  const int ni = static_cast<int>(d1 - s_split[1] - i0);
  if (ni == 0) return;                          // only row ends
  {
    // every load in flight before the first store
    constexpr int kLoads = kBlockItems / kExpandThreads + 1;
    int c[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int x = tid + q * kExpandThreads;
      c[q] = x <= nk ? __ldg(cum + (k0 + x < pcap ? k0 + x : pcap - 1)) : 0;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int x = tid + q * kExpandThreads;
      if (x <= nk) s_cum[x] = c[q];
    }
  }
  __syncthreads();
  // this thread's split of the block's items, then its 8 items in order
  const long long g0 = i0 & ~3LL;
  const int dt = tid * kMergeItems;
  if (dt < nk + ni) {
    int lo = dt - ni > 0 ? dt - ni : 0;
    int hi = dt < nk ? dt : nk;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cum[mid] <= i0 + dt - 1 - mid) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int k = lo;
    long long j = i0 + dt - lo;
    const int end = dt + kMergeItems < nk + ni ? dt + kMergeItems : nk + ni;
    for (int it = dt; it < end; ++it) {
      if (k < nk && (j >= i0 + ni || s_cum[k] <= j)) {
        ++k;
      } else {
        s_probe[j - g0] = k;
        ++j;
      }
    }
  }
  __syncthreads();
  // the slots' build rows, four consecutive slots a thread
  const long long i1 = i0 + ni;
  for (long long g = g0 + 4LL * tid; g < i1; g += 4LL * kExpandThreads) {
    int p4[4];
    int b4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long j = g + e;
      p4[e] = 0;
      b4[e] = 0;
      if (j >= i0 && j < i1) {
        const int lk = s_probe[j - g0];
        const long long p = k0 + lk < pcap ? k0 + lk : pcap - 1;
        const long long start =
            static_cast<long long>(s_cum[lk]) - __ldg(counts + p);
        long long pos = __ldg(first + p) + (j - start);
        pos = pos < 0 ? 0 : (pos > span - 1 ? span - 1 : pos);
        const int r = __ldg(trows + 4 * pos);
        p4[e] = static_cast<int>(p);
        b4[e] = r > 0 ? r : 0;
      }
    }
    if (vec && g >= i0 && g + 4 <= i1) {
      *reinterpret_cast<int4*>(probe_out + g) =
          make_int4(p4[0], p4[1], p4[2], p4[3]);
      *reinterpret_cast<int4*>(build_out + g) =
          make_int4(b4[0], b4[1], b4[2], b4[3]);
      *reinterpret_cast<unsigned*>(ok_out + g) = 0x01010101u;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long j = g + e;
        if (j >= i0 && j < i1) {
          probe_out[j] = p4[e];
          build_out[j] = b4[e];
          ok_out[j] = true;
        }
      }
    }
  }
}

}  // namespace

// Each entry point launches on the caller's stream (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = success).  `table` is the
// slot buffer of span 16-byte slots (key int64, row int32, zero int32).

// ideal/rid int32[cap], lane int64[cap] in (dead, hash) order; final
// int32[cap] scratch; `table` the span slots to write, every one of
// them (no fill needed).  `ntiles` = ceil(cap / 4096) look-back tiles
// and `nchunks` = ceil(span / 2048) slot chunks; `status` holds at least
// ntiles + nchunks words (the chunk words follow the tiles'); `counter`
// and `epoch` as for the other look-back scans (lookback.cuh).  Two
// launches.
extern "C" int hashjoin_build_layout(const int* ideal, const long long* lane,
                                     const int* rid, long long cap,
                                     int* final_out, long long span,
                                     void* table, int ntiles, int nchunks,
                                     unsigned long long* status, int* counter,
                                     unsigned epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL || span < cap ||
      span > 0x80000000LL ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      ntiles != (cap + kFinalTileRows - 1) / kFinalTileRows ||
      nchunks != (span + kChunkSlots - 1) / kChunkSlots || epoch == 0 ||
      epoch >= lookback::kEpochs)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<uintptr_t>(ideal) |
                     reinterpret_cast<uintptr_t>(final_out)) & 15) == 0;
  unsigned long long* chunk_first = status + ntiles;
  layout_final_kernel<<<ntiles, lookback::kThreads, 0, st>>>(
      ideal, cap, span, vec, ntiles, final_out, status, counter, epoch,
      chunk_first);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  layout_slots_kernel<<<nchunks, kSlotThreads, 0, st>>>(
      final_out, lane, rid, cap, span, chunk_first, epoch,
      static_cast<longlong2*>(table));
  return static_cast<int>(cudaGetLastError());
}

// `table` from hashjoin_build_layout; lane int64[cap] and valid
// bool[cap] the probe rows; row_out int32[cap] (-1 = no match) and
// ok_out bool[cap]; `mis` = valid's address mod 16 and `ntiles` =
// ceil((cap + mis) / 2048) as the wrapper computed them.  One launch.
extern "C" int hashjoin_probe_first(const void* table, long long span,
                                    int nbits, const long long* lane,
                                    const bool* valid, long long cap, int mis,
                                    int ntiles, int* row_out, bool* ok_out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL || span <= 0 || nbits < 1 ||
      nbits > 62 || (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      mis != static_cast<int>(reinterpret_cast<uintptr_t>(valid) & 15) ||
      ntiles != lookback::tiles_for(cap, mis, kFirstTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  probe_first_kernel<<<ntiles, kFirstThreads, 0, st>>>(
      static_cast<const longlong2*>(table), span, nbits, lane, valid, cap,
      mis, row_out, ok_out);
  return static_cast<int>(cudaGetLastError());
}

// table/span/nbits as for hashjoin_probe_first; first_out, count_out
// and cum_out int32[cap] (first = 0 and count = 0 where nothing
// matches; cum the inclusive prefix sum of the counts, modulo 2^32);
// `mis` as for hashjoin_probe_first and `ntiles` = ceil((cap + mis) /
// 4096); `status`, `counter`
// and `epoch` the look-back scratch (lookback.cuh).  One launch.
extern "C" int hashjoin_probe_counts(const void* table, long long span,
                                     int nbits, const long long* lane,
                                     const bool* valid, long long cap,
                                     int mis, int ntiles, int* first_out,
                                     int* count_out, int* cum_out,
                                     unsigned long long* status, int* counter,
                                     unsigned epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap > 0x7fffffffLL || span <= 0 || nbits < 1 ||
      nbits > 62 || (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      mis != static_cast<int>(reinterpret_cast<uintptr_t>(valid) & 15) ||
      ntiles != lookback::tiles_for(cap, mis, kProbeTileRows) ||
      epoch == 0 || epoch >= lookback::kEpochs)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_counts_kernel<<<ntiles, lookback::kThreads, 0, st>>>(
      static_cast<const longlong2*>(table), span, nbits, lane, valid, cap,
      mis, ntiles, first_out, count_out, cum_out, status, counter, epoch);
  return static_cast<int>(cudaGetLastError());
}

// `table` from hashjoin_build_layout; first, counts and cum (the
// inclusive prefix sum of counts, nondecreasing) int32[pcap] from
// hashjoin_probe_counts; probe_out, build_out int32[out_cap] and ok_out
// bool[out_cap], live below `total`.  One launch.
extern "C" int hashjoin_expand_pairs(const void* table, long long span,
                                     const int* first, const int* counts,
                                     const int* cum, long long pcap,
                                     long long total, long long out_cap,
                                     int* probe_out, int* build_out,
                                     bool* ok_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pcap <= 0 || pcap > 0x7fffffffLL || span <= 0 || out_cap <= 0 ||
      out_cap > 0x7fffffffLL || total < 0 || total > out_cap ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long merge_blocks =
      total > 0 ? (total + pcap + kBlockItems - 1) / kBlockItems : 0;
  const long long dead_from = total & ~static_cast<long long>(kFillSlots - 1);
  const long long fill_blocks =
      total < out_cap ? (out_cap - dead_from + kFillRows - 1) / kFillRows : 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(probe_out) |
                     reinterpret_cast<uintptr_t>(build_out) |
                     reinterpret_cast<uintptr_t>(ok_out)) & 15) == 0;
  expand_pairs_kernel<<<static_cast<unsigned>(merge_blocks + fill_blocks),
                        kExpandThreads, 0, st>>>(
      static_cast<const int*>(table) + 2, span, first, counts, cum, pcap,
      total, out_cap, merge_blocks, vec, probe_out, build_out, ok_out);
  return static_cast<int>(cudaGetLastError());
}
