// Bounded-domain segmented aggregation kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of spark_rapids_tpu/ops/pallas/segagg.py:
//   seg_sums   <- _seg_matmul_sums (segagg.py:57, pallas_call at :95)
//   seg_reduce <- _seg_reduce      (segagg.py:123, pallas_call at :147)
//
// What they compute: every row r carries a bucket id seg[r] in [0, D]
// (D = the packed key domain, at most spark.rapids.tpu.sql.kernels.
// pallas.segagg.maxDomain; dead rows carry D and are skipped).
//   seg_sums   -> per bucket, the sum of Ki int64 lanes (exact mod 2^64,
//                 two's-complement wraparound like the reference) and of
//                 Kf float64 lanes; outputs int64[D, Ki] and f64[D, Kf].
//   seg_reduce -> per bucket, the min or max of one lane with an identity
//                 (bool/int8, int16, int32, int64, or float64 in Java
//                 Double.compare order: -0.0 < +0.0, NaN above +inf).
//
// The TPU version contracts a one-hot (D x block) matrix on the MXU and
// splits int64 into exact 32-bit halves in f64; that is an artefact of
// the TPU and is not carried over.
//
// What bounds them on this card: both read each input once and write a
// D-sized output, so the floor is bandwidth: seg_sums reads
// cap * 4 + live rows * 8 (Ki + Kf) bytes at 3.35 TB/s (HBM3), seg_reduce
// cap * 4 + live rows * lane width.
//
// The design.  Each warp walks its own 32-row chunks (kSumRows or
// kReduceRows of them a loop trip, neighbouring threads on neighbouring
// rows, each lane column's loads issued before the previous column adds),
// so every lane of a warp takes part in each warp-wide intrinsic; rows
// past `cap` and rows outside [0, D) carry the sentinel bucket -1, load
// no values and add nothing.
//   1. Accumulators.  Where D x lanes x warps fits kPrivateBudget, each
//      warp owns a slice of shared memory, so its rows contend only with
//      each other; the slices are folded once per block.  Otherwise one
//      block-shared copy, in up to kSmemMax of dynamic shared memory
//      (opted into per kernel and device), so D = 1024 with 20 lanes is
//      one launch, not four.  int64 adds go as two native 32-bit shared
//      atomics with the carry: sm_90a has no native 64-bit shared add
//      (it compiles to a CAS loop, as float64 adds and 64-bit min/max do).
//   2. Warp aggregation where rows collide.  seg_sums finds the threads
//      of a chunk that share a bucket (__match_any_sync).  When its
//      largest group holds kTreeMin rows or more, a segmented shuffle
//      tree over each group (schedule built once a chunk, reused for
//      every lane column; 64-bit values as two 32-bit shuffles) leaves
//      each group's total in its lowest thread, and only those leaders
//      add: one add per distinct bucket, not 32 on one address.  Below
//      kTreeMin each row adds on its own, which measured faster on this
//      card (a few rows an address cost less than the tree's shuffles).
//      seg_reduce adds each row on its own at every skew: one lane, so
//      the tree never paid for itself (PERF.md, Findings).  redux.sync
//      over the groups' masks serialises by group and measured slower
//      still.
//   3. Flush.  A grid of at most kBlocksPerSm blocks an SM writes one
//      partial row a block into a scratch [grid, cells] from PyTorch's
//      allocator.  The last block to finish (a __threadfence and a
//      ticket) folds the rows and writes every output cell, the identity
//      or zero included; where grid x cells is large, the blocks form
//      ceil(sqrt(grid)) groups whose last blocks fold their group's rows
//      first (against one fold by the last block, 11 % faster at q1's
//      shape and 1.9x at D = 1024; PERF.md).  Folds run in a fixed
//      order, and each folder resets its ticket for the next call.  So a
//      seg_sums tile and a seg_reduce call are one launch each: no zero
//      fill, no global atomics, no convert-back pass.
// Unsigned 64-bit adds wrap exactly in any order; f64 sums change order
// with the grid and the bucket's rows (the variableFloatAgg contract).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSumRows = 4;      // 32-row chunks a seg_sums warp loads a trip
constexpr int kReduceRows = 8;   // and a seg_reduce warp
// a seg_sums chunk whose largest bucket holds this many of its 32 rows
// is summed in the warp first; below it each row adds on its own (the
// fastest of 0, 6, 10, 16 and 33 across bucket skews; PERF.md)
constexpr int kTreeMin = 16;
constexpr int kMaxLanes = 64;    // lanes a launch: the pointer table
constexpr int kBlocksPerSm = 2;
constexpr size_t kPrivateBudget = 64 * 1024;   // warp-private slices up to this
constexpr size_t kSmemMax = 200 * 1024;        // one shared copy up to this
constexpr size_t kDefaultSmem = 48 * 1024;     // above it the opt-in is needed
constexpr long long kOneLevelCells = 16LL * kThreads;  // fold in one level
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct LaneTable {
  const void* p[kMaxLanes];
};

// SMs and shared memory of the current device, read once per device.
struct DevInfo {
  int sms;
  int smem_per_sm;
  int smem_reserved;
};

cudaError_t dev_info(DevInfo* out) {
  static DevInfo info[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DevInfo& d = info[dev];
  if (d.sms == 0) {
    DevInfo n;
    if ((e = cudaDeviceGetAttribute(&n.smem_per_sm,
                                    cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&n.smem_reserved,
                                    cudaDevAttrReservedSharedMemoryPerBlock,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    d = n;
  }
  *out = d;
  return cudaSuccess;
}

// Opts kKernel into kSmemMax of dynamic shared memory, once per device.
template <auto kKernel>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {false};
  int dev = 0;
  const cudaError_t g = cudaGetDevice(&dev);
  if (g != cudaSuccess) return g;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kKernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemMax));
  if (e == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return e;
}

// Blocks for `cap` rows: enough for one loop trip of every block, at most
// the blocks that stay resident (kBlocksPerSm an SM, fewer where their
// shared memory does not fit; __launch_bounds__ keeps the registers of
// kBlocksPerSm blocks within an SM's).
int grid_for(const DevInfo& d, size_t smem, long long cap,
             int rows_per_thread) {
  long long per_sm = d.smem_per_sm / static_cast<long long>(
                                         smem + d.smem_reserved);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long rows = static_cast<long long>(kThreads) * rows_per_thread;
  long long want = (cap + rows - 1) / rows;
  if (want < 1) want = 1;
  const long long most = per_sm * d.sms;
  return static_cast<int>(want < most ? want : most);
}

// Blocks a fold group: the whole grid where grid x cells is small, else
// ceil(sqrt(grid)), so two levels of folds share the work.
__host__ __device__ __forceinline__ int group_size(int grid, long long cells) {
  if (static_cast<long long>(grid) * cells <= kOneLevelCells) return grid;
  int g = 1;
  while (g * g < grid) ++g;
  return g;
}

// Fold groups of a launch.
__host__ __device__ __forceinline__ int fold_groups(int grid,
                                                    long long cells) {
  const int g = group_size(grid, cells);
  return (grid + g - 1) / g;
}

// Scratch cells a launch needs: a partial row per block and per group.
long long scratch_cells(int grid, long long cells) {
  return (static_cast<long long>(grid) + fold_groups(grid, cells)) * cells;
}

// Whether `n_tickets` covers a launch: the final ticket (tickets[0]) and
// one a fold group (tickets[1 + g]).
bool tickets_cover(int n_tickets, int grid, long long cells) {
  return fold_groups(grid, cells) + 1 <= n_tickets;
}

__host__ __device__ __forceinline__ long long f64_order(long long b) {
  const long long kExp = 0x7FF0000000000000LL;
  const long long kMant = 0x000FFFFFFFFFFFFFLL;
  if ((b & kExp) == kExp && (b & kMant) != 0) b = 0x7FF8000000000000LL;
  return b >= 0 ? b : (b ^ 0x7FFFFFFFFFFFFFFFLL);
}

__device__ __forceinline__ long long f64_from_order(long long o) {
  return o >= 0 ? o : (o ^ 0x7FFFFFFFFFFFFFFFLL);
}

// ---------------------------------------------------------------------------
// Warp aggregation
// ---------------------------------------------------------------------------

// The shuffle schedule of a segmented tree over the peer groups of one
// chunk, packed into two registers: at step k every thread adds the value
// of the next remaining peer above it (source lane in bits 5k..5k+4 of
// `src`, where bit k of `meta` is set); peers whose rank has bit k set are
// consumed at step k.  After `steps` steps (meta bits 8..10, the same in
// every thread) each leader (lowest thread of its group; meta bit 16)
// holds its group's total.
struct Sched {
  unsigned src;
  unsigned meta;
  __device__ __forceinline__ bool lead() const { return (meta >> 16) & 1u; }
};

__device__ __forceinline__ Sched make_sched(unsigned peers) {
  const unsigned lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  Sched s;
  s.src = 0;
  s.meta = (static_cast<unsigned>(__ffs(peers) - 1) == lane) ? 1u << 16 : 0u;
  unsigned steps = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (!__any_sync(kFull, above)) break;
    const int next = __ffs(above);
    if (next) {
      s.src |= static_cast<unsigned>(next - 1) << (5 * k);
      s.meta |= 1u << k;
    }
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
    steps = k + 1;
  }
  s.meta |= steps << 8;
  return s;
}

template <typename T, typename Op>
__device__ __forceinline__ T warp_fold(const Sched& s, T x, Op op) {
  const unsigned steps = (s.meta >> 8) & 7u;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < steps) {
      const T t = __shfl_sync(kFull, x, (s.src >> (5 * k)) & 31u);
      if ((s.meta >> k) & 1u) x = op(x, t);
    }
  }
  return x;
}

// An exact 64-bit add into a block-shared cell with two native 32-bit
// atomics (a 64-bit shared atomicAdd compiles to a CAS loop on sm_90a):
// the low word's carry goes into the high word's add.
__device__ __forceinline__ void shared_add(u64* cell, u64 x) {
  unsigned* w = reinterpret_cast<unsigned*>(cell);
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned old = atomicAdd(w, lo);
  const unsigned carry = old + lo < old ? 1u : 0u;
  const unsigned hi = static_cast<unsigned>(x >> 32) + carry;
  if (hi) atomicAdd(w + 1, hi);
}

// ---------------------------------------------------------------------------
// The flush: partial rows folded by group, then by the last group folder
// ---------------------------------------------------------------------------

// Folds rows [r0, r0 + n) of `src` (`cells` a row) cell by cell, in a
// fixed order, and hands each cell's result to emit(c, v).  Called by
// every thread of the block; `tmp` is shared memory of kThreads cells.
template <class Fold, class Emit>
__device__ void fold_rows(const u64* src, int r0, int n, int cells,
                          const Fold& f, const Emit& emit, u64* tmp) {
  if (cells <= kThreads) {
    int parts = kThreads / cells;
    if (parts > n) parts = n;
    const int c = threadIdx.x % cells;
    const int p = threadIdx.x / cells;
    if (p < parts) {
      u64 a = f.ident();
#pragma unroll 4
      for (int r = p; r < n; r += parts)
        a = f(c, a, __ldcg(src + static_cast<long long>(r0 + r) * cells + c));
      tmp[threadIdx.x] = a;
    }
    __syncthreads();
    if (threadIdx.x < cells) {
      u64 a = tmp[c];
      for (int q = 1; q < parts; ++q) a = f(c, a, tmp[q * cells + c]);
      emit(c, a);
    }
    __syncthreads();
  } else {
    for (int c = threadIdx.x; c < cells; c += kThreads) {
      u64 a = f.ident();
#pragma unroll 4
      for (int r = 0; r < n; ++r)
        a = f(c, a, __ldcg(src + static_cast<long long>(r0 + r) * cells + c));
      emit(c, a);
    }
  }
}

// Called by every thread after the block's partial row (scratch row
// blockIdx.x) is written.  Returns in every block; the last block of the
// grid has written the output through `out` when it does.
template <class Fold, class Emit>
__device__ void finish(u64* scratch, int* tickets, int cells, const Fold& f,
                       const Emit& out, u64* tmp) {
  __shared__ int last;
  const int grid = gridDim.x;
  const int gs = group_size(grid, cells);
  const int groups = fold_groups(grid, cells);
  const int g = blockIdx.x / gs;
  const int first = g * gs;
  const int n = grid - first < gs ? grid - first : gs;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[1 + g], 1) == n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  u64* grows = scratch + static_cast<long long>(grid) * cells;
  u64* mine = grows + static_cast<long long>(g) * cells;
  fold_rows(scratch, first, n, cells, f, [&](int c, u64 v) { mine[c] = v; },
            tmp);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    tickets[1 + g] = 0;
    last = atomicAdd(&tickets[0], 1) == groups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_rows(grows, 0, groups, cells, f, out, tmp);
  if (threadIdx.x == 0) tickets[0] = 0;
}

// ---------------------------------------------------------------------------
// seg_sums
// ---------------------------------------------------------------------------

// Cells [0, int_cells) hold int64 sums, the rest float64 sums (bits).
struct SumFold {
  int int_cells;
  __device__ u64 ident() const { return 0ULL; }
  __device__ u64 operator()(int c, u64 a, u64 b) const {
    if (c < int_cells) return a + b;
    return static_cast<u64>(__double_as_longlong(
        __longlong_as_double(static_cast<long long>(a)) +
        __longlong_as_double(static_cast<long long>(b))));
  }
};

struct AddU64 {
  __device__ u64 operator()(u64 a, u64 b) const { return a + b; }
};
struct AddF64 {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// `copies` is kWarps (a slice a warp) or 1 (one block-shared copy).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    seg_sums_kernel(const int* __restrict__ seg, long long cap, int domain,
                    int copies, LaneTable lanes, int n_int, int n_lanes,
                    long long* __restrict__ iout, int ki, int int_lo,
                    double* __restrict__ fout, int kf, int f64_lo,
                    u64* __restrict__ scratch, int* __restrict__ tickets) {
  extern __shared__ u64 smem[];
  const int cells = n_lanes * domain;
  const int int_cells = n_int * domain;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < copies * cells; i += kThreads) smem[i] = 0ULL;
  __syncthreads();
  u64* acc = smem + (copies > 1 ? warp * cells : 0);
  double* facc = reinterpret_cast<double*>(acc);

  const long long chunk = 32LL * kSumRows;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * chunk;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * kWarps + warp) * chunk;
       base < cap; base += stride) {
    int s[kSumRows];
    Sched sc[kSumRows];
    bool tree[kSumRows];   // the same in every thread of the warp
    bool take[kSumRows];   // this thread adds into the accumulator
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      const long long r = base + u * 32 + lane;
      const int b = r < cap ? seg[r] : -1;
      s[u] = static_cast<unsigned>(b) < static_cast<unsigned>(domain) ? b : -1;
      const unsigned peers = __match_any_sync(kFull, s[u]);
      tree[u] = __any_sync(kFull, s[u] >= 0 && __popc(peers) >= kTreeMin);
      if (tree[u]) sc[u] = make_sched(peers);
      take[u] = s[u] >= 0 && (!tree[u] || sc[u].lead());
    }
    // each lane column's live rows load before the previous column adds
    u64 v[kSumRows];
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      const long long r = base + u * 32 + lane;
      v[u] = n_int > 0 && s[u] >= 0 ? static_cast<const u64*>(lanes.p[0])[r]
                                    : 0;
    }
    for (int j = 0; j < n_int; ++j) {
      u64 next[kSumRows];
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) {
        const long long r = base + u * 32 + lane;
        next[u] = j + 1 < n_int && s[u] >= 0
                      ? static_cast<const u64*>(lanes.p[j + 1])[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) {
        const u64 x = tree[u] ? warp_fold(sc[u], v[u], AddU64()) : v[u];
        if (take[u]) shared_add(&acc[j * domain + s[u]], x);
        v[u] = next[u];
      }
    }
    for (int j = n_int; j < n_lanes; ++j) {
      const double* p = static_cast<const double*>(lanes.p[j]);
      double f[kSumRows];
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) {
        const long long r = base + u * 32 + lane;
        f[u] = s[u] >= 0 ? p[r] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kSumRows; ++u) {
        const double x = tree[u] ? warp_fold(sc[u], f[u], AddF64()) : f[u];
        if (take[u]) atomicAdd(&facc[j * domain + s[u]], x);
      }
    }
  }
  __syncthreads();

  const SumFold fold{int_cells};
  u64* row = scratch + static_cast<long long>(blockIdx.x) * cells;
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    u64 a = smem[c];
    for (int w = 1; w < copies; ++w) a = fold(c, a, smem[w * cells + c]);
    row[c] = a;
  }
  __syncthreads();  // smem becomes the fold's scratch
  finish(scratch, tickets, cells, fold,
         [&](int c, u64 v) {
           const int j = c / domain;
           const long long d = c - j * domain;
           if (j < n_int)
             iout[d * ki + int_lo + j] = static_cast<long long>(v);
           else
             fout[d * kf + f64_lo + (j - n_int)] =
                 __longlong_as_double(static_cast<long long>(v));
         },
         smem);
}

// Accumulator copies for `bytes` of cells: a slice a warp where kWarps
// of them fit kPrivateBudget, else one block-shared copy.
int copies_for(size_t bytes) {
  return kWarps * bytes <= kPrivateBudget ? kWarps : 1;
}

// Dynamic shared memory for `copies` x `bytes`: at least the fold's
// kThreads cells.
size_t smem_for(int copies, size_t bytes) {
  const size_t smem = copies * bytes;
  return smem < kThreads * sizeof(u64) ? kThreads * sizeof(u64) : smem;
}

// The lane tile that starts at lane `lo`: up to kMaxLanes lanes whose
// block-shared copy fits kSmemMax.
struct SumsTile {
  int hi;
  int copies;
  size_t smem;
  int grid;
};

SumsTile sums_tile(const DevInfo& dev, long long cap, int domain, int lo,
                   int total) {
  long long per = static_cast<long long>(kSmemMax / (sizeof(u64) * domain));
  if (per > kMaxLanes) per = kMaxLanes;
  SumsTile t;
  t.hi = lo + per < total ? lo + static_cast<int>(per) : total;
  const size_t bytes = static_cast<size_t>(t.hi - lo) * domain * sizeof(u64);
  t.copies = copies_for(bytes);
  t.smem = smem_for(t.copies, bytes);
  t.grid = grid_for(dev, t.smem, cap, kSumRows);
  return t;
}

// ---------------------------------------------------------------------------
// seg_reduce
// ---------------------------------------------------------------------------

// Partials hold the reduced value sign-extended to 64 bits (float64: its
// total-order image).
struct MinMaxFold {
  long long id;
  int is_min;
  __device__ u64 ident() const { return static_cast<u64>(id); }
  __device__ u64 operator()(int, u64 a, u64 b) const {
    const long long x = static_cast<long long>(a);
    const long long y = static_cast<long long>(b);
    return static_cast<u64>(is_min ? (y < x ? y : x) : (y > x ? y : x));
  }
};

template <typename T>
struct MinMaxOp {
  int is_min;
  __device__ T operator()(T a, T b) const {
    return is_min ? (b < a ? b : a) : (b > a ? b : a);
  }
};

// In is the lane's storage type (bool reads as int8), Acc the type it
// reduces in (int for lanes of 32 bits or fewer, else long long); kF64
// reads float64 bit patterns and reduces their total-order image.
template <typename In, typename Acc, bool kF64>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    seg_reduce_kernel(const int* __restrict__ seg, long long cap, int domain,
                      int copies, const In* __restrict__ lane_in,
                      long long ident,
                      int is_min, In* __restrict__ out,
                      u64* __restrict__ scratch, int* __restrict__ tickets) {
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Acc* all = reinterpret_cast<Acc*>(smem);
  const Acc id = static_cast<Acc>(ident);
  for (int i = threadIdx.x; i < copies * domain; i += kThreads) all[i] = id;
  __syncthreads();
  Acc* acc = all + (copies > 1 ? warp * domain : 0);
  const MinMaxOp<Acc> op{is_min};

  const long long chunk = 32LL * kReduceRows;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * chunk;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * kWarps + warp) * chunk;
       base < cap; base += stride) {
    int s[kReduceRows];
    Acc v[kReduceRows];
    // only live rows load their values
#pragma unroll
    for (int u = 0; u < kReduceRows; ++u) {
      const long long r = base + u * 32 + lane;
      const int b = r < cap ? seg[r] : -1;
      s[u] = static_cast<unsigned>(b) < static_cast<unsigned>(domain) ? b : -1;
    }
#pragma unroll
    for (int u = 0; u < kReduceRows; ++u)
      v[u] = s[u] >= 0 ? static_cast<Acc>(lane_in[base + u * 32 + lane]) : id;
#pragma unroll
    for (int u = 0; u < kReduceRows; ++u) {
      Acc x = v[u];
      if constexpr (kF64) x = f64_order(x);
      if (s[u] >= 0) {
        Acc* cell = &acc[s[u]];
        if (is_min)
          atomicMin(cell, x);
        else
          atomicMax(cell, x);
      }
    }
  }
  __syncthreads();

  const MinMaxFold fold{ident, is_min};
  u64* row = scratch + static_cast<long long>(blockIdx.x) * domain;
  for (int c = threadIdx.x; c < domain; c += kThreads) {
    Acc a = all[c];
    for (int w = 1; w < copies; ++w) a = op(a, all[w * domain + c]);
    row[c] = static_cast<u64>(static_cast<long long>(a));
  }
  __syncthreads();  // smem becomes the fold's scratch
  finish(scratch, tickets, domain, fold,
         [&](int c, u64 v) {
           long long x = static_cast<long long>(v);
           if constexpr (kF64) x = f64_from_order(x);
           out[c] = static_cast<In>(x);
         },
         smem);
}

template <typename In, typename Acc, bool kF64>
int launch_reduce(const int* seg, long long cap, int domain, const void* lane,
                  long long ident, int is_min, void* out, u64* scratch,
                  int* tickets, int n_tickets, cudaStream_t st,
                  long long* scratch_bytes) {
  if (domain <= 0 || sizeof(Acc) * static_cast<size_t>(domain) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(Acc) * static_cast<size_t>(domain);
  const int copies = copies_for(bytes);
  const size_t smem = smem_for(copies, bytes);
  DevInfo dev;
  const cudaError_t e = dev_info(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = grid_for(dev, smem, cap, kReduceRows);
  if (scratch_bytes) {
    *scratch_bytes = scratch_cells(grid, domain) * sizeof(u64);
    return static_cast<int>(cudaSuccess);
  }
  if (!tickets_cover(n_tickets, grid, domain))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kF64) ident = f64_order(ident);
  const In* in = static_cast<const In*>(lane);
  In* o = static_cast<In*>(out);
  if (smem > kDefaultSmem) {
    const cudaError_t a = allow_smem<seg_reduce_kernel<In, Acc, kF64>>();
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  seg_reduce_kernel<In, Acc, kF64><<<grid, kThreads, smem, st>>>(
      seg, cap, domain, copies, in, ident, is_min, o, scratch, tickets);
  return static_cast<int>(cudaGetLastError());
}

// `code`: 1 = int8 (and bool), 2 = int16, 4 = int32, 8 = int64, 9 =
// float64 (bit patterns).
int dispatch_reduce(const int* seg, long long cap, int domain, const void* lane,
                    int code, long long ident, int is_min, void* out,
                    u64* scratch, int* tickets, int n_tickets,
                    cudaStream_t st, long long* scratch_bytes) {
  switch (code) {
    case 1:
      return launch_reduce<int8_t, int, false>(
          seg, cap, domain, lane, ident, is_min, out, scratch, tickets,
          n_tickets, st, scratch_bytes);
    case 2:
      return launch_reduce<int16_t, int, false>(
          seg, cap, domain, lane, ident, is_min, out, scratch, tickets,
          n_tickets, st, scratch_bytes);
    case 4:
      return launch_reduce<int, int, false>(
          seg, cap, domain, lane, ident, is_min, out, scratch, tickets,
          n_tickets, st, scratch_bytes);
    case 8:
      return launch_reduce<long long, long long, false>(
          seg, cap, domain, lane, ident, is_min, out, scratch, tickets,
          n_tickets, st, scratch_bytes);
    case 9:
      return launch_reduce<long long, long long, true>(
          seg, cap, domain, lane, ident, is_min, out, scratch, tickets,
          n_tickets, st, scratch_bytes);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry point launches on the caller's stream (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = success).  `scratch` holds at
// least the bytes the matching *_scratch query gives for the same
// arguments; `tickets` holds `n_tickets` int32 counters, zero before the
// first call on a stream and left zero by every call that completes (a
// call needs one more than its fold groups, at most ceil(sqrt(grid)) + 1;
// a launch it does not cover is refused with cudaErrorInvalidValue).

// Bytes of scratch a seg_sums call needs (the largest of its lane tiles),
// or minus the CUDA error that refuses it.
extern "C" long long segagg_seg_sums_scratch(long long cap, int domain, int ki,
                                             int kf) {
  if (domain <= 0 || sizeof(u64) * static_cast<size_t>(domain) > kSmemMax)
    return -static_cast<long long>(cudaErrorInvalidValue);
  DevInfo dev;
  const cudaError_t e = dev_info(&dev);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  long long most = 0;
  const int total = ki + kf;
  for (int lo = 0; lo < total;) {
    const SumsTile t = sums_tile(dev, cap, domain, lo, total);
    const long long b =
        scratch_cells(t.grid, static_cast<long long>(t.hi - lo) * domain) *
        sizeof(u64);
    if (b > most) most = b;
    lo = t.hi;
  }
  return most;
}

// *launched (host memory) receives the number of seg_sums_kernel launches:
// one per lane tile.
extern "C" int segagg_seg_sums(const int* seg, long long cap, int domain,
                               const void* const* int_lanes, int ki,
                               const void* const* f64_lanes, int kf,
                               long long* iout, double* fout, void* scratch,
                               int* tickets, int n_tickets, void* stream,
                               int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (domain <= 0 || sizeof(u64) * static_cast<size_t>(domain) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  DevInfo dev;
  const cudaError_t de = dev_info(&dev);
  if (de != cudaSuccess) return static_cast<int>(de);
  const int total = ki + kf;
  for (int lo = 0; lo < total;) {
    const SumsTile t = sums_tile(dev, cap, domain, lo, total);
    LaneTable table;
    int n_int = 0;
    for (int j = lo; j < t.hi; ++j) {
      table.p[j - lo] = j < ki ? int_lanes[j] : f64_lanes[j - ki];
      if (j < ki) ++n_int;
    }
    const int n_lanes = t.hi - lo;
    if (!tickets_cover(n_tickets, t.grid,
                       static_cast<long long>(n_lanes) * domain))
      return static_cast<int>(cudaErrorInvalidValue);
    u64* sc = static_cast<u64*>(scratch);
    if (t.smem > kDefaultSmem) {
      const cudaError_t e = allow_smem<seg_sums_kernel>();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    seg_sums_kernel<<<t.grid, kThreads, t.smem, st>>>(
        seg, cap, domain, t.copies, table, n_int, n_lanes, iout, ki, lo, fout,
        kf, lo + n_int - ki, sc, tickets);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    lo = t.hi;
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch a seg_reduce call needs, or minus the CUDA error that
// refuses it (a bad code or domain: cudaErrorInvalidValue).
extern "C" long long segagg_seg_reduce_scratch(long long cap, int domain,
                                               int code) {
  long long bytes = 0;
  const int e = dispatch_reduce(nullptr, cap, domain, nullptr, code, 0, 0,
                                nullptr, nullptr, nullptr, 0, nullptr,
                                &bytes);
  return e != 0 ? -static_cast<long long>(e) : bytes;
}

// One launch.  `ident` is the identity as a sign-extended integer, or for
// float64 its bit pattern; `out` has the lane's type.
extern "C" int segagg_seg_reduce(const int* seg, long long cap, int domain,
                                 const void* lane, int code, long long ident,
                                 int is_min, void* out, void* scratch,
                                 int* tickets, int n_tickets, void* stream) {
  return dispatch_reduce(seg, cap, domain, lane, code, ident, is_min, out,
                         static_cast<u64*>(scratch), tickets, n_tickets,
                         static_cast<cudaStream_t>(stream), nullptr);
}
