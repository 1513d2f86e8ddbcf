"""Equi-join building blocks: canonical key lanes, the build side and the
probes of the hash-table tier.

Counterpart of spark_rapids_tpu/ops/join.py for the hash-table and
sorted tiers:

  1. every key column maps to a *canonical int64 lane* on which Spark
     join equality is integer equality (`canonical_lanes`): integers,
     dates and narrow decimals widen to int64 the same way on both
     sides, dictionary-coded strings use their codes (the caller unifies
     the dictionaries), floats compare as canonical bit patterns (one
     NaN, -0.0 folded into 0.0); composite keys whose ranges pack arrive
     as one packed lane (`lanes_override`, exec/join.py);
  2. a single-lane build side arms a murmur3 open-addressing hash table
     (`BuildTable.hash_table`, ops/hopper/hashjoin.py), built lazily
     once per build side;
  3. a build side whose keys are unique makes every probe row match at
     most once, so `probe_aligned` returns (build_idx, ok) at the
     probe's own capacity with no host sync, and `probe_matched_lazy`
     gives semi and anti joins their flag the same way;
  4. any other build is probed by `probe_counts` (one host sync fetches
     the pair total) and expanded by `expand_pairs` into a sized output,
     with the per-row matched flags outer joins need.

Without a hash table (the join family off, a build over
`join.maxBuildRows`, or a shed at the `kernel` chaos site) every probe
runs the sorted tier: the build's lane sorted once, stably, with
invalid rows last (`BuildTable.perm` / `sorted_lane`), and each probe
key's candidate range found by `torch.searchsorted` (the reference's
`_merge_rank`: a TPU gathers slowly, a CUDA binary search does not).
Every pair is verified on the key lane, and pairs come out probe-major
with build rows ascending within a key, as the kernels give them.  The
sorted tier is PyTorch's sort, searchsorted and gathers, as the
reference's is jnp's.  The reference's dense direct-address tables are
not ported: the hash table or the sorted tier takes those joins.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn

INNER = "inner"
LEFT_OUTER = "left_outer"
RIGHT_OUTER = "right_outer"
FULL_OUTER = "full_outer"
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"
CROSS = "cross"

_F64_NAN_BITS = 0x7FF8000000000000
_F32_NAN_BITS = 0x7FC00000


def canonical_lanes(col: DeviceColumn) -> List[torch.Tensor]:
    """int64 lane(s) with Spark join-equality semantics: value equality
    on the column == elementwise equality of the lanes.  Strings must
    already carry a side-unified dictionary.  DOUBLE is native float64 on
    the card, so its lane is the canonical bit pattern (the reference's
    int64-bits storage path) — one lane, exact for all 64 bits."""
    dt = col.dtype
    data = col.data
    if isinstance(dt, (t.DoubleType, t.FloatType)):
        is_double = isinstance(dt, t.DoubleType)
        x = data.to(torch.float64 if is_double else torch.float32)
        isnan = torch.isnan(x)
        x = torch.where(x == 0.0, torch.zeros_like(x), x)   # -0.0 -> 0.0
        bits = x.view(torch.int64 if is_double else torch.int32)
        nan_bits = _F64_NAN_BITS if is_double else _F32_NAN_BITS
        bits = torch.where(isnan, torch.full_like(bits, nan_bits), bits)
        return [bits.to(torch.int64)]
    if isinstance(dt, t.DecimalType) and dt.is_wide:
        raise NotImplementedError("wide decimal join keys")
    return [data.to(torch.int64)]


def key_cols_lanes(key_cols: Sequence[DeviceColumn]) -> List[torch.Tensor]:
    """Flat canonical lane list for a key column set."""
    lanes: List[torch.Tensor] = []
    for c in key_cols:
        lanes.extend(canonical_lanes(c))
    return lanes


class BuildTable:
    """Build side of a join on the hash-table tier: the canonical lanes,
    the key-valid mask (live rows, `extra_valid` from fused build-side
    filters, non-null keys) and the lazily built hash table.

    `lanes_override` replaces the per-column canonical lanes (the
    range-packed lane of a composite key, exec/join.py); key validity
    still derives from `key_cols`.  `hash_tier` is the elected kernel
    tier (ops/hopper elect_join); the table arms only for a single lane,
    as in the reference (other composite keys need the sorted tier's
    collision checks)."""

    def __init__(self, batch: DeviceBatch, key_cols: Sequence[DeviceColumn],
                 lanes_override: Optional[List[torch.Tensor]] = None,
                 extra_valid: Optional[torch.Tensor] = None,
                 hash_tier=None):
        self.batch = batch
        self.lanes = lanes_override if lanes_override is not None \
            else key_cols_lanes(key_cols)
        valid = batch.row_mask() if extra_valid is None else extra_valid
        for c in key_cols:
            valid = valid & c.validity      # null keys never match
        self.key_valid = valid
        self.hash_tier = hash_tier if len(self.lanes) == 1 else None
        self._hash_table = None
        self._perm = None
        self._sorted_lane = None
        self._valid_count = None

    @property
    def capacity(self) -> int:
        return self.batch.capacity

    def _sort(self):
        """The sorted tier's build order: the single lane sorted stably,
        dead and null-key rows after every live one (their lane reads
        INT64_MAX, so the array stays non-decreasing and the searchable
        region is exactly [0, valid_count))."""
        lane = self.lanes[0].to(torch.int64)
        key = torch.where(self.key_valid, lane,
                          torch.full_like(lane, torch.iinfo(torch.int64).max))
        by_key = torch.argsort(key, stable=True)
        perm = by_key[torch.argsort((~self.key_valid[by_key]).to(torch.int8),
                                    stable=True)]
        self._perm = perm
        self._sorted_lane = key[perm].contiguous()

    @property
    def perm(self) -> torch.Tensor:
        """Build row of each sorted position (int64)."""
        if self._perm is None:
            self._sort()
        return self._perm

    @property
    def sorted_lane(self) -> torch.Tensor:
        if self._sorted_lane is None:
            self._sort()
        return self._sorted_lane

    @property
    def valid_count(self) -> torch.Tensor:
        """The number of live, non-null build keys (0-d, on the device)."""
        if self._valid_count is None:
            self._valid_count = self.key_valid.sum()
        return self._valid_count

    @property
    def hash_table(self):
        """The hash table (built once per build side), or None when no
        tier was elected."""
        if self.hash_tier is None:
            return None
        if self._hash_table is None:
            from .hopper import hashjoin as HK
            self._hash_table = HK.build_table(self.lanes[0].contiguous(),
                                              self.key_valid.contiguous())
        return self._hash_table


def _single(build: BuildTable, probe_lanes: List[torch.Tensor]) -> None:
    assert len(probe_lanes) == 1 and len(build.lanes) == 1, \
        "the hash-table and sorted probes take exact single-lane keys"


def _lane(probe_lanes: List[torch.Tensor]) -> torch.Tensor:
    return probe_lanes[0].to(torch.int64).contiguous()


def _ranges(build: BuildTable, lane: torch.Tensor):
    """The sorted tier's candidate range [lo, hi) of each probe key in
    `build.sorted_lane`, restricted to the valid prefix (int64)."""
    sl = build.sorted_lane
    vc = build.valid_count
    lo = torch.minimum(torch.searchsorted(sl, lane, right=False), vc)
    hi = torch.minimum(torch.searchsorted(sl, lane, right=True), vc)
    return lo, hi


def probe_aligned(build: BuildTable, probe_lanes: List[torch.Tensor],
                  probe_valid: torch.Tensor):
    """Probe a build side whose keys are UNIQUE: (build_idx int32, ok
    bool) at the probe's capacity, with no host sync.  Single lane only:
    there the lane is exact, so the one hit IS the match."""
    _single(build, probe_lanes)
    lane = _lane(probe_lanes)
    if build.hash_table is not None:
        from .hopper import hashjoin as HK
        row, ok = HK.probe_first(build.hash_table, lane,
                                 probe_valid.contiguous())
        return torch.clamp(row, min=0), ok
    lo, _hi = _ranges(build, lane)
    pos = torch.clamp(lo, max=max(build.capacity - 1, 0))
    build_idx = build.perm[pos]
    ok = probe_valid & (lo < build.valid_count) & \
        (build.sorted_lane[pos] == lane) & build.key_valid[build_idx]
    return build_idx.to(torch.int32), ok


def probe_matched_lazy(build: BuildTable, probe_lanes: List[torch.Tensor],
                       probe_valid: torch.Tensor) -> torch.Tensor:
    """Per probe row matched flag with no host sync (semi and anti joins
    need only the flag, never the pairs); sound for any build, unique or
    not, because the single lane is exact."""
    _single(build, probe_lanes)
    lane = _lane(probe_lanes)
    if build.hash_table is not None:
        from .hopper import hashjoin as HK
        return HK.probe_matched(build.hash_table, lane,
                                probe_valid.contiguous())
    lo, hi = _ranges(build, lane)
    return probe_valid & (hi > lo)


def probe_counts(build: BuildTable, probe_lanes: List[torch.Tensor],
                 probe_valid: torch.Tensor):
    """-> (first, counts, cum, total): per probe row where its matches
    start (a hash-table slot, or a position in the sorted tier's
    `perm`) and their number, the inclusive prefix sum of the numbers,
    and the pair total as a host int (the one sync)."""
    from .hopper import hashjoin as HK
    _single(build, probe_lanes)
    lane = _lane(probe_lanes)
    if build.hash_table is not None:
        first, counts, cum = HK.probe_counts(build.hash_table, lane,
                                             probe_valid.contiguous())
    else:
        lo, hi = _ranges(build, lane)
        counts = torch.where(probe_valid, hi - lo,
                             torch.zeros_like(lo)).to(torch.int32)
        first = lo.to(torch.int32)
        cum = HK.inclusive_cumsum(counts)
    total = int(cum[-1]) if cum.shape[0] else 0
    return first, counts, cum, total


def expand_pairs(build: BuildTable, probe_lanes: List[torch.Tensor],
                 probe_valid: torch.Tensor, first, counts, cum,
                 out_cap: int, total: int):
    """-> (probe_idx, build_idx, ok, probe_matched).

    probe_idx/build_idx: (out_cap,) gather indices of the `total` pairs,
    probe-major with build rows ascending within a key; ok: the live
    slots whose build key equals the probe key; probe_matched: per
    probe row."""
    from .hopper import hashjoin as HK
    _single(build, probe_lanes)
    if total > out_cap:
        # callers size out_cap from probe_counts' total; a smaller cap
        # would silently drop matching rows
        raise ValueError(f"join candidate pairs {total} exceed output "
                         f"capacity {out_cap}")
    if build.hash_table is not None:
        probe_idx, build_idx, ok = HK.expand_pairs(
            build.hash_table, first, counts, cum, out_cap, total)
        return probe_idx, build_idx, ok, probe_valid & (counts > 0)
    dev = first.device
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    cum64 = cum.to(torch.int64)
    # the probe row whose run covers slot j: the first inclusive sum
    # past j
    p = torch.clamp(torch.searchsorted(cum64, j, right=True),
                    max=max(first.numel() - 1, 0))
    start = cum64[p] - counts.to(torch.int64)[p]
    pos = torch.clamp(first.to(torch.int64)[p] + (j - start), 0,
                      max(build.capacity - 1, 0))
    b = build.perm[pos]
    live = j < total
    ok = live & probe_valid[p] & build.key_valid[b] & \
        (build.lanes[0].to(torch.int64)[b] == _lane(probe_lanes)[p])
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (torch.where(live, p, zero).to(torch.int32),
            torch.where(live, b, zero).to(torch.int32), ok,
            probe_valid & (counts > 0))


def build_matched(build: BuildTable, first, counts) -> torch.Tensor:
    """Per build row, whether a counted probe run matched it (right and
    full outer joins; the reference computes it inside expand_pairs for
    every join type)."""
    from .hopper import hashjoin as HK
    if build.hash_table is not None:
        return HK.build_matched_flags(build.hash_table, first, counts,
                                      build.capacity)
    # the sorted tier: +1 at each run's first position and -1 past its
    # end; a prefix sum > 0 marks the covered positions, which `perm`
    # carries to build rows
    cap = build.capacity
    has = counts > 0
    lo = first.to(torch.int64)
    spare = torch.full_like(lo, cap)
    delta = torch.zeros(cap + 1, dtype=torch.int32, device=lo.device)
    ones = torch.ones_like(counts)
    delta.index_add_(0, torch.where(has, lo, spare), ones)
    delta.index_add_(0, torch.where(has, lo + counts.to(torch.int64), spare),
                     -ones)
    covered = HK.inclusive_cumsum(delta[:cap]) > 0
    flags = torch.zeros(cap, dtype=torch.bool, device=lo.device)
    flags[build.perm[covered]] = True
    return flags
