"""Equi-join building blocks: canonical key lanes, the build side and the
probes of the hash-table, dense and sorted tiers.

Counterpart of spark_rapids_tpu/ops/join.py:

  1. every key column maps to a *canonical int64 lane* on which Spark
     join equality is integer equality (`canonical_lanes`): integers,
     dates and narrow decimals widen to int64 the same way on both
     sides, dictionary-coded strings use their codes (the caller unifies
     the dictionaries), floats compare as canonical bit patterns (one
     NaN, -0.0 folded into 0.0); composite keys whose ranges pack arrive
     as one packed lane (`lanes_override`, exec/join.py);
  2. a single-lane build side either arms a murmur3 open-addressing hash
     table (`BuildTable.hash_table`, ops/hopper/hashjoin.py, when the
     kernel tier is elected), or, over a bounded key domain
     (`domain=(lo, hi)`), direct-address tables over the span: per-key
     offsets into the domain-sorted rows (`offs`), the build row of each
     key of a unique build (`slot`) and a presence bitmap for semi and
     anti joins (`present`), each built lazily, so a probe pays only for
     what its join type reads;
  3. any other build runs the sorted tier: the single lane, or for
     several lanes their `composite_hash`, sorted once, stably, with
     dead and null-key rows last (`BuildTable.perm` / `sorted_lane`),
     and each probe key's candidate range found by `torch.searchsorted`
     (the reference's `_merge_rank`: a TPU gathers slowly, a CUDA binary
     search does not).  A multi-lane candidate range may hold hash
     collisions, so every pair is verified on every lane and collisions
     only cost a masked-out slot;
  4. a build side whose keys are unique (single lane) makes every probe
     row match at most once, so `probe_aligned` returns (build_idx, ok)
     at the probe's own capacity with no host sync, and
     `probe_matched_lazy` gives semi and anti joins their flag the same
     way; any other build is probed by `probe_counts` (one host sync
     fetches the pair total) and expanded by `expand_pairs` into a sized
     output.

Pairs come out probe-major with build rows ascending within a key on
every tier.  The dense and sorted tiers are PyTorch's sorts,
searchsorted, scatters and gathers, as the reference's are jnp's; the
matched flags of outer joins come either from a sort and two searches
over the matched indices (`sql.join.matchedViaMerge`, the default) or
from a scatter-max, and the dense tables either from a sort and a
search (`sql.join.denseBuildViaSort`, the default) or from scatters.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
_GOLDEN = 0x9E3779B97F4A7C15
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
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


def _s64(c: int) -> int:
    c &= (1 << 64) - 1
    return c - (1 << 64) if c > _I64_MAX else c


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 lanes (uint64 bits; the
    multiplies wrap modulo 2^64)."""
    x = (x ^ _lsr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def composite_hash(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold canonical lanes into one int64 lane holding the reference's
    uint64 hash bits (a single lane: the lane itself, exact ranges and
    no collisions)."""
    if len(lanes) == 1:
        return lanes[0].to(torch.int64)
    h = torch.zeros_like(lanes[0], dtype=torch.int64)
    for i, lane in enumerate(lanes):
        u = lane.to(torch.int64) + _s64(_GOLDEN * (i + 1))
        h = _mix64(h ^ _mix64(u))
    return h


def search_lane(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The lane the sorted tier sorts and searches: a single lane as it
    is, several lanes as their composite hash with the sign bit flipped,
    so that int64 order is the uint64 order (PyTorch has no uint64 sort;
    build and probe only have to agree)."""
    if len(lanes) == 1:
        return lanes[0].to(torch.int64)
    return composite_hash(lanes) ^ _I64_MIN


def matched_flags(idx: torch.Tensor, ok: torch.Tensor, n: int,
                  via_merge: bool) -> torch.Tensor:
    """flags[i] = some slot with ok holds index i, over `n` indices: the
    verified indices sorted and searched for each i (`via_merge`, the
    reference's merge-rank difference), or a scatter-max."""
    dev = idx.device
    if via_merge:
        keys = torch.where(ok, idx.to(torch.int64),
                           torch.full_like(idx, n, dtype=torch.int64))
        s = torch.sort(keys).values
        r = torch.arange(n, dtype=torch.int64, device=dev)
        return torch.searchsorted(s, r, right=True) > \
            torch.searchsorted(s, r, right=False)
    hit = torch.zeros(n, dtype=torch.int32, device=dev)
    hit.scatter_reduce_(0, torch.where(ok, idx.to(torch.int64),
                                       torch.zeros_like(idx,
                                                        dtype=torch.int64)),
                        ok.to(torch.int32), "amax")
    return hit > 0


class BuildTable:
    """Build side of a join: the canonical lanes, the key-valid mask
    (live rows, `extra_valid` from fused build-side filters, non-null
    keys) and, built lazily, the structures of its tier.

    `lanes_override` replaces the per-column canonical lanes (the
    range-packed lane of a composite key, exec/join.py); key validity
    still derives from `key_cols`.  `hash_tier` is the elected kernel
    tier (ops/hopper elect_join); the table arms only for a single lane,
    as in the reference (a multi-lane key needs the sorted tier's
    collision checks, and counts a `multi_lane` fallback).
    `domain=(lo, hi)` says every valid build key lies in [lo, hi] (exact
    plan statistics or a dictionary's size; single lane only): without a
    hash table the probes then read the direct-address tables.  `unique`
    says the build keys are distinct, which gives the domain its `slot`
    table."""

    def __init__(self, batch: DeviceBatch, key_cols: Sequence[DeviceColumn],
                 lanes_override: Optional[List[torch.Tensor]] = None,
                 extra_valid: Optional[torch.Tensor] = None,
                 hash_tier=None, domain: Optional[Tuple[int, int]] = None,
                 unique: bool = False, dense_via_sort: bool = True,
                 matched_via_merge: bool = True,
                 matched_via_presence: bool = True):
        self.batch = batch
        self.lanes = lanes_override if lanes_override is not None \
            else key_cols_lanes(key_cols)
        valid = batch.row_mask() if extra_valid is None else extra_valid
        for c in key_cols:
            valid = valid & c.validity      # null keys never match
        self.key_valid = valid
        self.exact = len(self.lanes) == 1
        self.hash_tier = None
        if hash_tier is not None:
            if self.exact:
                self.hash_tier = hash_tier
            else:
                from .hopper import count_fallback
                count_fallback("hash_probe_join", "multi_lane")
        self.domain = (int(domain[0]), int(domain[1])) \
            if domain is not None and self.exact else None
        self.unique = unique
        self.dense_via_sort = dense_via_sort
        self.matched_via_merge = matched_via_merge
        self.matched_via_presence = matched_via_presence
        self._hash_table = None
        self._perm = None
        self._sorted_lane = None
        self._valid_count = None
        self._slot = None
        self._offs = None
        self._present = None

    @property
    def capacity(self) -> int:
        return self.batch.capacity

    @property
    def span(self) -> int:
        lo, hi = self.domain
        return hi - lo + 1

    def _dense_pos(self) -> torch.Tensor:
        """Each build row's position in the domain (int32), `span` for
        a dead, null-key or out-of-domain row."""
        lo, hi = self.domain
        lane = self.lanes[0].to(torch.int64)
        inb = self.key_valid & (lane >= lo) & (lane <= hi)
        pos = torch.clamp(lane - lo, 0, self.span - 1)
        return torch.where(inb, pos, torch.full_like(pos, self.span)).to(
            torch.int32)

    @property
    def offs(self) -> Optional[torch.Tensor]:
        """Per-key start offsets into the domain-sorted rows (int32,
        span + 1): key k's build rows are perm[offs[k-lo]:offs[k-lo+1]].
        Sort-built (`dense_via_sort`): the rank of each domain position
        among the sorted positions; else a count scatter and a prefix
        sum.  None without a domain."""
        if self.domain is None:
            return None
        if self._offs is None:
            tgt = self._dense_pos()
            span = self.span
            if self.dense_via_sort:
                keys = torch.arange(span + 1, dtype=torch.int32,
                                    device=tgt.device)
                self._offs = torch.searchsorted(torch.sort(tgt).values, keys,
                                                out_int32=True)
            else:
                from .hopper.hashjoin import inclusive_cumsum
                counts = torch.zeros(span + 1, dtype=torch.int32,
                                     device=tgt.device)
                counts.index_add_(0, tgt.to(torch.int64),
                                  torch.ones_like(tgt))
                self._offs = torch.cat([torch.zeros(1, dtype=torch.int32,
                                                    device=tgt.device),
                                        inclusive_cumsum(counts[:span])])
        return self._offs

    @property
    def slot(self) -> Optional[torch.Tensor]:
        """slot[k-lo] = the build row of key k, -1 where absent (int32);
        None unless the domain's build is unique.  Sort-built: the row at
        each key's offset in the sorted order; else one scatter."""
        if self.domain is None or not self.unique:
            return None
        if self._slot is None:
            if self.dense_via_sort:
                offs = self.offs
                first = self.perm[torch.clamp(offs[:-1].to(torch.int64), 0,
                                              max(self.capacity - 1, 0))]
                self._slot = torch.where(offs[1:] > offs[:-1],
                                         first.to(torch.int32),
                                         torch.full_like(offs[1:], -1))
            else:
                tgt = self._dense_pos().to(torch.int64)
                slot = torch.full((self.span + 1,), -1, dtype=torch.int32,
                                  device=tgt.device)
                slot.scatter_(0, tgt, torch.arange(
                    self.capacity, dtype=torch.int32, device=tgt.device))
                self._slot = slot[:self.span]
        return self._slot

    @property
    def present(self) -> Optional[torch.Tensor]:
        """present[k-lo] = some valid build row carries key k: all a semi
        or anti join's flag needs (one bool scatter over the build rows
        and a byte gather a probe row).  None without a domain."""
        if self.domain is None:
            return None
        if self._present is None:
            tgt = self._dense_pos().to(torch.int64)
            present = torch.zeros(self.span + 1, dtype=torch.bool,
                                  device=tgt.device)
            present[tgt] = True
            self._present = present[:self.span]
        return self._present

    def _sort(self):
        """The build order of the dense and sorted tiers.  Dense: rows by
        domain position, stably (rows outside it last).  Sorted: the
        search lane sorted stably, dead and null-key rows after every
        live one (their lane reads INT64_MAX, so the array stays
        non-decreasing and the searchable region is exactly
        [0, valid_count))."""
        if self.domain is not None:
            self._perm = torch.argsort(self._dense_pos(), stable=True)
            return
        lane = search_lane(self.lanes)
        key = torch.where(self.key_valid, lane,
                          torch.full_like(lane, _I64_MAX))
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
    assert len(probe_lanes) == 1 and build.exact, \
        "probe_aligned and probe_matched_lazy take exact single-lane keys"


def _lane(probe_lanes: List[torch.Tensor]) -> torch.Tensor:
    return probe_lanes[0].to(torch.int64).contiguous()


def _dense_probe_pos(build: BuildTable, lane: torch.Tensor,
                     probe_valid: torch.Tensor):
    """(pos int64, in_bounds) of probe keys in the build's domain."""
    lo, hi = build.domain
    inb = probe_valid & (lane >= lo) & (lane <= hi)
    return torch.clamp(lane - lo, 0, hi - lo), inb


def _ranges(build: BuildTable, probe_lanes: List[torch.Tensor]):
    """The sorted tier's candidate range [lo, hi) of each probe key in
    `build.sorted_lane`, restricted to the valid prefix (int64)."""
    key = search_lane(probe_lanes).contiguous()
    sl = build.sorted_lane
    vc = build.valid_count
    lo = torch.minimum(torch.searchsorted(sl, key, right=False), vc)
    hi = torch.minimum(torch.searchsorted(sl, key, right=True), vc)
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
    if build.slot is not None:
        pos, inb = _dense_probe_pos(build, lane, probe_valid)
        build_idx = build.slot[pos]
        ok = inb & (build_idx >= 0)
        return torch.where(ok, build_idx, torch.zeros_like(build_idx)), ok
    lo, _hi = _ranges(build, probe_lanes)
    pos = torch.clamp(lo, max=max(build.capacity - 1, 0))
    build_idx = build.perm[pos]
    ok = probe_valid & (lo < build.valid_count) & \
        (build.sorted_lane[pos] == lane) & build.key_valid[build_idx]
    return build_idx.to(torch.int32), ok


def probe_matched_lazy(build: BuildTable, probe_lanes: List[torch.Tensor],
                       probe_valid: torch.Tensor) -> torch.Tensor:
    """Per probe row matched flag with no host sync (semi and anti joins
    need only the flag, never the pairs); sound for any build, unique or
    not, because the single lane is exact.  A dense domain answers from
    the presence bitmap (`matched_via_presence`) or the offsets."""
    _single(build, probe_lanes)
    lane = _lane(probe_lanes)
    if build.hash_table is not None:
        from .hopper import hashjoin as HK
        return HK.probe_matched(build.hash_table, lane,
                                probe_valid.contiguous())
    if build.domain is not None:
        pos, inb = _dense_probe_pos(build, lane, probe_valid)
        if build.matched_via_presence:
            return inb & build.present[pos]
        offs = build.offs
        return inb & (offs[pos + 1] > offs[pos])
    lo, hi = _ranges(build, probe_lanes)
    return probe_valid & (hi > lo)


def probe_counts(build: BuildTable, probe_lanes: List[torch.Tensor],
                 probe_valid: torch.Tensor):
    """-> (first, counts, cum, total): per probe row where its candidates
    start (a hash-table slot, or a position in `perm` on the dense and
    sorted tiers) and their number, the inclusive prefix sum of the
    numbers, and the candidate total as a host int (the one sync).  A
    multi-lane key's candidates may hold hash collisions, which
    `expand_pairs` verifies away."""
    from .hopper import hashjoin as HK
    if build.hash_table is not None:
        first, counts, cum = HK.probe_counts(build.hash_table,
                                             _lane(probe_lanes),
                                             probe_valid.contiguous())
    elif build.domain is not None:
        pos, inb = _dense_probe_pos(build, _lane(probe_lanes), probe_valid)
        offs = build.offs
        first = offs[pos]
        counts = torch.where(inb, offs[pos + 1] - first,
                             torch.zeros_like(first))
        cum = HK.inclusive_cumsum(counts)
    else:
        lo, hi = _ranges(build, probe_lanes)
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

    probe_idx/build_idx: (out_cap,) gather indices of the `total`
    candidate pairs, probe-major with build rows ascending within a key;
    ok: the live pairs whose build key equals the probe key on every
    lane; probe_matched: per probe row, some pair of it is ok."""
    from .hopper import hashjoin as HK
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
    ok = (j < total) & probe_valid[p] & build.key_valid[b]
    for bl, pl in zip(build.lanes, probe_lanes):
        ok = ok & (bl.to(torch.int64)[b] == pl.to(torch.int64)[p])
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    live = j < total
    probe_idx = torch.where(live, p, zero).to(torch.int32)
    if build.exact:
        probe_matched = probe_valid & (counts > 0)
    else:
        probe_matched = matched_flags(probe_idx, ok, probe_valid.shape[0],
                                      build.matched_via_merge)
    return (probe_idx, torch.where(live, b, zero).to(torch.int32), ok,
            probe_matched)


def build_matched(build: BuildTable, first, counts, build_idx=None,
                  ok=None) -> torch.Tensor:
    """Per build row, whether some probe row matched it (right and full
    outer joins).  Exact tiers mark the counted runs; a multi-lane key's
    runs may hold collisions, so it reads the verified pairs
    (`build_idx`, `ok` from expand_pairs)."""
    from .hopper import hashjoin as HK
    if build.hash_table is not None:
        return HK.build_matched_flags(build.hash_table, first, counts,
                                      build.capacity)
    cap = build.capacity
    if not build.exact:
        return matched_flags(build_idx, ok, cap, build.matched_via_merge)
    # the dense and sorted tiers: +1 at each run's first position and -1
    # past its end; a prefix sum > 0 marks the covered positions, which
    # `perm` carries to build rows
    has = counts > 0
    lo = first.to(torch.int64)
    spare = torch.full_like(lo, cap)
    delta = torch.zeros(cap + 1, dtype=torch.int32, device=lo.device)
    ones = torch.ones_like(counts, dtype=torch.int32)
    delta.index_add_(0, torch.where(has, lo, spare), ones)
    delta.index_add_(0, torch.where(has, lo + counts.to(torch.int64), spare),
                     -ones)
    covered = HK.inclusive_cumsum(delta[:cap]) > 0
    flags = torch.zeros(cap, dtype=torch.bool, device=lo.device)
    flags[build.perm[covered]] = True
    return flags
