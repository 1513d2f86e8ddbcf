"""Equi-join building blocks: canonical key lanes, the build side and the
probes of the hash-table tier.

Counterpart of spark_rapids_tpu/ops/join.py for the hash-table tier:

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

The reference's dense direct-address tables and its sorted (merge-rank)
tier port with the next join slice; until then every probe raises
without a hash table.
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

    @property
    def capacity(self) -> int:
        return self.batch.capacity

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


def _table(build: BuildTable, probe_lanes: List[torch.Tensor]):
    """The build's hash table for a single-lane probe, or raise: without
    one the reference runs its dense or sorted tier."""
    assert len(probe_lanes) == 1 and len(build.lanes) == 1, \
        "the hash-table probes take exact single-lane keys"
    table = build.hash_table
    if table is None:
        raise NotImplementedError(
            "the join kernel tier is off: the reference's dense and sorted "
            "join tiers port with the next join slice (ROADMAP Queue 1)")
    return table


def _lane(probe_lanes: List[torch.Tensor]) -> torch.Tensor:
    return probe_lanes[0].to(torch.int64).contiguous()


def probe_aligned(build: BuildTable, probe_lanes: List[torch.Tensor],
                  probe_valid: torch.Tensor):
    """Probe a build side whose keys are UNIQUE: (build_idx int32, ok
    bool) at the probe's capacity, with no host sync.  Single lane only:
    there the lane is exact, so the one hit IS the match."""
    from .hopper import hashjoin as HK
    row, ok = HK.probe_first(_table(build, probe_lanes), _lane(probe_lanes),
                             probe_valid.contiguous())
    return torch.clamp(row, min=0), ok


def probe_matched_lazy(build: BuildTable, probe_lanes: List[torch.Tensor],
                       probe_valid: torch.Tensor) -> torch.Tensor:
    """Per probe row matched flag with no host sync (semi and anti joins
    need only the flag, never the pairs); sound for any build, unique or
    not, because the single lane is exact."""
    from .hopper import hashjoin as HK
    return HK.probe_matched(_table(build, probe_lanes), _lane(probe_lanes),
                            probe_valid.contiguous())


def probe_counts(build: BuildTable, probe_lanes: List[torch.Tensor],
                 probe_valid: torch.Tensor):
    """-> (first, counts, cum, total): per probe row the table slot where
    its matches start and their number, the inclusive prefix sum of the
    numbers, and the pair total as a host int (the one sync)."""
    from .hopper import hashjoin as HK
    first, counts, cum = HK.probe_counts(_table(build, probe_lanes),
                                         _lane(probe_lanes),
                                         probe_valid.contiguous())
    total = int(cum[-1]) if cum.shape[0] else 0
    return first, counts, cum, total


def expand_pairs(build: BuildTable, probe_lanes: List[torch.Tensor],
                 probe_valid: torch.Tensor, first, counts, cum,
                 out_cap: int, total: int):
    """-> (probe_idx, build_idx, ok, probe_matched).

    probe_idx/build_idx: (out_cap,) gather indices of the `total` pairs,
    probe-major with build rows ascending within a key; ok: the live
    slots; probe_matched: per probe row."""
    from .hopper import hashjoin as HK
    table = _table(build, probe_lanes)
    if total > out_cap:
        # callers size out_cap from probe_counts' total; a smaller cap
        # would silently drop matching rows
        raise ValueError(f"join candidate pairs {total} exceed output "
                         f"capacity {out_cap}")
    probe_idx, build_idx, ok = HK.expand_pairs(table, first, counts, cum,
                                               out_cap, total)
    return probe_idx, build_idx, ok, probe_valid & (counts > 0)


def build_matched(build: BuildTable, first, counts) -> torch.Tensor:
    """Per build row, whether a counted probe run matched it (right and
    full outer joins; the reference computes it inside expand_pairs for
    every join type)."""
    from .hopper import hashjoin as HK
    return HK.build_matched_flags(build.hash_table, first, counts,
                                  build.capacity)
