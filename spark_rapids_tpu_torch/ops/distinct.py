"""count(DISTINCT) over sorted runs.

Counterpart of spark_rapids_tpu/ops/distinct.py.  Rows sort by (group
keys, value, null flag) through ops/segments.py `sorted_segments`, and a
group's count is the number of its valid rows whose value differs from
the previous row's (or that open the group): no deduplicated table is
materialised.  Nulls are not counted, every NaN is one value and -0.0
equals 0.0 (Spark's normalisation for grouping and distinct).

The value's equality lane is ops/join.py `canonical_lanes`: DOUBLE is
native float64 on the card, so it compares as its canonical bit pattern
(one lane), not through the reference's int64-bits masks.  When the
value carries exact bounds (`val_range`: a dictionary's size or a
column's scan range), it packs with the null flag into the group keys'
single sort lane, and the whole order is one sort.
"""
from __future__ import annotations

import torch

from .. import types as t
from ..columnar.device import DeviceColumn
from .groupby import _eq_prev
from .join import canonical_lanes
from .segments import seg_sums_sorted, sorted_segments


def value_lane(col: DeviceColumn) -> torch.Tensor:
    """int64 lane whose equality is the value's distinct-equality."""
    return canonical_lanes(col)[0]


def distinct_count_trace(key_lanes_info, num_segments: int, capacity: int,
                         pack_spec=None, val_range=None):
    """fn(keys, keys_valid, value column, live) -> (per key (data,
    valid), (count int64, valid), num_groups 0-d tensor), outputs
    (num_segments,)-sized with the groups first in ascending key order.

    val_range: exact (lo, hi) of the value lane (dictionary codes or a
    scan range of an integer column), or None."""

    def run(keys, keys_valid, val: DeviceColumn, live):
        vlive = live if val.validity is None else live & val.validity
        vlane = value_lane(val)
        # within a group: valid values ascending, then the nulls
        minor = [vlane, (~vlive).to(torch.int8)]
        minor_spec = None
        if val_range is not None:
            lo, hi = int(val_range[0]), int(val_range[1])
            minor_spec = [(lo, hi - lo + 1), (0, 2)]
        runs = sorted_segments(key_lanes_info, keys, keys_valid, live,
                               capacity, num_segments, pack_spec=pack_spec,
                               minor_lanes=minor, minor_spec=minor_spec)
        perm = runs.perm.long()
        # a valid row counts where its group opens or its value changes
        first = vlive[perm] & (runs.boundary | _eq_prev(vlane[perm]))
        cnt = seg_sums_sorted([first.to(torch.int64)], runs.start_idx,
                              runs.end_idx)[:, 0]
        return runs.out_keys, (cnt, runs.group_live), runs.num_groups

    return run


def exact_value_range(col: DeviceColumn, scan_range):
    """Exact bounds of a value lane for packing: a dictionary's codes, or
    an integral (non-floating) column's scan range, else None."""
    if col.dictionary is not None:
        return 0, max(len(col.dictionary) - 1, 0)
    if scan_range is None or isinstance(col.dtype, (t.DoubleType,
                                                    t.FloatType)):
        return None
    return int(scan_range[0]), int(scan_range[1])
