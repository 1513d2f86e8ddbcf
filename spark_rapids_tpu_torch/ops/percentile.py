"""Sort-based percentiles and collect over the sort-segment core.

Counterpart of spark_rapids_tpu/ops/percentile.py.  The values sort as
minor lanes under the group keys (ops/segments.sorted_segments), so each
group's values are a contiguous ascending run: an exact percentile is
two gathers and a lerp, an approx_percentile partial K equi-rank
gathers (ops/quantile_sketch.py), and collect_list / collect_set one
compaction of the kept positions.

Spark's double order: values ascending with NaN the greatest (-0.0 and
0.0 equal: the value lane adds +0.0, which the card's radix sort needs
as ops/sort.py's lanes do); nulls sort after every value in their group
and are not counted.  A group with no non-null value gives null.  No
step reads a device value on the host.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .. import types as t
from .groupby import _eq_prev
from .search import searchsorted
from .segments import SegRuns, seg_sums_sorted, sorted_segments


def _value_order_lanes(val, val_valid, live):
    """(vlive, minor lanes most-minor first) ordering a group's values the
    Spark way: values ascending, NaN after every value, nulls last.  The
    NaN and null flags fold into one small int lane."""
    vlive = live & val_valid
    isnan = torch.isnan(val)
    clean = torch.where(isnan, torch.zeros_like(val), val) + 0.0
    z = isnan.to(torch.int8) + 2 * (~vlive).to(torch.int8)
    return vlive, [clean, z]


def _valid_counts(s_vlive, runs: SegRuns) -> torch.Tensor:
    """Per segment slot: the non-null values of its run."""
    return seg_sums_sorted([s_vlive.to(torch.int64)], runs.start_idx,
                           runs.end_idx)[:, 0]


def _sorted_values(key_lanes_info, keys, keys_valid, val, val_valid, live,
                   capacity, num_segments, pack_spec):
    vlive, minor = _value_order_lanes(val, val_valid, live)
    runs = sorted_segments(key_lanes_info, keys, keys_valid, live, capacity,
                           num_segments, pack_spec=pack_spec,
                           minor_lanes=minor)
    perm = runs.perm.long()
    s_val = val[perm]
    return runs, s_val, _valid_counts(vlive[perm], runs)


def percentile_trace(key_lanes_info, qs: Sequence[float],
                     num_segments: int, capacity: int, pack_spec=None):
    """fn(keys, keys_valid, val float64, val_valid, live) -> (out_keys
    [(data, valid)...], [(values, valid) per q], num_groups).  With no
    keys it is the global one-group reduction."""
    qs = [float(q) for q in qs]

    def run(keys, keys_valid, val, val_valid, live):
        runs, s_val, cnt = _sorted_values(
            key_lanes_info, keys, keys_valid, val, val_valid, live,
            capacity, num_segments, pack_spec)
        start = runs.start_idx.to(torch.int64)
        out = []
        for q in qs:
            pos = (cnt - 1).to(torch.float64) * q
            lo = torch.floor(pos).to(torch.int64)
            hi = torch.ceil(pos).to(torch.int64)
            frac = pos - lo.to(torch.float64)
            v_lo = s_val[torch.clamp(start + torch.clamp(lo, min=0), 0,
                                     capacity - 1)]
            v_hi = s_val[torch.clamp(start + torch.clamp(hi, min=0), 0,
                                     capacity - 1)]
            # an integral rank gives v_lo exactly: a NaN at the unused hi
            # end must not reach it (NaN * 0 is NaN)
            res = torch.where(frac == 0.0, v_lo, v_lo + (v_hi - v_lo) * frac)
            out.append((res, (cnt > 0) & runs.group_live))
        return runs.out_keys, out, runs.num_groups

    return run


def sketch_trace(key_lanes_info, k: int, num_segments: int, capacity: int,
                 pack_spec=None):
    """The PARTIAL of the mergeable approx_percentile: fn(keys,
    keys_valid, val float64, val_valid, live) -> (out_keys, cnt,
    points[groups, k]) of the live groups, each group's non-null count
    and its K equi-rank order statistics (ops/quantile_sketch.py).  The
    group count comes to the host (the sketches go there to merge), so
    only the live groups' points are gathered."""
    from .quantile_sketch import sketch_gather

    def run(keys, keys_valid, val, val_valid, live):
        runs, s_val, cnt = _sorted_values(
            key_lanes_info, keys, keys_valid, val, val_valid, live,
            capacity, num_segments, pack_spec)
        groups = int(runs.num_groups)
        cnt, start = cnt[:groups], runs.start_idx[:groups]
        pts = sketch_gather(s_val, start, cnt, k, capacity)
        out_keys = [(kd[:groups], kv[:groups]) for kd, kv in runs.out_keys]
        return out_keys, cnt, pts

    return run


def _value_eq_lanes(val: torch.Tensor, dt: t.DataType) -> List[torch.Tensor]:
    """Lanes, most-minor first, whose rowwise equality is the value's set
    equality (every NaN one value, -0.0 equal to 0.0) and whose order is
    the value's (NaN greatest): the reference's `_value_eq_lanes`."""
    if val.dtype.is_floating_point:
        isnan = torch.isnan(val)
        return [torch.where(isnan, torch.zeros_like(val), val) + 0.0,
                isnan.to(torch.int8)]
    if val.dtype == torch.bool:
        return [val.to(torch.int8)]
    return [val]


def collect_trace(key_lanes_info, num_segments: int, capacity: int,
                  distinct: bool, val_dtype: t.DataType, pack_spec=None):
    """collect_list / collect_set as a group-by emitting a RAGGED column.
    Sorting by (key, [value,] position) makes each group's kept values a
    contiguous run; one single-lane sort compacts the kept positions.
    collect_list keeps the non-null values in input order; collect_set
    the first of each distinct value, value-sorted.  fn(keys,
    keys_valid, val, val_valid, live) -> (out_keys, values, offsets
    int32[num_segments + 1], elem_valid, num_groups, group_live); the
    values lane's capacity is the row capacity."""

    def run(keys, keys_valid, val, val_valid, live):
        dev = live.device
        vlive = live & val_valid
        idx = torch.arange(capacity, dtype=torch.int32, device=dev)
        nulls = (~vlive).to(torch.int8)
        minor = [idx] + (_value_eq_lanes(val, val_dtype) if distinct
                         else []) + [nulls]
        runs = sorted_segments(key_lanes_info, keys, keys_valid, live,
                               capacity, num_segments, pack_spec=pack_spec,
                               minor_lanes=minor)
        perm = runs.perm.long()
        s_val = val[perm]
        keep = vlive[perm]
        if distinct:
            changed = runs.boundary
            for lane in _value_eq_lanes(s_val, val_dtype):
                changed = changed | _eq_prev(lane)
            keep = keep & changed
        seg_ids = torch.cumsum(runs.boundary.to(torch.int32), 0,
                               dtype=torch.int32) - 1
        # the kept positions to the front, in (group, order) order
        kept = torch.sort(torch.where(keep, idx, torch.full_like(
            idx, capacity))).values
        kept_c = torch.clamp(kept, 0, capacity - 1).long()
        n_kept = keep.sum(dtype=torch.int32)
        values = s_val[kept_c]
        elem_valid = idx < n_kept
        # offsets[g]: the kept values of the groups before g (kept slots
        # are ordered by group: a binary search a group boundary)
        kept_seg = torch.where(elem_valid, seg_ids[kept_c],
                               torch.full_like(seg_ids, num_segments))
        offs = searchsorted(kept_seg, torch.arange(
            num_segments + 1, dtype=torch.int32, device=dev), side="left")
        return (runs.out_keys, values, offs.to(torch.int32), elem_valid,
                runs.num_groups, runs.group_live)

    return run
