"""ARRAY kernels over the ragged values+offsets lanes.

Counterpart of spark_rapids_tpu/ops/ragged.py.  A ragged column
(columnar/device.DeviceColumn with `offsets`) is a flat values lane in
its own bucket, an `elem_valid` lane per value and int32 offsets of rows
+ 1; every function here is a composition of segment primitives over
the value -> row map `row_ids` (one binary search a value slot,
ops/search.py): per-row any / min / max by a 1-D scatter into rows + 1
slots (the last one catches the slots past the live values), sorts and
compactions of the values lane by stable sorts, and gathers.  No step
reads a device value on the host, so each runs under whole-plan
capture.  `num_rows` is a host int or a 0-d device tensor.

Orders follow the port's sort lanes (ops/sort.py): a FLOAT value orders
by the total-order image of its value + 0.0 (ops/groupby.float_order:
NaN greatest, -0.0 equal to 0.0), an integral one by itself.
"""
from __future__ import annotations

from typing import Tuple

import dataclasses

import torch

from ..columnar.device import DeviceColumn
from .search import searchsorted


def row_ids(offsets: torch.Tensor, vcap: int) -> torch.Tensor:
    """Owning row (int64) of each values-lane slot; the slots past the
    last live value map to the row capacity (no row)."""
    pos = torch.arange(vcap, dtype=offsets.dtype, device=offsets.device)
    return searchsorted(offsets, pos, side="right") - 1


def _at(lane: torch.Tensor, i) -> torch.Tensor:
    """lane[i] for a host int or a 0-d device index (no host read)."""
    if isinstance(i, torch.Tensor):
        return lane.index_select(0, i.reshape(1).to(torch.int64))[0]
    return lane[int(i)]


def value_live(offsets: torch.Tensor, vcap: int, num_rows) -> torch.Tensor:
    """True for the value slots of live rows (< num_rows)."""
    end = _at(offsets, num_rows)
    return torch.arange(vcap, dtype=offsets.dtype,
                        device=offsets.device) < end


def _lens(col: DeviceColumn) -> torch.Tensor:
    off = col.offsets.to(torch.int64)
    return off[1:] - off[:-1]


def _within(col: DeviceColumn, rid: torch.Tensor) -> torch.Tensor:
    """Each value slot's position inside its row."""
    off = col.offsets.to(torch.int64)
    pos = torch.arange(col.value_capacity, dtype=torch.int64,
                       device=off.device)
    return pos - off[torch.clamp(rid, max=col.capacity)]


def _seg_any(mask: torch.Tensor, rid: torch.Tensor, cap: int
             ) -> torch.Tensor:
    """Per row: any value slot of the row has `mask`."""
    cnt = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    cnt.index_add_(0, rid, mask.to(torch.int32))
    return cnt[:cap] > 0


def _seg_extreme(vals: torch.Tensor, rid: torch.Tensor, cap: int,
                 ident, is_min: bool) -> torch.Tensor:
    out = torch.full((cap + 1,), ident, dtype=vals.dtype,
                     device=vals.device)
    out.scatter_reduce_(0, rid, vals, "amin" if is_min else "amax",
                        include_self=True)
    return out[:cap]


def sizes(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row element count (int32) and the row validity."""
    return _lens(col).to(torch.int32), col.validity


def get_item(col: DeviceColumn, index: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """array[index] (0-based) per row: (values gathered, validity)."""
    off = col.offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    idx = off[:-1] + index
    ok = col.validity & (index >= 0) & (index < lens)
    safe = torch.clamp(idx, 0, col.value_capacity - 1)
    return col.data[safe], ok & col.elem_valid[safe]


def _order_lane(col: DeviceColumn) -> torch.Tensor:
    """int64 lane ordering the values as Spark orders them."""
    data = col.data
    if data.dtype.is_floating_point:
        from .groupby import float_order
        return float_order(data.to(torch.float64) + 0.0)
    return data.to(torch.int64)


def _from_order(col: DeviceColumn, lane: torch.Tensor) -> torch.Tensor:
    if col.data.dtype.is_floating_point:
        from .groupby import float_from_order
        return float_from_order(lane).to(col.data.dtype)
    return lane.to(col.data.dtype)


def contains(col: DeviceColumn, needle, num_rows
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """array_contains(arr, v), Spark's null semantics: a null array gives
    null; true if an element equals v; else null if the array holds a
    null element, false otherwise."""
    vcap, cap = col.value_capacity, col.capacity
    rid = row_ids(col.offsets, vcap)
    live = value_live(col.offsets, vcap, num_rows)
    hit = (col.data == needle) & col.elem_valid & live
    has_hit = _seg_any(hit, rid, cap)
    has_null = _seg_any(~col.elem_valid & live, rid, cap)
    return has_hit, col.validity & (has_hit | ~has_null)


def _segment_minmax(col: DeviceColumn, num_rows, is_min: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """array_min / array_max ignoring null elements; an empty or all-null
    array gives null."""
    vcap, cap = col.value_capacity, col.capacity
    rid = row_ids(col.offsets, vcap)
    live = value_live(col.offsets, vcap, num_rows) & col.elem_valid
    lane = _order_lane(col)
    ident = torch.iinfo(torch.int64).max if is_min \
        else torch.iinfo(torch.int64).min
    vals = torch.where(live, lane, torch.full_like(lane, ident))
    out = _seg_extreme(vals, rid, cap, ident, is_min)
    any_val = _seg_any(live, rid, cap)
    out = torch.where(any_val, out, torch.zeros_like(out))
    return _from_order(col, out), col.validity & any_val


def array_min(col: DeviceColumn, num_rows):
    return _segment_minmax(col, num_rows, True)


def array_max(col: DeviceColumn, num_rows):
    return _segment_minmax(col, num_rows, False)


def _permuted(col: DeviceColumn, perm: torch.Tensor, offsets=None,
              elem_valid=None) -> DeviceColumn:
    return dataclasses.replace(
        col, data=col.data[perm],
        offsets=col.offsets if offsets is None else offsets,
        elem_valid=col.elem_valid[perm] if elem_valid is None
        else elem_valid)


def sort_within(col: DeviceColumn, num_rows, asc: bool = True
                ) -> DeviceColumn:
    """sort_array: each row's elements ordered, nulls first ascending and
    last descending (Spark's SortArray); ties keep their order."""
    from .segments import lexsort_capped
    vcap = col.value_capacity
    rid = row_ids(col.offsets, vcap)
    live = value_live(col.offsets, vcap, num_rows)
    lane = _order_lane(col)
    if not asc:
        lane = ~lane
    lane = torch.where(col.elem_valid, lane, torch.zeros_like(lane))
    null_lane = (col.elem_valid if asc else ~col.elem_valid).to(torch.int8)
    # np.lexsort order: liveness, row, nulls, value (most minor first)
    perm = lexsort_capped([lane, null_lane, rid, (~live).to(torch.int8)])
    return _permuted(col, perm)


def filter_values(col: DeviceColumn, keep_vals: torch.Tensor, num_rows
                  ) -> DeviceColumn:
    """The higher-order filter: the values where `keep_vals` holds, in
    their order; offsets from each row's surviving count."""
    vcap, cap = col.value_capacity, col.capacity
    rid = row_ids(col.offsets, vcap)
    live = value_live(col.offsets, vcap, num_rows)
    keep = keep_vals & live
    # a stable compaction: kept slots first, in position order
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
    counts.index_add_(0, rid, keep.to(torch.int64))
    new_off = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
    new_off[1:] = torch.cumsum(counts[:cap], 0)
    n_kept = new_off[-1]
    ev = col.elem_valid[order] & (torch.arange(
        vcap, dtype=torch.int64, device=keep.device) < n_kept)
    return _permuted(col, order, new_off.to(torch.int32), ev)


def map_element_at(keys: DeviceColumn, values: DeviceColumn, needle,
                   num_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """element_at(map, key) over a shattered map (two ragged lanes with
    the same offsets): per row the value whose key equals `needle`, null
    when absent or the map is null.  Spark keeps the LAST of duplicate
    keys, so the highest matching slot wins."""
    vcap = keys.value_capacity
    rid = row_ids(keys.offsets, vcap)
    live = value_live(keys.offsets, vcap, num_rows)
    hit = (keys.data == needle) & keys.elem_valid & live
    slot = torch.where(hit, torch.arange(vcap, dtype=torch.int64,
                                         device=hit.device),
                       torch.full((vcap,), -1, dtype=torch.int64,
                                  device=hit.device))
    best = _seg_extreme(slot, rid, keys.capacity, -1, False)
    found = best >= 0
    safe = torch.clamp(best, 0, values.value_capacity - 1)
    return values.data[safe], \
        keys.validity & found & values.elem_valid[safe]


def element_at(col: DeviceColumn, index: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """element_at(arr, i): 1-based, a negative index from the end (Spark
    ElementAt over arrays); out of range gives null."""
    off = col.offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    if index >= 0:
        pos = torch.full_like(lens, index - 1)
        ok = col.validity & (index >= 1) & (pos < lens)
    else:
        pos = lens + index
        ok = col.validity & (pos >= 0)
    safe = torch.clamp(off[:-1] + pos, 0, col.value_capacity - 1)
    return col.data[safe], ok & col.elem_valid[safe]


def position(col: DeviceColumn, needle, num_rows
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """array_position(arr, v): the 1-based first match, 0 when absent,
    null for a null array (Spark)."""
    vcap = col.value_capacity
    rid = row_ids(col.offsets, vcap)
    live = value_live(col.offsets, vcap, num_rows)
    hit = (col.data == needle) & col.elem_valid & live
    within = _within(col, rid)
    first = _seg_extreme(torch.where(hit, within, torch.full_like(
        within, vcap)), rid, col.capacity, vcap, True)
    data = torch.where(first < vcap, first + 1, torch.zeros_like(first))
    return data, col.validity


def slice_rows(col: DeviceColumn, start: int, length: int, num_rows
               ) -> DeviceColumn:
    """slice(arr, start, length): 1-based start, a negative start from the
    end (Spark Slice; a start before the array gives it empty)."""
    vcap, cap = col.value_capacity, col.capacity
    rid = row_ids(col.offsets, vcap)
    lens = _lens(col)
    within = _within(col, rid)
    if start >= 0:
        lo = torch.full((cap + 1,), start - 1, dtype=torch.int64,
                        device=lens.device)
        oob = torch.zeros(cap + 1, dtype=torch.bool, device=lens.device)
    else:
        raw_lo = torch.cat([lens, lens[:1]]) + start
        oob = raw_lo < 0
        lo = torch.clamp(raw_lo, min=0)
    lo_v = lo[rid]
    keep = (within >= lo_v) & (within < lo_v + length) & ~oob[rid]
    return filter_values(col, keep, num_rows)


def reverse_rows(col: DeviceColumn, num_rows) -> DeviceColumn:
    """reverse(arr): each row's elements reversed, one gather, the
    offsets unchanged."""
    vcap = col.value_capacity
    rid = row_ids(col.offsets, vcap)
    off = col.offsets.to(torch.int64)
    r = torch.clamp(rid, max=col.capacity - 1)
    lens = off[1:] - off[:-1]
    within = _within(col, rid)
    src = off[:-1][r] + lens[r] - 1 - within
    live = value_live(col.offsets, vcap, num_rows)
    safe = torch.clamp(torch.where(live, src, torch.arange(
        vcap, dtype=torch.int64, device=off.device)), 0, vcap - 1)
    return _permuted(col, safe)
