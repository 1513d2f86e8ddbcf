"""Group-by building blocks and the no-key reduction.

Counterpart of spark_rapids_tpu/ops/groupby.py:

  * `AggSpec` and the aggregate kinds (shared with plan/aggregates.py);
  * `_packed_key_lane`: bounded keys folded into one int64 bucket lane;
  * `_bits_total_order` / `_bits_from_order`: the monotone int64 image
    of f64 bit patterns (Java Double.compare order), which the float
    MIN/MAX paths reduce in;
  * `groupby_trace`: the sort-based group-by (ops/segments
    `sorted_segments` lexsorts the key lanes and finds the runs, then
    every aggregate is a segmented scan read at the run ends —
    `sorted_agg_outputs`); a `pack_spec` folds bounded keys into one
    sort lane.  Groups come out in ascending key order, nulls first, as
    in the reference;
  * `reduce_trace`: the no-key aggregation (TPC-H q6).

  * `dense_groupby_trace`: the no-sort group-by of keys whose domains
    are all small and static (dictionary codes, booleans): a mixed-radix
    bucket id per row and one scatter reduction per aggregate into the
    buckets (`_batched_sums` for the sum family), occupied buckets
    compacted to the front in bucket order.

The reference's `segments.scatterFree.enabled=false` reductions are not
ported: the sorted-run reductions give the same results.  With a full
pack the reference dispatches to `packed_groupby_trace`, whose groups,
order and sums equal the generic path's over the one packed lane, which
is what runs here.

Float MIN/MAX order -0.0 below +0.0 and NaN above +inf, as the
reference's XLA reductions and its CPU oracle do; torch's own min/max
leave the ±0.0 tie to argument order, so floats reduce in the total-
order image instead.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import types as t
from .kernels import compute_view
from .segments import (blocked_seg_scan, seg_reduce_sorted, seg_sums_sorted,
                       sorted_segments)

SUM = "sum"
COUNT = "count"          # counts valid rows
COUNT_ALL = "count_all"  # counts live rows (count(*) / count(1))
MIN = "min"
MAX = "max"
FIRST = "first"          # first live row's value (Spark ignoreNulls=false)
LAST = "last"
FIRST_NN = "first_nn"    # first non-null (ignoreNulls=true)
LAST_NN = "last_nn"
ANY = "any"              # boolean or
EVERY = "every"          # boolean and


@dataclasses.dataclass(frozen=True)
class AggSpec:
    kind: str
    input_idx: int                 # index into the agg-input column list
    dtype: object                  # logical result type (t.DataType)


_EXP_MASK = 0x7FF0000000000000
_MANT_MASK = 0x000FFFFFFFFFFFFF
_CANON_NAN = 0x7FF8000000000000
_ORDER_MAX = 2 ** 63 - 1            # unreachable after NaN canonicalization
_ORDER_MIN = -2 ** 63


def _bits_total_order(b: torch.Tensor) -> torch.Tensor:
    """Monotone int64 mapping of f64 bit patterns (Java Double.compare):
    -inf < ... < -0.0 < 0.0 < ... < +inf < NaN.  NaN bits canonicalize
    first so the int64 extremes stay free for masking identities."""
    is_nan = ((b & _EXP_MASK) == _EXP_MASK) & ((b & _MANT_MASK) != 0)
    b = torch.where(is_nan, torch.full_like(b, _CANON_NAN), b)
    # for negative b, INT64_MAX - b == b ^ INT64_MAX (flip all but sign)
    return torch.where(b >= 0, b, b ^ _ORDER_MAX)


def _bits_from_order(o: torch.Tensor) -> torch.Tensor:
    return torch.where(o >= 0, o, o ^ _ORDER_MAX)


def float_order(x: torch.Tensor) -> torch.Tensor:
    """float64 values -> their total-order int64 image."""
    return _bits_total_order(x.contiguous().view(torch.int64))


def float_from_order(o: torch.Tensor) -> torch.Tensor:
    return _bits_from_order(o).contiguous().view(torch.float64)


def _packed_key_lane(keys, keys_valid, pack_spec) -> torch.Tensor:
    """Fold the statically-bounded keys into ONE int64 lane (slot 0 per
    key = null; values offset by -lo+1)."""
    packed = None
    for i, spec in enumerate(pack_spec):
        if spec is None:
            continue
        lo, span = spec
        slot = torch.clamp(keys[i].to(torch.int64) - lo + 1, 0, span - 1)
        kv = keys_valid[i]
        if kv is not None:
            slot = torch.where(kv, slot, torch.zeros_like(slot))
        packed = slot if packed is None else packed * span + slot
    return packed


def _null_first_key_lanes(data, valid, dt):
    """Lanes making (valid, data) lexsort-comparable, nulls grouped
    together first: [null lane or None, value lane(s)].  DOUBLE adds a
    NaN lane (NaN compares as one group) and folds -0.0 into 0.0."""
    if valid is None:
        valid_lane = None
    else:
        valid_lane = (~valid).to(torch.int8)
        # null rows' payload canonicalised so they compare equal
        data = torch.where(valid, data, torch.zeros_like(data))
    if isinstance(dt, t.DoubleType) and data.dtype == torch.float64:
        isnan = torch.isnan(data)
        canon = torch.where(isnan, torch.full_like(data, float("inf")), data)
        canon = torch.where(canon == 0.0, torch.zeros_like(canon), canon)
        return [valid_lane, isnan.to(torch.int8), canon]
    return [valid_lane, data]


def _eq_prev(lane: torch.Tensor) -> torch.Tensor:
    """Boundary lane: True where a row differs from the previous one."""
    head = torch.ones(1, dtype=torch.bool, device=lane.device)
    return torch.cat([head, lane[1:] != lane[:-1]])


def sum_lane_key(spec: AggSpec, si: int) -> tuple:
    """The key of spec `si`'s sum-like lane.  Specs that sum the same
    lane share it: COUNT(*) the live rows, COUNT its input's valid count
    (the ("vc", input) lane every other spec's validity reads), SUM its
    input in one type."""
    if spec.kind == COUNT_ALL:
        return ("all",)
    if spec.kind == COUNT:
        return ("vc", spec.input_idx)
    return ("sum", spec.input_idx, spec.dtype)


def _queue_sum_lanes(agg_specs, spec_vls, live_all):
    """Every sum-like lane (SUM buffers, COUNT/COUNT_ALL, per-input valid
    counts) in two dtype-class lists, each lane once (`sum_lane_key`).
    Returns (int_lanes, int_slots, f64_lanes, f64_slots)."""
    int_lanes, int_slots = [], {}
    f64_lanes, f64_slots = [], {}

    def queue(key, lane, is_float):
        lanes_, slots = (f64_lanes, f64_slots) if is_float \
            else (int_lanes, int_slots)
        if key not in slots:
            slots[key] = len(lanes_)
            lanes_.append(lane)

    for si, spec in enumerate(agg_specs):
        d, vl = spec_vls[si]
        dt = spec.dtype
        key = sum_lane_key(spec, si)
        if key in int_slots or key in f64_slots:
            pass
        elif spec.kind == COUNT_ALL:
            queue(key, live_all.to(torch.int64), False)
        elif spec.kind == COUNT:
            queue(key, vl.to(torch.int64), False)
        elif spec.kind == SUM:
            cd = compute_view(d, dt)
            if t.is_floating(dt):
                x = cd.to(torch.float64)
                queue(key, torch.where(vl, x, torch.zeros_like(x)), True)
            else:
                x = cd.to(torch.int64)
                queue(key, torch.where(vl, x, torch.zeros_like(x)), False)
        if spec.kind not in (COUNT, COUNT_ALL):
            queue(("vc", spec.input_idx), vl.to(torch.int64), False)
    return int_lanes, int_slots, f64_lanes, f64_slots


def _segment_minmax_float_sorted(vals, valid_live, boundary, ends_c,
                                 is_min: bool):
    """Java-ordering float MIN/MAX over sorted runs, through the int64
    total-order image: NaN above +inf (so MIN is NaN only when every
    valid value is, MAX whenever one is) and -0.0 below 0.0, the order
    the reference's MIN/MAX give its DOUBLE columns."""
    o = float_order(vals.to(torch.float64))
    o = torch.where(valid_live, o,
                    torch.full_like(o, _ORDER_MAX if is_min else _ORDER_MIN))
    red = seg_reduce_sorted(o, boundary, ends_c,
                            torch.minimum if is_min else torch.maximum)
    return float_from_order(red).to(vals.dtype)


def sorted_agg_outputs(agg_specs, spec_vls, s_live, boundary, starts_c,
                       ends_c, group_live, capacity: int):
    """Aggregate outputs over SORTED runs: spec_vls holds per spec the
    (data, valid & live) lanes in sorted order; boundary marks run
    starts; starts_c/ends_c give each segment slot's first/last row.
    Integer sums are a cumsum difference (exact mod 2^64), float64 sums
    a segmented scan (each group accumulates on its own), MIN/MAX/
    ignore-null FIRST/LAST/ANY/EVERY segmented scans read at run ends,
    FIRST/LAST pure boundary gathers."""
    dev = s_live.device
    iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    starts_l, ends_l = starts_c.long(), ends_c.long()

    def reduce_lane(lane, is_min):
        return seg_reduce_sorted(lane, boundary, ends_c,
                                 torch.minimum if is_min else torch.maximum)

    int_lanes, int_slots, f64_lanes, f64_slots = _queue_sum_lanes(
        agg_specs, spec_vls, s_live)
    int_out = seg_sums_sorted(int_lanes, starts_c, ends_c) \
        if int_lanes else None
    f64_out = blocked_seg_scan(torch.stack(f64_lanes, dim=1), boundary,
                               torch.add)[ends_l] if f64_lanes else None

    def sum_of(key, is_float):
        return (f64_out[:, f64_slots[key]] if is_float
                else int_out[:, int_slots[key]])

    outs = []
    for si, spec in enumerate(agg_specs):
        d, vl = spec_vls[si]
        dt = spec.dtype
        if spec.kind in (COUNT, COUNT_ALL):
            outs.append((sum_of(sum_lane_key(spec, si), False), group_live))
            continue
        valid_count = sum_of(("vc", spec.input_idx), False)
        out_valid = (valid_count > 0) & group_live
        cd = compute_view(d, dt)
        if spec.kind == SUM:
            data = sum_of(sum_lane_key(spec, si), t.is_floating(dt))
        elif spec.kind == FIRST:
            # runs hold only live rows (liveness is the primary sort lane)
            data = cd[starts_l]
            out_valid = vl[starts_l] & group_live
        elif spec.kind == LAST:
            data = cd[ends_l]
            out_valid = vl[ends_l] & group_live
        elif spec.kind in (MIN, MAX):
            is_min = spec.kind == MIN
            if t.is_floating(dt):
                data = _segment_minmax_float_sorted(cd, vl, boundary, ends_c,
                                                    is_min)
            elif isinstance(dt, t.BooleanType):
                data = reduce_lane(torch.where(vl, cd, torch.full_like(
                    cd, is_min)).to(torch.int8), is_min) > 0
            else:
                ident = _int_ident(cd.dtype, is_min)
                data = reduce_lane(torch.where(vl, cd, torch.full_like(
                    cd, ident)), is_min)
        elif spec.kind in (FIRST_NN, LAST_NN):
            is_first = spec.kind == FIRST_NN
            none = capacity if is_first else -1
            masked = torch.where(vl, iota, torch.full_like(iota, none))
            raw = reduce_lane(masked, is_first)
            pick = torch.clamp(raw, 0, capacity - 1).long()
            data = cd[pick]
            # a group with no non-null row is null, whatever the clamped
            # row holds
            out_valid = vl[pick] & (raw != none) & group_live
        elif spec.kind == ANY:
            data = reduce_lane((cd & vl).to(torch.int8), False) > 0
        elif spec.kind == EVERY:
            data = reduce_lane((cd | ~vl).to(torch.int8), True) > 0
        else:
            raise ValueError(f"unknown agg kind {spec.kind}")
        outs.append((data, out_valid))
    return outs


def groupby_trace(key_lanes_info, agg_specs, num_segments: int,
                  capacity: int, pack_spec=None):
    """The sort-based group-by: fn(keys_data, keys_valid, agg_data,
    agg_valid, live) -> (per key (data, valid), per spec (data, valid),
    num_groups 0-d tensor), outputs (num_segments,)-sized with the groups
    first in ascending key order (nulls first).

    key_lanes_info: per key (logical dtype, has_validity, torch dtype of
    its lane).  pack_spec: optional per-key (lo, span) or None — keys
    with exact static bounds fold into one packed sort lane
    (_packed_key_lane).  `live` is an arbitrary row mask (fused filters),
    not a prefix count."""
    from .filter import grouped_take

    def run(keys, keys_valid, agg_data, agg_valid, live):
        dev = live.device
        runs = sorted_segments(key_lanes_info, keys, keys_valid, live,
                               capacity, num_segments, pack_spec)
        # aggregates over the sorted runs
        need = sorted({s.input_idx for s in agg_specs if s.input_idx >= 0})
        in_lanes = []
        for i in need:
            v = agg_valid[i]
            in_lanes.append(agg_data[i])
            in_lanes.append(torch.ones(capacity, dtype=torch.bool,
                                       device=dev) if v is None else v)
        moved = grouped_take(in_lanes, runs.perm)
        s_in = {i: (moved[2 * j], moved[2 * j + 1] & runs.s_live)
                for j, i in enumerate(need)}
        spec_vls = [s_in[s.input_idx] if s.input_idx >= 0
                    else (None, runs.s_live) for s in agg_specs]
        outs = sorted_agg_outputs(agg_specs, spec_vls, runs.s_live,
                                  runs.boundary, runs.start_idx, runs.end_idx,
                                  runs.group_live, capacity)
        return runs.out_keys, outs, runs.num_groups

    return run


def _int_ident(dtype: torch.dtype, is_min: bool):
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def reduce_trace(agg_specs, capacity: int):
    """No-key aggregation: fn(agg_data, agg_valid, live) -> per spec a
    (0-d data, 0-d valid) pair.  `live` is an arbitrary row mask."""
    def run(agg_data, agg_valid, live):
        outs = []
        dev = live.device
        for spec in agg_specs:
            d = agg_data[spec.input_idx] if spec.input_idx >= 0 else None
            v = agg_valid[spec.input_idx] if spec.input_idx >= 0 else None
            vl = live if d is None or v is None else (v & live)
            dt = spec.dtype
            if spec.kind in (COUNT, COUNT_ALL):
                outs.append((vl.sum(dtype=torch.int64),
                             torch.ones((), dtype=torch.bool, device=dev)))
                continue
            valid = vl.any()
            cd = compute_view(d, dt)
            if spec.kind == SUM:
                acc = cd.to(torch.float64 if t.is_floating(dt)
                            else torch.int64)
                data = torch.where(vl, acc, torch.zeros_like(acc)).sum()
            elif spec.kind in (MIN, MAX):
                is_min = spec.kind == MIN
                if t.is_floating(dt):
                    # NaN > +inf and -0.0 < 0.0 fall out of the order
                    o = float_order(cd.to(torch.float64))
                    ident = _ORDER_MAX if is_min else _ORDER_MIN
                    o = torch.where(vl, o, torch.full_like(o, ident))
                    red = o.min() if is_min else o.max()
                    data = float_from_order(red.reshape(1))[0].to(cd.dtype)
                elif isinstance(dt, t.BooleanType):
                    acc = torch.where(vl, cd, torch.full_like(cd, is_min))
                    data = acc.all() if is_min else acc.any()
                else:
                    ident = _int_ident(cd.dtype, is_min)
                    acc = torch.where(vl, cd, torch.full_like(cd, ident))
                    data = acc.min() if is_min else acc.max()
            elif spec.kind in (FIRST, LAST, FIRST_NN, LAST_NN):
                idx = torch.arange(capacity, dtype=torch.int32, device=dev)
                is_first = spec.kind in (FIRST, FIRST_NN)
                sel = vl if spec.kind in (FIRST_NN, LAST_NN) else live
                masked = torch.where(
                    sel, idx, torch.full_like(idx, capacity if is_first
                                              else -1))
                pick = masked.min() if is_first else masked.max()
                pick = torch.clamp(pick, 0, capacity - 1).to(torch.int64)
                data = cd[pick]
                valid = vl[pick]
            elif spec.kind == ANY:
                data = (cd & vl).any()
            elif spec.kind == EVERY:
                data = (cd | ~vl).all()
            else:
                raise ValueError(spec.kind)
            outs.append((data, valid))
        return outs

    return run


def _segment_reduce(lane: torch.Tensor, seg: torch.Tensor, num_segments: int,
                    is_min: bool) -> torch.Tensor:
    """Per-bucket MIN or MAX of an integer lane (`scatter_reduce_`
    starting from the dtype's identity, so an empty bucket keeps it)."""
    out = torch.full((num_segments,), _int_ident(lane.dtype, is_min),
                     dtype=lane.dtype, device=lane.device)
    return out.scatter_reduce_(0, seg, lane, "amin" if is_min else "amax")


def _batched_sums(agg_specs, spec_vls, live_all, seg, num_segments: int,
                  reindex):
    """Every sum-like lane in one (N, K) scatter-add per dtype class, as
    the reference's `_batched_sums` does with one wide `segment_sum`.
    spec_vls: per spec (data, valid & live); live_all: the COUNT(*) lane;
    reindex maps the (num_segments, K) sums onto the caller's group
    order.  On the CPU `index_add_` adds the rows in order, the
    reference's CPU scatter order; on a card float64 sums are atomics in
    run-dependent order (the `variableFloatAgg` latitude), integer sums
    exact.  Returns sum_of(key, is_float) -> (G,) lane."""
    int_lanes, int_slots, f64_lanes, f64_slots = _queue_sum_lanes(
        agg_specs, spec_vls, live_all)

    def summed(lanes, dtype):
        if not lanes:
            return None
        src = torch.stack(lanes, dim=1)
        out = torch.zeros((num_segments, src.shape[1]), dtype=dtype,
                          device=src.device)
        return reindex(out.index_add_(0, seg, src))

    int_out = summed(int_lanes, torch.int64)
    f64_out = summed(f64_lanes, torch.float64)

    def sum_of(key, is_float):
        return (f64_out[:, f64_slots[key]] if is_float
                else int_out[:, int_slots[key]])
    return sum_of


def dense_groupby_trace(domain_sizes, agg_specs, capacity: int):
    """The bounded-domain group-by with no sort and no row gather: every
    key has a small static domain (codes in [0, size)), rows map to a
    dense bucket id (a mixed radix over the keys, one extra slot per key
    for null, dead rows in bucket D) and each aggregate is one scatter
    reduction into the buckets.  Returns fn(keys, keys_valid, agg_data,
    agg_valid, live) with groupby_trace's contract: (D,)-sized outputs,
    the occupied buckets first in bucket order (keys ascending, a null
    key after its values), keys decoded from the bucket id.

    Float MIN/MAX reduce in the int64 total-order image (NaN above
    +inf, -0.0 below 0.0), as the sorted group-by does."""
    strides = []
    d_total = 1
    for size in reversed(domain_sizes):
        strides.append(d_total)
        d_total *= size + 1                       # +1: the null slot
    strides.reverse()
    D = d_total
    ns = D + 1

    def run(keys, keys_valid, agg_data, agg_valid, live):
        dev = live.device
        comb = torch.zeros(capacity, dtype=torch.int64, device=dev)
        for size, stride, kd, kv in zip(domain_sizes, strides, keys,
                                        keys_valid):
            slot = torch.clamp(kd.to(torch.int64), 0, size - 1)
            if kv is not None:
                slot = torch.where(kv, slot, torch.full_like(slot, size))
            comb = comb + slot * stride
        seg = torch.where(live, comb, torch.full_like(comb, D))
        occupied = torch.bincount(seg, minlength=ns)[:D] > 0
        num_groups = occupied.sum(dtype=torch.int32)
        # the occupied buckets to the front, stably (bucket order)
        order = torch.argsort((~occupied).to(torch.int8), stable=True)
        group_live = torch.arange(D, device=dev) < num_groups

        out_keys = []
        for size, stride, kd in zip(domain_sizes, strides, keys):
            slot = torch.div(order, stride, rounding_mode="floor") % \
                (size + 1)
            okv = (slot < size) & group_live
            # a null key's lane is 0, never the null slot (a code past
            # the dictionary's end)
            out_keys.append((torch.where(okv, slot, torch.zeros_like(slot))
                             .to(kd.dtype), okv))

        def regroup(a):
            return a[:D][order]

        spec_vls = []
        for spec in agg_specs:
            if spec.input_idx >= 0:
                v = agg_valid[spec.input_idx]
                spec_vls.append((agg_data[spec.input_idx],
                                 live if v is None else v & live))
            else:
                spec_vls.append((None, live))
        sum_of = _batched_sums(agg_specs, spec_vls, live, seg, ns, regroup)

        outs = []
        for si, spec in enumerate(agg_specs):
            d, vl = spec_vls[si]
            dt = spec.dtype
            if spec.kind in (COUNT, COUNT_ALL):
                outs.append((sum_of(sum_lane_key(spec, si), False), group_live))
                continue
            out_valid = (sum_of(("vc", spec.input_idx), False) > 0) & \
                group_live
            cd = compute_view(d, dt)
            if spec.kind == SUM:
                data = sum_of(sum_lane_key(spec, si), t.is_floating(dt))
            elif spec.kind in (MIN, MAX):
                is_min = spec.kind == MIN
                if t.is_floating(dt):
                    o = float_order(cd.to(torch.float64))
                    o = torch.where(vl, o, torch.full_like(
                        o, _ORDER_MAX if is_min else _ORDER_MIN))
                    data = float_from_order(regroup(_segment_reduce(
                        o, seg, ns, is_min))).to(cd.dtype)
                elif isinstance(dt, t.BooleanType):
                    acc = torch.where(vl, cd, torch.full_like(cd, is_min))
                    data = regroup(_segment_reduce(
                        acc.to(torch.int32), seg, ns, is_min)) > 0
                else:
                    acc = torch.where(vl, cd, torch.full_like(
                        cd, _int_ident(cd.dtype, is_min))).to(torch.int64)
                    data = regroup(_segment_reduce(
                        acc, seg, ns, is_min)).to(cd.dtype)
            elif spec.kind in (FIRST, LAST, FIRST_NN, LAST_NN):
                is_first = spec.kind in (FIRST, FIRST_NN)
                sel = vl if spec.kind in (FIRST_NN, LAST_NN) else live
                none = capacity if is_first else -1
                idx = torch.arange(capacity, dtype=torch.int64, device=dev)
                masked = torch.where(sel, idx, torch.full_like(idx, none))
                raw = regroup(_segment_reduce(masked, seg, ns, is_first))
                pick = torch.clamp(raw, 0, capacity - 1)
                data = cd[pick]
                out_valid = vl[pick] & (raw != none) & group_live
            elif spec.kind == ANY:
                data = regroup(_segment_reduce(
                    (cd & vl).to(torch.int32), seg, ns, False)) > 0
            elif spec.kind == EVERY:
                data = regroup(_segment_reduce(
                    (cd | ~vl).to(torch.int32), seg, ns, True)) > 0
            else:
                raise ValueError(f"unknown agg kind {spec.kind}")
            outs.append((data, out_valid))
        return out_keys, outs, num_groups

    return run
