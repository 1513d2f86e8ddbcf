"""Segmented reductions over sorted runs and the chained lexsort.

Counterpart of spark_rapids_tpu/ops/segments.py for what the sorted
group-by needs.  Every holistic operator reduces over CONTIGUOUS RUNS
of a sorted batch; a run's reduction is a segmented scan read at the
run's last row (scan + gather, no scatter):

  * `blocked_seg_scan`: the segmented inclusive scan, in the reference's
    exact shape (512-row blocks scanned by log-step doubling, block
    totals scanned the same way, a carry into each block), so float64
    sums associate exactly as the reference's do;
  * `seg_reduce_sorted`, `seg_sums_sorted` (int64 cumsum difference,
    exact mod 2^64), `row0_true`, `op_identity`, `segment_ends`;
  * `lexsort_capped`: `np.lexsort` semantics (LAST lane primary) as a
    chain of stable single-key `torch.sort`s, most minor lane first.
    The reference caps each emitted sort's operand count for TPU
    compile time; torch sorts one key at a time, so every sort here is
    already within any cap and the result is the same permutation;
  * `sorted_segments`: the sort-segment core — the keys' lexsort, the
    run boundaries, each run's first and last row and its group key —
    that `ops/groupby.groupby_trace` and `ops/distinct.py` reduce over;
    its minor lanes order rows within a group, and `pack_minor_spec`
    folds bounded ones into the group keys' single sort lane.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

_SEG_BLOCK = 512
_SEG_MIN = 4096


def op_identity(op, dtype: torch.dtype):
    """Identity element of a scan combiner (torch.add / torch.minimum /
    torch.maximum) over `dtype` lanes."""
    if op is torch.add:
        return False if dtype == torch.bool else 0
    if dtype == torch.bool:
        # minimum == logical and (ident True), maximum == or (ident False)
        return op is torch.minimum
    if dtype.is_floating_point:
        return float("inf") if op is torch.minimum else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op is torch.minimum else info.min


def _shift(v: torch.Tensor, step: int, fill, dim: int) -> torch.Tensor:
    """`v` moved `step` places along `dim`, the front filled with `fill`."""
    pad_shape = list(v.shape)
    pad_shape[dim] = step
    pad = torch.full(pad_shape, fill, dtype=v.dtype, device=v.device)
    return torch.cat([pad, v.narrow(dim, 0, v.shape[dim] - step)], dim=dim)


def _doubling_seg_scan(v, f, length: int, op, ident, dim: int):
    """Hillis-Steele inclusive segmented scan along `dim` over the
    (value, boundary-flag) monoid: log2(length) shift+combine steps."""
    step = 1
    while step < length:
        pv = _shift(v, step, ident, dim)
        pf = _shift(f, step, False, dim)
        fb = f if f.dim() == v.dim() else f.unsqueeze(-1)
        v = torch.where(fb, v, op(pv, v))
        f = f | pf
        step <<= 1
    return v, f


def blocked_seg_scan(vals: torch.Tensor, boundary: torch.Tensor, op,
                     ident=None) -> torch.Tensor:
    """Segmented INCLUSIVE scan along dim 0 that resets where `boundary`
    is True.  `vals` is (n,) or (n, k) with one boundary lane shared by
    all k columns."""
    n = vals.shape[0]
    if ident is None:
        ident = op_identity(op, vals.dtype)
    if n < _SEG_MIN or n % _SEG_BLOCK != 0:
        v, _f = _doubling_seg_scan(vals, boundary, n, op, ident, 0)
        return v
    nb = n // _SEG_BLOCK
    v = vals.reshape((nb, _SEG_BLOCK) + tuple(vals.shape[1:]))
    f = boundary.reshape(nb, _SEG_BLOCK)
    v, f = _doubling_seg_scan(v, f, _SEG_BLOCK, op, ident, 1)
    # cross-block carry: exclusive segmented scan of the block totals; a
    # block's carry only reaches rows before its first boundary, exactly
    # where the scanned in-block flag is still False
    tv, tf = v[:, -1], f[:, -1]
    cv, _cf = _doubling_seg_scan(tv, tf, nb, op, ident, 0)
    carry = _shift(cv, 1, ident, 0).unsqueeze(1)
    fb = f if f.dim() == v.dim() else f.unsqueeze(-1)
    return torch.where(fb, v, op(carry, v)).reshape(vals.shape)


def seg_reduce_sorted(vals: torch.Tensor, boundary: torch.Tensor,
                      ends_c: torch.Tensor, op, ident=None) -> torch.Tensor:
    """Per-segment reduction over sorted runs: the segmented scan's value
    at each run's last row (`ends_c`: segment slot -> last row)."""
    return blocked_seg_scan(vals, boundary, op, ident)[ends_c.long()]


def seg_sums_sorted(lanes: Sequence[torch.Tensor], starts_c: torch.Tensor,
                    ends_c: torch.Tensor) -> torch.Tensor:
    """(num_segments, k) per-segment sums of int64 lanes over sorted runs:
    one cumsum per lane and two boundary gathers.  int64 wraparound
    cancels in the difference, so this is exact whenever the segment sum
    fits int64.  Each lane scans as its own 1-D tensor, which PyTorch
    hands to cub's device-wide scan; a scan along a dimension of a 2-D
    stack runs one block per row or column on the card (q3 at SF10 on an
    H100: 9.4 s along dim 0 of (n, k), 123 ms along dim 1 of (k, n))."""
    cs = torch.stack([torch.cumsum(lane, 0) for lane in lanes])
    starts_c = starts_c.long()
    hi = cs[:, ends_c.long()]
    lo = torch.where(starts_c > 0, cs[:, torch.clamp(starts_c - 1, min=0)],
                     torch.zeros_like(hi))
    return (hi - lo).t()


def row0_true(capacity: int, device=None) -> torch.Tensor:
    """Boundary-lane seed: True at row 0."""
    out = torch.zeros(capacity, dtype=torch.bool, device=device)
    out[:1] = True
    return out


def lexsort_capped(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation in `np.lexsort` order (the LAST lane is the
    primary key): stable single-key sorts chained through the running
    permutation, most minor lane first."""
    lanes = list(lanes)
    assert lanes, "lexsort of zero lanes"
    perm = None
    for lane in lanes:
        if lane.dtype == torch.bool:
            lane = lane.to(torch.int8)
        key = lane if perm is None else lane[perm]
        step = torch.sort(key, stable=True).indices
        perm = step if perm is None else perm[step]
    return perm


def segment_ends(start_raw: torch.Tensor, count, capacity: int
                 ) -> torch.Tensor:
    """Per segment-slot last-row index from the slot-ordered UNCLIPPED
    starts (dead slots carry the `capacity` sentinel): the next slot's
    start - 1, clipped into the live prefix."""
    nexts = torch.cat([start_raw[1:], torch.full(
        (1,), capacity, dtype=start_raw.dtype, device=start_raw.device)])
    return torch.clamp(torch.minimum(nexts - 1, count - 1), 0, capacity - 1)


# ---------------------------------------------------------------------------
# sorted_segments: the sort-segment core of the sorted group-by
# ---------------------------------------------------------------------------

class SegRuns(NamedTuple):
    """Sorted-run structure of a group-by: the row permutation, liveness
    in sorted order, the run-start boundary lane, per segment-slot
    first/last row (clipped), per key the (data, valid) of each group,
    the live-group count and the segment-slot mask."""
    perm: torch.Tensor
    s_live: torch.Tensor
    boundary: torch.Tensor
    start_idx: torch.Tensor
    end_idx: torch.Tensor
    out_keys: list
    num_groups: torch.Tensor
    group_live: torch.Tensor


def pack_minor_spec(minor_lanes, minor_spec):
    """Fold statically bounded minor lanes into (packed lane, span), or
    (None, 1) when any lane is unbounded.  minor_spec entries are (lo,
    span) with every lane value in [lo, lo + span); minor_lanes come
    most-minor FIRST, so lane i's stride is the span product of the lanes
    minor to it and the packed integer order IS the lexsort order."""
    if minor_spec is None or len(minor_spec) != len(minor_lanes) or \
            any(s is None for s in minor_spec):
        return None, 1
    total = 1
    for _lo, span in minor_spec:
        total *= int(span)
    if total >= (1 << 31):
        return None, 1
    packed = None
    stride = 1
    for lane, (lo, span) in zip(minor_lanes, minor_spec):
        slot = torch.clamp(lane.to(torch.int64) - int(lo), 0, int(span) - 1)
        packed = slot * stride if packed is None else packed + slot * stride
        stride *= int(span)
    return packed, total


def sorted_segments(key_lanes_info, keys, keys_valid, live, capacity: int,
                    num_segments: int, pack_spec=None, minor_lanes=(),
                    minor_spec=None) -> SegRuns:
    """Order rows by (dead last, group keys, minor lanes) and find the
    group runs.  Keys with a `pack_spec` entry (lo, span) fold into one
    packed sort lane (ops/groupby._packed_key_lane), the others sort by
    their null-first lanes; a run opens wherever a key lane or liveness
    changes, so the first padding row opens its own dead run.  Each
    group's key is its run's first row.

    `minor_lanes` (most-minor first) order the rows WITHIN a group and
    open no run: count-distinct's value and null lanes.  When every key
    packs and `minor_spec` bounds every minor lane (pack_minor_spec),
    keys, liveness and minor lanes fold into ONE int64 lane and the
    whole order is one sort, as the reference's packed path."""
    from .filter import grouped_take, take_keys_valid
    from .groupby import _eq_prev, _null_first_key_lanes, _packed_key_lane
    from .kernels import compute_view
    dev = live.device
    packed_idx = {i for i, s in enumerate(pack_spec or []) if s is not None}
    lanes: List[torch.Tensor] = []
    if packed_idx:
        lanes.append(_packed_key_lane(keys, keys_valid, pack_spec))
    for i, ((dt, _hv, _ld), kd, kv) in enumerate(
            zip(key_lanes_info, keys, keys_valid)):
        if i not in packed_idx:
            lanes.extend(l for l in _null_first_key_lanes(
                compute_view(kd, dt), kv, dt) if l is not None)
    fused = None
    if minor_lanes and len(packed_idx) == len(keys):
        minor_packed, minor_total = pack_minor_spec(minor_lanes, minor_spec)
        total = 1
        for i in packed_idx:
            total *= int(pack_spec[i][1])
        if minor_packed is not None and \
                (total + 1) * minor_total < (1 << 62):
            key = lanes[0] if lanes else torch.zeros(
                capacity, dtype=torch.int64, device=dev)
            # dead rows take the key past every group's: they sort last
            key = torch.where(live, key, torch.full_like(key, total))
            fused = key * minor_total + minor_packed
    if fused is not None:
        s_fused, perm = torch.sort(fused, stable=True)
        s_key = torch.div(s_fused, minor_total, rounding_mode="floor")
        s_live = s_key < total
        s_keys, s_keys_valid, _ = take_keys_valid(keys, keys_valid, [],
                                                  perm)
        boundary = _eq_prev(s_key)
    else:
        # np.lexsort order (LAST lane primary), liveness first
        perm = lexsort_capped(list(minor_lanes) + list(reversed(lanes)) +
                              [(~live).to(torch.int8)])
        s_keys, s_keys_valid, (s_live,) = take_keys_valid(
            keys, keys_valid, [live], perm)
        boundary = row0_true(capacity, dev)
        for lane in grouped_take(lanes, perm):
            boundary = boundary | _eq_prev(lane)
        boundary = boundary | _eq_prev(s_live)
    seg_ids = torch.cumsum(boundary.to(torch.int32), 0,
                           dtype=torch.int32) - 1
    count = live.sum(dtype=torch.int32)
    last = seg_ids.index_select(
        0, torch.clamp(count - 1, min=0).long().view(1))[0] + 1
    num_groups = torch.where(count > 0, last, torch.zeros_like(last))
    # seg ids rise with position, so the g-th boundary IS segment g's
    # start: a single-lane sort compacts the boundary positions
    iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    start_raw = torch.sort(torch.where(boundary, iota, torch.full_like(
        iota, capacity))).values[:num_segments]
    end_idx = segment_ends(start_raw, count, capacity)
    start_idx = torch.clamp(start_raw, 0, capacity - 1)
    group_live = torch.arange(num_segments, dtype=torch.int32,
                              device=dev) < num_groups
    okds, okvs, _ = take_keys_valid(s_keys, s_keys_valid, [], start_idx)
    out_keys = [(okd, group_live if okv is None else okv & group_live)
                for okd, okv in zip(okds, okvs)]
    return SegRuns(perm, s_live, boundary, start_idx, end_idx, out_keys,
                   num_groups, group_live)
