"""Window kernels: segmented scans and reductions over partition-sorted
rows.

Counterpart of spark_rapids_tpu/ops/window.py, function for function:

  * the input batch arrives sorted by (partition keys, order keys)
    (ops/sort.py); partition and peer boundaries are inequality flags on
    adjacent rows, as in the sort-segment group-by;
  * running frames = segmented inclusive scans (ops/segments
    `blocked_seg_scan`: the reference's 512-row blocks and doubling
    order, so float64 sums associate as the reference's do, on the card
    as well);
  * unbounded frames = the forward scan read at each row's segment end;
  * bounded ROWS sums/counts = prefix-sum differences with the window
    clamped to the partition (ops/kernels `blocked_cumsum`, the
    reference's blocked order for floating lanes);
  * bounded ROWS min/max = a shift-stack when both bounds are finite,
    forward/backward segmented scans read at the moving bound when one
    side is unbounded;
  * value-offset RANGE frames = merge-rank bounds (two stable sorts of
    the key lane beside the query lane per segment) and, for min/max, a
    sparse table.  The table keeps only the levels the widest frame of
    this batch needs (the reference keeps log2(capacity) + 1).

PyTorch runs eagerly, so `window_trace` returns a function that
evaluates every window expression of an operator on the tensors it is
given; nothing is traced or cached.  DOUBLE lanes are float64 here:
their MIN/MAX reduce in the int64 total-order image (-0.0 below 0.0,
NaN greatest), which is the reference's order for host DOUBLE columns.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .. import types as t
from ..plan.window import WindowFrame
from .groupby import (_ORDER_MAX, _ORDER_MIN, _null_first_key_lanes,
                      float_from_order, float_order)
from .kernels import blocked_cumsum, compute_view
from .segments import blocked_seg_scan, row0_true


def _seg_scan(vals: torch.Tensor, boundary: torch.Tensor, op
              ) -> torch.Tensor:
    """Segmented inclusive scan: resets at rows where boundary is True."""
    return blocked_seg_scan(vals, boundary, op)


def _seg_scan_rev(vals: torch.Tensor, boundary: torch.Tensor, op
                  ) -> torch.Tensor:
    """Segmented inclusive scan from each segment's END backwards.
    `boundary` marks segment STARTS; reversed, segment ends are starts."""
    end_b = torch.cat([boundary[1:], torch.ones(
        1, dtype=torch.bool, device=boundary.device)])
    return torch.flip(_seg_scan(torch.flip(vals, [0]),
                                torch.flip(end_b, [0]), op), [0])


def _boundary_from_lanes(lanes: List[torch.Tensor], capacity: int,
                         device) -> torch.Tensor:
    """True where any lane differs from the previous row (row 0 True)."""
    b = row0_true(capacity, device)
    head = torch.ones(1, dtype=torch.bool, device=device)
    for lane in lanes:
        if lane is None:
            continue
        b = b | torch.cat([head, lane[1:] != lane[:-1]])
    return b


def _key_eq_lanes(cols_info, datas, valids) -> List[torch.Tensor]:
    lanes: List[torch.Tensor] = []
    for (dt,), d, v in zip(cols_info, datas, valids):
        lanes.extend(l for l in _null_first_key_lanes(
            compute_view(d, dt), v, dt) if l is not None)
    return lanes


def _gather(vals: torch.Tensor, idx: torch.Tensor, capacity: int
            ) -> torch.Tensor:
    return vals[torch.clamp(idx, 0, capacity - 1).long()]


def _minmax_ident(dtype: torch.dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    if dtype == torch.bool:
        return is_min       # True is min-identity, False max-identity
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _minmax_lanes(cd, vl, dt, is_min):
    """(order lane with invalid rows at identity, identity scalar,
    decoder, NaN lane or None).

    DOUBLE compares in the int64 total-order image (exact, -0.0 below
    0.0, NaN greatest).  FLOAT orders by value with NaN mapped to +inf;
    callers restore NaN results from per-frame NaN counts (Spark: max is
    NaN when any valid value is NaN, min only when ALL are)."""
    if isinstance(dt, t.DoubleType):
        ident = _ORDER_MAX if is_min else _ORDER_MIN
        o = torch.where(vl, float_order(cd.to(torch.float64)),
                        torch.full_like(cd, ident, dtype=torch.int64))
        return o, ident, float_from_order, None
    if t.is_floating(dt):
        f = cd.to(torch.float64)
        nan_lane = (torch.isnan(f) & vl).to(torch.int64)
        o = torch.where(torch.isnan(f), torch.full_like(f, float("inf")), f)
        ident = float("inf") if is_min else float("-inf")
        o = torch.where(vl, o, torch.full_like(o, ident))
        return o, ident, (lambda x: x), nan_lane
    if isinstance(dt, t.BooleanType):
        ident = 1 if is_min else 0
        o = torch.where(vl, cd.to(torch.int8),
                        torch.full_like(cd, ident, dtype=torch.int8))
        return o, ident, (lambda x: x > 0), None
    ident = _minmax_ident(cd.dtype, is_min)
    o = torch.where(vl, cd, torch.full_like(cd, ident))
    return o, ident, (lambda x: x), None


def _round_half_up_div(num: torch.Tensor, den: torch.Tensor
                       ) -> torch.Tensor:
    """Spark decimal division rounding: HALF_UP (away from zero), den > 0."""
    mag = torch.abs(num)
    q = torch.div(mag + torch.div(den, 2, rounding_mode="floor"), den,
                  rounding_mode="floor")
    return torch.where(num < 0, -q, q)


def _nan_restore(red, frame_cnt, frame_nan, is_min):
    """Spark float semantics over the NaN -> +inf order lane: max is NaN
    when any valid value in the frame is NaN; min only when ALL are."""
    if frame_nan is None:
        return red
    non_nan = frame_cnt - frame_nan
    nan = torch.full_like(red, float("nan"))
    if is_min:
        return torch.where((frame_cnt > 0) & (non_nan == 0), nan, red)
    return torch.where(frame_nan > 0, nan, red)


def _merge_rank_counts(seg, u, query, query_first: bool, part_start,
                       capacity: int):
    """Per-row count of in-segment key values < query (query_first) or
    <= query (not query_first), without a binary search: two stable
    sorts merge the key lane with the query lane per segment, and the
    tie order (queries before keys, or after) rides on stability."""
    segs = torch.cat([seg, seg])
    if query_first:
        vals = torch.cat([query, u])
        qlo = 0
    else:
        vals = torch.cat([u, query])
        qlo = capacity
    # by value, then stably by segment: the second sort's payload is the
    # merged (segment, value) order
    p1 = torch.sort(vals, stable=True).indices
    p2 = torch.sort(segs[p1], stable=True).indices
    s_ids = p1[p2]
    is_key = (s_ids < qlo) | (s_ids >= qlo + capacity)
    cum = torch.cumsum(is_key.to(torch.int32), 0, dtype=torch.int32)
    # every batch row is a key, so keys in earlier segments == the
    # segment's starting row index; invert the merged order back to rows
    counts = torch.empty(2 * capacity, dtype=torch.int32, device=u.device)
    counts[s_ids] = cum
    return counts[qlo:qlo + capacity] - part_start


def _range_value_bounds(order_lane, order_valid, asc: bool,
                        nulls_first: bool, frame, seg, part_start,
                        part_end, peer_start, peer_end, capacity: int):
    """Per-row inclusive [lo, hi] row bounds of a value-offset RANGE
    frame over the single (integer-lane) order key.  frame.lower/upper
    are SIGNED value offsets (None = unbounded, 0 = the current peer
    group).  Null order keys frame their null peer group (Spark)."""
    u = order_lane.to(torch.int64)
    if not asc:
        u = -u                      # normalize to ascending value space
    # keep real values off the int64 extremes: the extremes are the null
    # sentinels below, and u + offset must not wrap (saturating query)
    lo_b, hi_b = _ORDER_MIN + 1, _ORDER_MAX - 1
    u = torch.clamp(u, lo_b, hi_b)
    if order_valid is not None:
        # null-key rows sit at the segment's head or tail (sort nf); pin
        # their u to that extreme so non-null rows' merge counts step
        # over them (their own bounds are masked below)
        null_u = _ORDER_MIN if nulls_first else _ORDER_MAX
        u = torch.where(order_valid, u, torch.full_like(u, null_u))

    def query(offset: int):
        # saturate u + offset inside the sentinel-free value band; the
        # clip bounds are exact Python ints, so nothing wraps
        lo_c = max(lo_b, lo_b - offset)
        hi_c = min(hi_b, hi_b - offset)
        return torch.clamp(u, lo_c, hi_c) + offset

    if frame.lower is None:
        lo = part_start
    elif frame.lower == 0:
        lo = peer_start
    else:
        # offsets are direction-free in the normalized (ascending-u)
        # space: for DESC, "x preceding" = key + x = u - x = u + lower
        cnt = _merge_rank_counts(seg, u, query(int(frame.lower)), True,
                                 part_start, capacity)
        lo = part_start + cnt
    if frame.upper is None:
        hi = part_end
    elif frame.upper == 0:
        hi = peer_end
    else:
        cnt = _merge_rank_counts(seg, u, query(int(frame.upper)), False,
                                 part_start, capacity)
        hi = part_start + cnt - 1
    if order_valid is not None:
        lo = torch.where(order_valid, lo, peer_start)
        hi = torch.where(order_valid, hi, peer_end)
    return lo, hi


def _ilog2(length: torch.Tensor, top: int) -> torch.Tensor:
    """floor(log2(length)) for 1 <= length <= top, exactly (no float
    round-off)."""
    k = torch.zeros(length.shape, dtype=torch.int64, device=length.device)
    j = 2
    while j <= top:
        k = k + (length >= j).to(torch.int64)
        j <<= 1
    return k


def _sparse_minmax(o, ident, lo, hi, nonempty, op, capacity: int):
    """min/max over per-row [lo, hi] spans via a sparse table (doubled-
    shift levels, two gathers per query) — the variable-width analogue
    of the shift-stack of bounded ROWS frames.  Only the levels the
    widest live frame needs are built (one host sync for that width)."""
    length = torch.where(nonempty, hi - lo + 1,
                         torch.ones_like(hi)).to(torch.int64)
    widest = max(int(length.max()), 1)
    levels = widest.bit_length()           # floor(log2(widest)) + 1
    table = torch.empty((levels, capacity), dtype=o.dtype, device=o.device)
    table[0] = o
    step = 1
    for j in range(1, levels):
        prev = table[j - 1]
        shifted = torch.cat([prev[step:], torch.full(
            (step,), ident, dtype=o.dtype, device=o.device)])
        table[j] = op(prev, shifted)
        step <<= 1
    flat = table.reshape(-1)
    k = _ilog2(length, widest)
    left = torch.clamp(lo, 0, capacity - 1).to(torch.int64)
    right = torch.clamp(hi - (1 << k) + 1, 0, capacity - 1).to(torch.int64)
    return op(flat[k * capacity + left], flat[k * capacity + right])


def window_trace(part_info, order_info, val_info, specs_frames,
                 capacity: int, order_dirs=()):
    """The window program of one operator.

    part_info/order_info/val_info: tuples of (dtype,) per column.
    specs_frames: list of (spec, resolved WindowFrame, input_idx);
    input_idx indexes the value columns, -1 for input-less functions.

    Returns fn(part_data, part_valid, order_data, order_valid, val_data,
    val_valid, live) -> [(data, valid)] per spec, where every lane
    belongs to the partition-sorted batch."""
    def run(part_data, part_valid, order_data, order_valid,
            val_data, val_valid, live):
        dev = live.device
        idx = torch.arange(capacity, dtype=torch.int64, device=dev)

        # --- partition / peer structure ---
        part_lanes = _key_eq_lanes(part_info, part_data, part_valid)
        live_lane = (~live).to(torch.int8)
        part_b = _boundary_from_lanes(part_lanes + [live_lane], capacity,
                                      dev)
        seg = torch.cumsum(part_b.to(torch.int64), 0) - 1

        order_lanes = _key_eq_lanes(order_info, order_data, order_valid)
        peer_b = (part_b | _boundary_from_lanes(order_lanes, capacity, dev)
                  ) if order_lanes else part_b

        part_start = _seg_scan(idx, part_b, torch.minimum)
        pg = torch.cumsum(peer_b.to(torch.int64), 0) - 1
        peer_start = _seg_scan(idx, peer_b, torch.minimum)
        # a reverse max-scan IS the per-row segment end
        part_end = _seg_scan_rev(idx, part_b, torch.maximum)
        peer_end = _seg_scan_rev(idx, peer_b, torch.maximum)
        part_rows = part_end - part_start + 1

        rn0 = idx - part_start                     # 0-based row number

        def frame_bounds(frame: WindowFrame):
            """Per-row inclusive [lo, hi] row-index bounds."""
            if frame.kind == "range":
                if frame.is_value_offset:
                    # value-offset RANGE: one integer-lane order key
                    # (plan/overrides.py guarantees it)
                    asc, nf = order_dirs[0] if order_dirs else (True, True)
                    ov = order_valid[0]
                    ov = None if ov is None else (ov & live)
                    lo, hi = _range_value_bounds(
                        compute_view(order_data[0], order_info[0][0]),
                        ov, asc, nf, frame, seg, part_start, part_end,
                        peer_start, peer_end, capacity)
                    return (torch.minimum(torch.maximum(lo, part_start),
                                          part_end + 1),
                            torch.minimum(torch.maximum(hi, part_start - 1),
                                          part_end))
                lo = part_start if frame.lower is None else peer_start
                hi = part_end if frame.upper is None else peer_end
                return lo, hi
            lo = part_start if frame.lower is None \
                else torch.maximum(part_start, idx + frame.lower)
            hi = part_end if frame.upper is None \
                else torch.minimum(part_end, idx + frame.upper)
            return lo, hi

        outs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for spec, frame, input_idx in specs_frames:
            kind = spec.kind
            if input_idx >= 0:
                d = val_data[input_idx]
                v = val_valid[input_idx]
                v = torch.ones(capacity, dtype=torch.bool, device=dev) \
                    if v is None else v
                dt = spec.child.dtype
                cd = compute_view(d, dt)
                vl = v & live
            else:
                cd = dt = None
                vl = live

            if kind == "row_number":
                outs.append(((rn0 + 1).to(torch.int32), live))
            elif kind == "rank":
                outs.append(((peer_start - part_start + 1).to(torch.int32),
                             live))
            elif kind == "dense_rank":
                dr = _seg_scan(peer_b.to(torch.int32), part_b, torch.add)
                outs.append((dr, live))
            elif kind == "percent_rank":
                rank0 = (peer_start - part_start).to(torch.float64)
                denom = (part_rows - 1).to(torch.float64)
                pr = torch.where(denom > 0, rank0 / torch.clamp(denom,
                                                                 min=1.0),
                                 torch.zeros_like(rank0))
                outs.append((pr, live))
            elif kind == "cume_dist":
                cume = (peer_end - part_start + 1).to(torch.float64) \
                    / part_rows.to(torch.float64)
                outs.append((cume, live))
            elif kind == "ntile":
                n = spec.n
                k = torch.div(part_rows, n, rounding_mode="floor")
                rem = part_rows - k * n
                cut = rem * (k + 1)
                bucket = torch.where(
                    rn0 < cut,
                    torch.div(rn0, torch.clamp(k + 1, min=1),
                              rounding_mode="floor"),
                    rem + torch.div(rn0 - cut, torch.clamp(k, min=1),
                                    rounding_mode="floor"))
                bucket = torch.where(part_rows < n, rn0, bucket)
                outs.append(((bucket + 1).to(torch.int32), live))
            elif kind in ("lead", "lag"):
                shift = spec.offset * (1 if kind == "lead" else -1)
                src = idx + shift
                in_part = (src >= part_start) & (src <= part_end) & live
                sd = _gather(cd, src, capacity)
                sv = _gather(vl, src, capacity)
                if spec.default is not None:
                    # Spark: the default only where the offset row does
                    # not exist; an existing null value stays null
                    data = torch.where(in_part, sd,
                                       torch.full_like(sd, spec.default))
                    valid = torch.where(in_part, sv,
                                        torch.ones_like(sv)) & live
                else:
                    data = torch.where(in_part, sd, torch.zeros_like(sd))
                    valid = in_part & sv
                outs.append((data, valid))
            elif kind in ("first_value", "last_value"):
                lo, hi = frame_bounds(frame)
                pick = lo if kind == "first_value" else hi
                nonempty = hi >= lo
                data = _gather(cd, pick, capacity)
                valid = _gather(vl, pick, capacity) & nonempty & live
                outs.append((data, valid))
            elif kind in ("agg_sum", "agg_count", "agg_avg",
                          "agg_min", "agg_max"):
                outs.append(_framed_agg(
                    kind, spec, frame, cd, vl, dt, idx, part_b,
                    frame_bounds, peer_end, peer_start, live, capacity,
                    peer_b, part_end))
            else:
                raise ValueError(f"unknown window kind {kind}")
        return outs

    return run


def _framed_agg(kind, spec, frame, cd, vl, dt, idx, part_b, frame_bounds,
                peer_end, peer_start, live, capacity, peer_b, part_end):
    """sum/count/min/max/avg over a frame; returns (data, valid)."""
    is_min = kind == "agg_min"
    count_all = kind == "agg_count" and spec.child is None
    cnt_lane = (live if count_all else vl).to(torch.int64)
    decimal = isinstance(dt, t.DecimalType)

    if kind in ("agg_sum", "agg_avg"):
        if decimal or not (kind == "agg_avg" or t.is_floating(dt)):
            acc = torch.where(vl, cd.to(torch.int64),
                              torch.zeros((), dtype=torch.int64,
                                          device=cd.device))
        else:
            acc = torch.where(vl, cd.to(torch.float64),
                              torch.zeros((), dtype=torch.float64,
                                          device=cd.device))

    def finish(s, c):
        if kind == "agg_count":
            return c, live
        if kind == "agg_sum":
            return s, (c > 0) & live
        if decimal:
            # avg(decimal(p,s)) -> decimal(p+4, s+4): unscaled*10^4/count
            q = _round_half_up_div(s * 10 ** 4, torch.clamp(c, min=1))
            return q, (c > 0) & live
        return s / torch.clamp(c, min=1).to(torch.float64), (c > 0) & live

    # --- whole-partition / whole-peer-group frames: reduce + broadcast ---
    peers_only = frame.kind == "range" and frame.lower == 0 \
        and frame.upper == 0
    if frame.is_unbounded_both or peers_only:
        b = peer_b if peers_only else part_b
        end = peer_end if peers_only else part_end

        def red_bcast(lane, op):
            """The forward scan's value at the segment END is the full
            reduction; `end` is per-row — scan + one gather."""
            return _gather(_seg_scan(lane, b, op), end, capacity)

        c = red_bcast(cnt_lane, torch.add)
        if kind == "agg_count":
            return c, live
        if kind in ("agg_sum", "agg_avg"):
            return finish(red_bcast(acc, torch.add), c)
        o, _ident, back, nan_lane = _minmax_lanes(cd, vl, dt, is_min)
        red = red_bcast(o, torch.minimum if is_min else torch.maximum)
        fnan = None if nan_lane is None else red_bcast(nan_lane, torch.add)
        return _nan_restore(back(red), c, fnan, is_min), (c > 0) & live

    # --- running frames (incl. RANGE ..CURRENT ROW via peer-end gather) ---
    running_rows = frame.kind == "rows" and frame.is_running
    running_range = frame.kind == "range" and frame.lower is None \
        and frame.upper == 0
    if running_rows or running_range:
        def at_peers(x):
            return _gather(x, peer_end, capacity) if running_range else x
        c = at_peers(_seg_scan(cnt_lane, part_b, torch.add))
        if kind == "agg_count":
            return c, live
        if kind in ("agg_sum", "agg_avg"):
            return finish(at_peers(_seg_scan(acc, part_b, torch.add)), c)
        o, _ident, back, nan_lane = _minmax_lanes(cd, vl, dt, is_min)
        red = at_peers(_seg_scan(
            o, part_b, torch.minimum if is_min else torch.maximum))
        fnan = None if nan_lane is None else at_peers(
            _seg_scan(nan_lane, part_b, torch.add))
        return _nan_restore(back(red), c, fnan, is_min), (c > 0) & live

    # --- RANGE CURRENT ROW .. UNBOUNDED FOLLOWING: reverse running ---
    if frame.kind == "range" and frame.lower == 0 and frame.upper is None:
        def at_peer_start(x):
            return _gather(x, peer_start, capacity)
        c = at_peer_start(_seg_scan_rev(cnt_lane, part_b, torch.add))
        if kind == "agg_count":
            return c, live
        if kind in ("agg_sum", "agg_avg"):
            return finish(at_peer_start(_seg_scan_rev(acc, part_b,
                                                      torch.add)), c)
        o, _ident, back, nan_lane = _minmax_lanes(cd, vl, dt, is_min)
        red = at_peer_start(_seg_scan_rev(
            o, part_b, torch.minimum if is_min else torch.maximum))
        fnan = None if nan_lane is None else at_peer_start(
            _seg_scan_rev(nan_lane, part_b, torch.add))
        return _nan_restore(back(red), c, fnan, is_min), (c > 0) & live

    # --- bounded frames ---
    lo, hi = frame_bounds(frame)
    nonempty = (hi >= lo) & live

    def pref_window(lane):
        """Sum of `lane` over each row's [lo, hi]: a prefix-sum
        difference (exact for integer lanes, whatever wraps)."""
        p = blocked_cumsum(lane)
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        hi_v = _gather(p, hi, capacity)
        lo_v = torch.where(lo > 0, _gather(p, lo - 1, capacity), zero)
        return torch.where(nonempty, hi_v - lo_v, zero)

    if kind in ("agg_sum", "agg_count", "agg_avg"):
        c = pref_window(cnt_lane)
        if kind == "agg_count":
            return c, live
        return finish(pref_window(acc), c)

    # bounded min/max
    o, ident, back, nan_lane = _minmax_lanes(cd, vl, dt, is_min)
    op = torch.minimum if is_min else torch.maximum
    identity = torch.full_like(o, ident)
    c_cnt = None
    if frame.kind == "range":
        # value-offset RANGE: variable frame widths -> sparse table
        red = torch.where(nonempty, _sparse_minmax(o, ident, lo, hi,
                                                   nonempty, op, capacity),
                          identity)
    elif frame.lower is None:
        # UNBOUNDED PRECEDING .. k FOLLOWING: forward scan read at hi
        fwd = _seg_scan(o, part_b, op)
        red = torch.where(nonempty, _gather(fwd, hi, capacity), identity)
    elif frame.upper is None:
        # k PRECEDING .. UNBOUNDED FOLLOWING: backward scan read at lo
        bwd = _seg_scan_rev(o, part_b, op)
        red = torch.where(nonempty, _gather(bwd, lo, capacity), identity)
    else:
        best = identity
        c_cnt = torch.zeros(capacity, dtype=torch.int64, device=o.device)
        for off in range(frame.lower, frame.upper + 1):
            src = idx + off
            ok = (src >= lo) & (src <= hi)
            cand_v = ok & _gather(vl, src, capacity)
            cand = torch.where(cand_v, _gather(o, src, capacity), identity)
            best = op(best, cand)
            c_cnt = c_cnt + cand_v.to(torch.int64)
        red = best
    if c_cnt is None:
        c_cnt = pref_window(vl.to(torch.int64))
    fnan = None if nan_lane is None else pref_window(nan_lane)
    return _nan_restore(back(red), c_cnt, fnan, is_min), (c_cnt > 0) & live
