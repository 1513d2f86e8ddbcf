"""Bounded-domain segmented aggregation on Hopper: kernel wrappers, their
plain PyTorch versions, and the group-by glue.

Counterpart of spark_rapids_tpu/ops/pallas/segagg.py.

  * `seg_sums`   replaces `_seg_matmul_sums` (segagg.py:57): per-bucket
    sums of int64 lanes (exact mod 2^64) and float64 lanes in one pass.
  * `seg_reduce` replaces `_seg_reduce` (segagg.py:123): per-bucket min
    or max of one lane with an identity value.

Both kernels are hand-written CUDA (csrc/segagg.cu; the design and
what bounds it are noted there).  A wrapper given CUDA tensors checks
device, dtype, shape and contiguity, allocates the outputs and the
kernel's scratch (PyTorch's caching allocator, current stream), launches
on PyTorch's current stream and raises if the launch fails; given CPU
tensors it runs the plain version beside it, which is also the
yardstick chip_smoke.py holds the kernel against.  Nothing falls back
from the card to the plain version.

`segagg_groupby_trace` is the glue (the reference's
`pallas_groupby_trace`, segagg.py:163): the same call contract and
output shape as the sort-based group-by — (num_segments,)-sized
outputs, occupied buckets first in ascending packed-key order, null
slot first.  FIRST/LAST, ANY/EVERY and NaN-aware float MIN/MAX derive
from the two kernels exactly as there.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ... import types as t
from .. import groupby as G
from ..kernels import compute_view
from ...runtime.capture import host_reads_ok
from . import (LAUNCHES, TICKETS, check_launch, library, stream_ptr,
               stream_scratch)

_VP = ctypes.c_void_p
_VPP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "segagg_seg_sums_scratch": ([_LL, _I, _I, _I], _LL),
    "segagg_seg_sums": ([_VP, _LL, _I, _VPP, _I, _VPP, _I, _VP, _VP, _VP,
                         _VP, _I, _VP, ctypes.POINTER(_I)], _I),
    "segagg_seg_reduce_scratch": ([_LL, _I, _I], _LL),
    "segagg_seg_reduce": ([_VP, _LL, _I, _VP, _I, _LL, _I, _VP, _VP, _VP,
                           _I, _VP], _I),
}
#: largest domain the wrappers take: one lane of 8-byte cells in 48 KB
MAX_KERNEL_DOMAIN = 48 * 1024 // 8
#: the seg_reduce kernel's type codes: lanes of these dtypes are read as
#: they lie (bool as int8); float32 widens to float64 first
_REDUCE_CODES = {torch.bool: 1, torch.int8: 1, torch.int16: 2,
                 torch.int32: 4, torch.int64: 8, torch.float64: 9}


def _fn(name: str):
    f = getattr(library("segagg"), name)
    if f.argtypes is None:
        f.argtypes, f.restype = _SIGNATURES[name]
    return f


def _scratch(nbytes: int, device: torch.device, kernel: str) -> torch.Tensor:
    """The kernel's scratch; its query gives the bytes, or minus the CUDA
    error that refuses the call."""
    check_launch(-nbytes if nbytes < 0 else 0, kernel)
    return torch.empty(max(nbytes // 8, 1), dtype=torch.int64, device=device)


def _check_seg(seg: torch.Tensor, domain: int) -> None:
    if seg.dtype != torch.int32 or seg.dim() != 1 or \
            not seg.is_contiguous():
        raise ValueError("seg must be a contiguous 1-D int32 tensor")
    if not 0 < domain <= MAX_KERNEL_DOMAIN:
        raise ValueError(f"domain {domain} outside (0, {MAX_KERNEL_DOMAIN}]")


def _check_lane(lane: torch.Tensor, seg: torch.Tensor, dtype) -> None:
    if lane.device != seg.device:
        raise ValueError("lane and seg lie on different devices")
    if lane.dtype != dtype or lane.shape != seg.shape or \
            not lane.is_contiguous():
        raise ValueError(f"lane must be contiguous {dtype} of shape "
                         f"{tuple(seg.shape)}, got {lane.dtype} "
                         f"{tuple(lane.shape)}")


def _check_lanes(lanes, seg: torch.Tensor, dtype) -> None:
    """_check_lane for each lane, with one cheap test a lane first (the
    check is host time on every call)."""
    shape, dev = seg.shape, seg.device
    for lane in lanes:
        if lane.dtype != dtype or lane.shape != shape or \
                lane.device != dev or not lane.is_contiguous():
            _check_lane(lane, seg, dtype)


def _bucket_index(seg: torch.Tensor, domain: int) -> torch.Tensor:
    """int64 bucket ids with every row outside [0, domain) sent to the
    extra sink bucket `domain` (dead rows carry seg == domain)."""
    seg = seg.to(torch.int64)
    return torch.where((seg >= 0) & (seg < domain), seg,
                       torch.full_like(seg, domain))


# ---------------------------------------------------------------------------
# seg_sums
# ---------------------------------------------------------------------------

def seg_sums_plain(seg, int_lanes, f64_lanes, domain: int):
    """Plain version of seg_sums: index_add_ into int64 / float64 zeros."""
    idx = _bucket_index(seg, domain)
    dev = seg.device
    iacc = torch.zeros((domain + 1, len(int_lanes)), dtype=torch.int64,
                       device=dev)
    facc = torch.zeros((domain + 1, len(f64_lanes)), dtype=torch.float64,
                       device=dev)
    if int_lanes:
        iacc.index_add_(0, idx, torch.stack(list(int_lanes), dim=1))
    if f64_lanes:
        facc.index_add_(0, idx, torch.stack(list(f64_lanes), dim=1))
    return iacc[:domain], facc[:domain]


def seg_sums(seg, int_lanes, f64_lanes, domain: int):
    """(domain, Ki) int64 sums (mod 2^64) and (domain, Kf) float64 sums
    of every lane per bucket `seg` in [0, domain); rows with any other
    bucket id (dead rows carry `domain`) are skipped."""
    if seg.device.type == "cpu":
        return seg_sums_plain(seg, int_lanes, f64_lanes, domain)
    if seg.device.type != "cuda":
        raise ValueError(f"seg_sums: unsupported device {seg.device}")
    _check_seg(seg, domain)
    _check_lanes(int_lanes, seg, torch.int64)
    _check_lanes(f64_lanes, seg, torch.float64)
    ki, kf = len(int_lanes), len(f64_lanes)
    dev, cap = seg.device, seg.numel()
    # the kernel writes every cell, zeros included
    iout = torch.empty((domain, ki), dtype=torch.int64, device=dev)
    fout = torch.empty((domain, kf), dtype=torch.float64, device=dev)
    if ki + kf == 0:
        return iout, fout
    st = stream_ptr(dev)
    scratch = _scratch(_fn("segagg_seg_sums_scratch")(cap, domain, ki, kf),
                       dev, "seg_sums")
    # the lanes may be freed once this returns, before the launch has
    # run: PyTorch's caching allocator hands their blocks only to later
    # work on the same stream, which the stream orders after the kernel
    iptrs = (_VP * max(ki, 1))(*[l.data_ptr() for l in int_lanes])
    fptrs = (_VP * max(kf, 1))(*[l.data_ptr() for l in f64_lanes])
    launched = _I(0)
    err = _fn("segagg_seg_sums")(
        seg.data_ptr(), cap, domain, iptrs, ki, fptrs, kf, iout.data_ptr(),
        fout.data_ptr(), scratch.data_ptr(),
        stream_scratch(dev, st).tickets.data_ptr(), TICKETS, st,
        ctypes.byref(launched))
    # one launch per tile of lanes whose accumulator fits shared memory
    LAUNCHES["seg_sums"] += launched.value
    check_launch(err, "seg_sums")
    return iout, fout


# ---------------------------------------------------------------------------
# seg_reduce
# ---------------------------------------------------------------------------

def _float_ident_order(ident: float) -> int:
    # a host constant (a CPU tensor on either device)
    with host_reads_ok():
        return int(G.float_order(torch.tensor([float(ident)],
                                              dtype=torch.float64))[0])


def seg_reduce_plain(seg, lane, domain: int, is_min: bool, ident):
    """Plain version of seg_reduce: scatter_reduce amin/amax with
    include_self over an identity-filled tensor.  Floats reduce in their
    total-order int64 image (-0.0 < +0.0, NaN above +inf), as the kernel
    does; int8/bool lanes widen to int32 and narrow back."""
    idx = _bucket_index(seg, domain)
    red = "amin" if is_min else "amax"
    if lane.dtype.is_floating_point:
        o = G.float_order(lane.to(torch.float64))
        out = torch.full((domain + 1,), _float_ident_order(ident),
                         dtype=torch.int64, device=seg.device)
        out.scatter_reduce_(0, idx, o, red, include_self=True)
        return G.float_from_order(out[:domain]).to(lane.dtype)
    wide = lane.dtype in (torch.bool, torch.int8, torch.int16)
    work = lane.to(torch.int32) if wide else lane
    out = torch.full((domain + 1,), int(ident), dtype=work.dtype,
                     device=seg.device)
    out.scatter_reduce_(0, idx, work, red, include_self=True)
    return out[:domain].to(lane.dtype)


def seg_reduce(seg, lane, domain: int, is_min: bool, ident):
    """(domain,) per-bucket min (is_min) or max of `lane`, `ident` where a
    bucket has no row.  bool/int8/int16/int32/int64 lanes reduce as they
    lie; float32 widens to float64 and narrows back; float64 reduces in
    Java Double.compare order."""
    if seg.device.type == "cpu":
        return seg_reduce_plain(seg, lane, domain, is_min, ident)
    if seg.device.type != "cuda":
        raise ValueError(f"seg_reduce: unsupported device {seg.device}")
    _check_seg(seg, domain)
    orig = lane.dtype
    if orig == torch.float32:
        lane = lane.to(torch.float64)
    code = _REDUCE_CODES.get(lane.dtype)
    if code is None:
        raise ValueError(f"seg_reduce: unsupported lane dtype {orig}")
    _check_lane(lane, seg, lane.dtype)
    dev, cap, st = seg.device, seg.numel(), stream_ptr(seg.device)
    if lane.dtype == torch.float64:
        ident_bits = struct.unpack("<q", struct.pack("<d", float(ident)))[0]
    else:
        ident_bits = int(ident)
    out = torch.empty(domain, dtype=lane.dtype, device=dev)
    scratch = _scratch(_fn("segagg_seg_reduce_scratch")(cap, domain, code),
                       dev, "seg_reduce")
    err = _fn("segagg_seg_reduce")(
        seg.data_ptr(), cap, domain, lane.data_ptr(), code, ident_bits,
        int(is_min), out.data_ptr(), scratch.data_ptr(),
        stream_scratch(dev, st).tickets.data_ptr(), TICKETS, st)
    # one launch per call: it writes the identities and the float64
    # values itself
    LAUNCHES["seg_reduce"] += 1
    check_launch(err, "seg_reduce")
    return out if out.dtype == orig else out.to(orig)


# ---------------------------------------------------------------------------
# The group-by glue
# ---------------------------------------------------------------------------

def _strides(spans):
    strides, tot = [], 1
    for s in reversed(spans):
        strides.append(tot)
        tot *= s
    strides.reverse()
    return strides, tot


def segagg_groupby_trace(pack_spec, key_lanes_info, agg_specs,
                         num_segments: int, capacity: int):
    """The block-accumulate group-by over a fully packed key tuple:
    fn(keys, keys_valid, agg_data, agg_valid, live) ->
    (per key (data, valid), per spec (data, valid), num_groups).

    key_lanes_info: per key (logical dtype, has_validity, torch dtype of
    its lane).  `live` is an arbitrary row mask (fused filters)."""
    spans = [s[1] for s in pack_spec]
    los = [s[0] for s in pack_spec]
    strides, D = _strides(spans)

    def run(keys, keys_valid, agg_data, agg_valid, live):
        dev = live.device
        packed = G._packed_key_lane(keys, keys_valid, pack_spec)
        seg = torch.where(live, packed, torch.full_like(packed, D)) \
            .to(torch.int32)
        iota = torch.arange(capacity, dtype=torch.int32, device=dev)

        # ---- queue every reduction over the original (unsorted) rows
        spec_vls = []
        for spec in agg_specs:
            if spec.input_idx >= 0:
                v = agg_valid[spec.input_idx]
                vl = live if v is None else v & live
                spec_vls.append((agg_data[spec.input_idx], vl))
            else:
                spec_vls.append((None, live))

        int_lanes, int_slots, f64_lanes, f64_slots = G._queue_sum_lanes(
            agg_specs, spec_vls, live)
        if ("all",) not in int_slots:              # bucket occupancy
            int_slots[("all",)] = len(int_lanes)
            int_lanes.append(live.to(torch.int64))

        iacc, facc = seg_sums(seg, int_lanes, f64_lanes, D)

        def sum_of(key, is_float):
            return (facc[:, f64_slots[key]] if is_float
                    else iacc[:, int_slots[key]])

        occupied = sum_of(("all",), False) > 0
        num_groups = occupied.sum(dtype=torch.int32)
        # occupied buckets to the front, stably (ascending packed key)
        order = torch.sort((~occupied).to(torch.int8), stable=True).indices
        group_live = torch.arange(D, dtype=torch.int32, device=dev) \
            < num_groups

        out_keys = []
        for (_dt, _hv, lane_dt), lo, span, stride in zip(
                key_lanes_info, los, spans, strides):
            slot = torch.div(order, stride, rounding_mode="floor") % span
            data = (slot - 1 + lo).to(lane_dt)
            out_keys.append((data, (slot > 0) & group_live))

        def reduce_of(lane, is_min, ident):
            return seg_reduce(seg, lane.contiguous(), D, is_min,
                              ident)[order]

        def nan_counts(si):
            # per-bucket NaN counts for the float-min contract (min is NaN
            # only when every valid value is NaN)
            d, vl = spec_vls[si]
            isnan = torch.isnan(compute_view(d, agg_specs[si].dtype)) & vl
            return seg_sums(seg, [isnan.to(torch.int64)], [], D)[0][:, 0][
                order]

        outs = []
        for si, spec in enumerate(agg_specs):
            d, vl = spec_vls[si]
            dt = spec.dtype
            if spec.kind in (G.COUNT, G.COUNT_ALL):
                outs.append((sum_of(G.sum_lane_key(spec, si), False)[order], group_live))
                continue
            valid_count = sum_of(("vc", spec.input_idx), False)[order]
            out_valid = (valid_count > 0) & group_live
            cd = compute_view(d, dt)
            if spec.kind == G.SUM:
                data = sum_of(G.sum_lane_key(spec, si), t.is_floating(dt))[order]
            elif spec.kind in (G.MIN, G.MAX):
                is_min = spec.kind == G.MIN
                if t.is_floating(dt):
                    isnan = torch.isnan(cd) & vl
                    has_nan = reduce_of(isnan.to(torch.int8), False, 0) > 0
                    ident = np.inf if is_min else -np.inf
                    clean = torch.where(vl & ~isnan, cd,
                                        torch.full_like(cd, ident))
                    red = reduce_of(clean, is_min, ident)
                    nan = torch.full_like(red, np.nan)
                    if is_min:
                        non_nan = valid_count - nan_counts(si)
                        data = torch.where(has_nan & (non_nan == 0), nan,
                                           red)
                    else:
                        data = torch.where(has_nan, nan, red)
                else:
                    if isinstance(dt, t.BooleanType):
                        ident = int(is_min)
                    else:
                        info = torch.iinfo(cd.dtype)
                        ident = info.max if is_min else info.min
                    data = reduce_of(torch.where(
                        vl, cd, torch.full_like(cd, ident)), is_min, ident)
            elif spec.kind in (G.FIRST, G.LAST, G.FIRST_NN, G.LAST_NN):
                is_first = spec.kind in (G.FIRST, G.FIRST_NN)
                sel = live if spec.kind in (G.FIRST, G.LAST) else vl
                none = capacity if is_first else -1
                masked = torch.where(sel, iota, torch.full_like(iota, none))
                raw = reduce_of(masked, is_first, none)
                pick = torch.clamp(raw, 0, capacity - 1).to(torch.int64)
                data = cd[pick]
                # a bucket with no row to pick is null, whatever the
                # clamped row holds
                out_valid = vl[pick] & (raw != none) & group_live
            elif spec.kind == G.ANY:
                data = reduce_of((cd & vl).to(torch.int8), False, 0) > 0
            elif spec.kind == G.EVERY:
                data = reduce_of((cd | ~vl).to(torch.int8), True, 1) > 0
            else:
                raise ValueError(f"unknown agg kind {spec.kind}")
            outs.append((data, out_valid))

        def fit(arr):
            # (D,) bucket lane -> (num_segments,) output lane, the shape
            # the sort-based group-by gives
            if D >= num_segments:
                return arr[:num_segments]
            pad = torch.zeros(num_segments - D, dtype=arr.dtype, device=dev)
            return torch.cat([arr, pad])

        out_keys = [(fit(kd), fit(kv)) for kd, kv in out_keys]
        outs = [(fit(data), fit(valid)) for data, valid in outs]
        return out_keys, outs, num_groups

    return run
