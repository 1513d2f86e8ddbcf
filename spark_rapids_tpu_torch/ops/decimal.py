"""Decimal arithmetic over int64 unscaled lanes.

Counterpart of spark_rapids_tpu/ops/decimal.py, with the same decimal
story: decimal(p<=18) is one exact int64 unscaled lane, and arithmetic
whose result type exceeds precision 18 stays one int64 lane with
overflow-to-null (values beyond int64's ~9.2e18 unscaled range null out
where Spark's 128-bit math would succeed — the reference's documented
deviation, kept identical here).

Spark result-type rules (DecimalPrecision, allowPrecisionLoss=true):
  add/sub: s = max(s1,s2);          p = max(p1-s1, p2-s2) + s + 1
  mul:     s = s1+s2;               p = p1 + p2 + 1
capped at 38 with scale reduction (min scale 6) on overflow.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import types as t
from ..runtime.capture import host_constant

MAX_PRECISION = 38
MIN_ADJUSTED_SCALE = 6
_I64_MAX = 2 ** 63 - 1


def max_unscaled(p: int) -> int:
    """Largest int64-exact unscaled magnitude per precision (p <= 18)."""
    return 10 ** min(p, 18) - 1


def _adjust(p: int, s: int) -> t.DecimalType:
    """Spark DecimalType.adjustPrecisionScale (allowPrecisionLoss)."""
    if p <= MAX_PRECISION:
        return t.DecimalType(p, s)
    int_digits = p - s
    min_scale = min(s, MIN_ADJUSTED_SCALE)
    adj_scale = max(MAX_PRECISION - int_digits, min_scale)
    return t.DecimalType(MAX_PRECISION, adj_scale)


def add_result(a: t.DecimalType, b: t.DecimalType) -> t.DecimalType:
    s = max(a.scale, b.scale)
    p = max(a.precision - a.scale, b.precision - b.scale) + s + 1
    return _adjust(p, s)


def mul_result(a: t.DecimalType, b: t.DecimalType) -> t.DecimalType:
    return _adjust(a.precision + b.precision + 1, a.scale + b.scale)


def div_result(a: t.DecimalType, b: t.DecimalType) -> t.DecimalType:
    s = max(6, a.scale + b.precision + 1)
    p = a.precision - a.scale + b.scale + s
    return _adjust(p, s)


def integral_as_decimal(dt: t.DataType) -> t.DecimalType:
    return {t.ByteType: t.DecimalType(3, 0), t.ShortType: t.DecimalType(5, 0),
            t.IntegerType: t.DecimalType(10, 0),
            t.LongType: t.DecimalType(20, 0)}[type(dt)]


def _ones(u: torch.Tensor) -> torch.Tensor:
    return torch.ones(u.shape, dtype=torch.bool, device=u.device)


def upscale(u: torch.Tensor, ds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """u * 10^ds with int64-overflow detection -> (value, ok).  Both
    bounds are compared: abs() of Long.MIN_VALUE stays negative."""
    if ds == 0:
        return u, _ones(u)
    f = 10 ** ds
    if f > _I64_MAX:
        return torch.zeros_like(u), u == 0
    lim = _I64_MAX // f
    return u * f, (u <= lim) & (u >= -lim)


def downscale_half_up(u: torch.Tensor, ds: int) -> torch.Tensor:
    """u / 10^ds rounding half away from zero (Spark HALF_UP), from the
    floor quotient and its remainder (no abs(), which overflows at
    Long.MIN_VALUE, and no add that can pass int64)."""
    if ds == 0:
        return u
    if ds >= 19:
        half = 5 * 10 ** 18 if ds == 19 else _I64_MAX
        return (u >= half).to(u.dtype) - (u <= -half).to(u.dtype)
    f = 10 ** ds
    q = torch.div(u, f, rounding_mode="floor")
    r2 = (u - q * f) * 2
    return q + torch.where(u < 0, r2 > f, r2 >= f).to(u.dtype)


def rescale(u: torch.Tensor, from_scale: int, to_scale: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, ok): change of scale with overflow/rounding per Spark."""
    if to_scale >= from_scale:
        return upscale(u, to_scale - from_scale)
    return downscale_half_up(u, from_scale - to_scale), _ones(u)


def fits_precision(u: torch.Tensor, p: int) -> torch.Tensor:
    """ok mask: |u| representable in precision p (int64-capped)."""
    if p >= 19:
        return _ones(u)
    m = max_unscaled(p)
    return (u <= m) & (u >= -m)


def add_dev(ua, sa, ub, sb, out: t.DecimalType):
    """Aligned add -> (unscaled, ok)."""
    va, ok_a = rescale(ua, sa, out.scale)
    vb, ok_b = rescale(ub, sb, out.scale)
    r = va + vb
    # int64 add overflow: same sign in, different sign out
    ovf = ((va >= 0) == (vb >= 0)) & ((r >= 0) != (va >= 0))
    return r, ok_a & ok_b & ~ovf & fits_precision(r, out.precision)


def sub_dev(ua, sa, ub, sb, out: t.DecimalType):
    return add_dev(ua, sa, -ub, sb, out)


def mul_dev(ua, sa, ub, sb, out: t.DecimalType):
    """Product at scale sa+sb, then rescale to out.scale."""
    prod = ua * ub
    # overflow estimate via f64 magnitudes, as the reference does (a 2^62
    # guard leaves margin over f64's 53-bit mantissa error)
    est = torch.abs(ua.to(torch.float64)) * torch.abs(ub.to(torch.float64))
    ok = est < float(2 ** 62)
    r, ok2 = rescale(prod, sa + sb, out.scale)
    return r, ok & ok2 & fits_precision(r, out.precision)


def cast_to_integral(u: torch.Tensor, scale: int) -> torch.Tensor:
    """decimal -> integral: truncate toward zero."""
    if scale == 0:
        return u
    mag = torch.div(torch.abs(u), 10 ** scale, rounding_mode="floor")
    return torch.where(u < 0, -mag, mag)


def to_double(u: torch.Tensor, scale: int) -> torch.Tensor:
    """decimal -> DOUBLE: the unscaled value over 10^scale, correctly
    rounded.  The divisor is a 0-d tensor on `u`'s device: PyTorch's CUDA
    true division by a Python scalar multiplies by the scalar's
    reciprocal, which lands 1 ulp off for some values (the reference's
    XLA rewrite does the same, ROADMAP Queue 3 item 1)."""
    return u.to(torch.float64) / host_constant(
        np.float64(10 ** scale), u.device)


def wide_to_double(lo: torch.Tensor, hi: torch.Tensor,
                   scale: int) -> torch.Tensor:
    """A two-lane DECIMAL (hi * 2^64 + unsigned lo) as DOUBLE: the
    reference's combination in float64 from 32-bit halves, then the
    unscale."""
    lo = lo.to(torch.int64)
    mask = 0xFFFFFFFF
    f = (hi.to(torch.float64) * 2.0 ** 64
         + ((lo >> 32) & mask).to(torch.float64) * 2.0 ** 32
         + (lo & mask).to(torch.float64))
    return f / host_constant(np.float64(10 ** scale), lo.device)


def from_double(x: torch.Tensor, out: t.DecimalType):
    """double -> decimal(p, s) with HALF_UP, null on overflow/NaN."""
    scaled = x.to(torch.float64) * float(10 ** out.scale)
    finite = torch.isfinite(scaled)
    bounded = torch.abs(scaled) < float(2 ** 62)
    safe = torch.where(finite & bounded, scaled, torch.zeros_like(scaled))
    mag = torch.floor(torch.abs(safe) + 0.5)
    u = torch.where(safe < 0, -mag, mag).to(torch.int64)
    return u, finite & bounded & fits_precision(u, out.precision)


def from_integral(v: torch.Tensor, out: t.DecimalType):
    u, ok = upscale(v.to(torch.int64), out.scale)
    return u, ok & fits_precision(u, out.precision)
