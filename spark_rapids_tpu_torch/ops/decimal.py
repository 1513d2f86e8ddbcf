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

import torch

from .. import types as t

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


def integral_as_decimal(dt: t.DataType) -> t.DecimalType:
    return {t.ByteType: t.DecimalType(3, 0), t.ShortType: t.DecimalType(5, 0),
            t.IntegerType: t.DecimalType(10, 0),
            t.LongType: t.DecimalType(20, 0)}[type(dt)]


def _ones(u: torch.Tensor) -> torch.Tensor:
    return torch.ones(u.shape, dtype=torch.bool, device=u.device)


def upscale(u: torch.Tensor, ds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """u * 10^ds with int64-overflow detection -> (value, ok)."""
    if ds == 0:
        return u, _ones(u)
    f = 10 ** ds
    return u * f, torch.abs(u) <= _I64_MAX // f


def downscale_half_up(u: torch.Tensor, ds: int) -> torch.Tensor:
    """u / 10^ds rounding half away from zero (Spark HALF_UP)."""
    if ds == 0:
        return u
    f = 10 ** ds
    mag = torch.div(torch.abs(u) + f // 2, f, rounding_mode="floor")
    return torch.where(u < 0, -mag, mag)


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
    return torch.abs(u) <= max_unscaled(p)


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
    return u.to(torch.float64) / torch.tensor(
        float(10 ** scale), dtype=torch.float64, device=u.device)


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
