"""Aggregate functions: Spark's declarative update/merge/evaluate model.

Counterpart of spark_rapids_tpu/plan/aggregates.py.  Every aggregate
declares its input projection(s), the update kinds producing partial
buffers (ops/groupby.py kinds), the merge kinds combining partials, and
the evaluate expression over the merged buffers — so partial, merge and
final phases all run through the same group-by kernels.

This slice ports Count, Sum, Average (decimal averages finish with
exact HALF_UP integer arithmetic), Min, Max, First, Last, BoolAnd,
BoolOr, CountDistinct (which exec/distinct.py runs) and the statistical
aggregates (VariancePop, VarianceSamp, StddevPop, StddevSamp, CovarPop,
CovarSamp, Corr), which lower to COUNT and SUM over projected moment
inputs and a final expression, so every group-by tier and the global
reduction run them unchanged.

On the CPU engine (exec/host_exec.CpuAggregateExec) each function's
`cpu_agg` reduces its input over the rows' group ids in numpy: the
counterpart of the reference's pyarrow `cpu_agg` and its python
fallbacks.  There MIN / MAX order floats as Java does (NaN greatest,
-0.0 below 0.0) and strings by value (their codes in a sorted
dictionary), and the statistical aggregates take two passes (the mean,
then the squared deviations), as the reference's CPU engine does.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types as t
from ..columnar.host import HostBatch, HostColumn
from ..config import TpuConf
from ..ops import groupby as G
from ..ops import host as H
from . import expressions as E


class AggregateFunction:
    """Base declarative aggregate."""
    name = "agg"

    def __init__(self, child: Optional[E.Expression]):
        self.child = child

    def bind(self, schema: t.StructType) -> "AggregateFunction":
        b = copy.copy(self)
        if self.child is not None:
            b.child = self.child.bind(schema)
        b._resolve()
        return b

    def _resolve(self):
        raise NotImplementedError

    def inputs(self) -> List[Optional[E.Expression]]:
        """Input expressions evaluated per batch (one per update op)."""
        raise NotImplementedError

    def update_ops(self) -> List[Tuple[str, t.DataType]]:
        """(kind, buffer dtype) per buffer column."""
        raise NotImplementedError

    def merge_ops(self) -> List[Tuple[str, t.DataType]]:
        raise NotImplementedError

    def evaluate(self, buffer_refs: List[E.Expression]) -> E.Expression:
        """Final expression over buffer columns (already bound refs)."""
        raise NotImplementedError

    def unsupported_reasons(self, conf: TpuConf) -> List[str]:
        out = []
        if not conf.is_op_enabled("expression", type(self).__name__):
            out.append(f"{type(self).__name__} disabled by conf")
        if self.child is not None:
            out += self.child.tree_unsupported(conf)
            if isinstance(self.child.dtype, (t.ArrayType, t.StructType,
                                             t.MapType, t.BinaryType)):
                out.append(f"{self.name} over "
                           f"{self.child.dtype.simple_string}")
            if E.consumes_wide_host(self.child):
                out.append(E.WIDE_HOST_REASON)
        return out

    def cpu_agg(self, batch: HostBatch, groups: H.Groups) -> HostColumn:
        """The aggregate of each group (`groups`: the rows' group ids)
        over `batch`, on the CPU engine."""
        raise NotImplementedError(type(self).__name__)

    def _valid_input(self, batch: HostBatch, groups: H.Groups):
        """(input column, its valid rows' values, their groups)."""
        col = self.child.eval_cpu(batch)
        if col.validity is None:
            return col, col, groups
        keep = col.validity
        return col, H.take(col, np.flatnonzero(keep)), groups.subset(keep)

    def __repr__(self):
        return f"{self.name}({self.child!r})"


def _count_column(counts: np.ndarray) -> HostColumn:
    return HostColumn(counts.astype(np.int64), None, t.LONG)


class Count(AggregateFunction):
    """count(expr) / count(*) — never null, 0 for an empty group."""
    name = "count"

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = False

    def inputs(self):
        return [self.child]          # None for count(*)

    def update_ops(self):
        return [(G.COUNT if self.child is not None else G.COUNT_ALL, t.LONG)]

    def merge_ops(self):
        return [(G.SUM, t.LONG)]

    def evaluate(self, refs):
        return E.Coalesce(refs[0], E.Literal(0, t.LONG))

    def unsupported_reasons(self, conf):
        if self.child is None:
            return []
        return AggregateFunction.unsupported_reasons(self, conf)

    def cpu_agg(self, batch, groups):
        if self.child is not None:
            _c, _v, groups = self._valid_input(batch, groups)
        return _count_column(np.bincount(groups.gid,
                                         minlength=groups.count))


def _sum_result_type(dt: t.DataType) -> t.DataType:
    if t.is_integral(dt):
        return t.LONG
    if isinstance(dt, (t.FloatType, t.DoubleType)):
        return t.DOUBLE
    if isinstance(dt, t.DecimalType):
        return t.DecimalType(min(38, dt.precision + 10), dt.scale)
    raise TypeError(f"sum over {dt}")


def _is_wide_decimal(dt: t.DataType) -> bool:
    return isinstance(dt, t.DecimalType) and dt.is_wide


def _halves(child: E.Expression) -> List[E.Expression]:
    return [_resolved(_HalfLane(child, False)),
            _resolved(_HalfLane(child, True))]


def uses_half_lanes(fn: "AggregateFunction") -> bool:
    """True for a SUM or AVG whose buffers are a wide DECIMAL sum's two
    half lanes: exact only while the aggregation reads at most
    `ROWS_EXACT` rows (`exec.aggregate.HashAggregate` holds it there)."""
    return isinstance(fn, (Sum, Average)) and fn._wide()


def _word_sums(v: HostColumn, g: H.Groups):
    """(h, a_lo, rows per group): the exact per-group sums of a DECIMAL
    column's valid rows `v` as the words of `_wide_words`, from the two
    32-bit half lanes in numpy; None where a value has a high word or a
    group passes `ROWS_EXACT` rows (the caller then sums Python ints)."""
    if v.hi is not None:
        return None
    x = v.data.astype(np.int64)
    lo, counts = g.reduce(np.add, x & _MASK32)
    if len(counts) and counts.max() > ROWS_EXACT:
        return None
    hi, _n = g.reduce(np.add, x >> 32)
    return (*_wide_words(lo, hi), counts)


class Sum(AggregateFunction):
    """SUM.  A DECIMAL sum whose result type passes 18 digits is exact
    on both engines: on the device its buffer is two int64 lanes, the
    sums of each input's low 32 bits (unsigned) and of its arithmetic
    high 32 bits (`_HalfLane`), which every group-by tier, the global
    reduction and the merges add as they add any LONG (exact up to
    `ROWS_EXACT` input rows); `_WideSumEvaluate` forms the 128-bit
    value, null past the result precision as Spark's non-ANSI sum."""
    name = "sum"

    def _resolve(self):
        self.dtype = _sum_result_type(self.child.dtype)
        self.nullable = True

    def _wide(self) -> bool:
        return _is_wide_decimal(self.dtype)

    def inputs(self):
        return _halves(self.child) if self._wide() else [self.child]

    def update_ops(self):
        if self._wide():
            return [(G.SUM, t.LONG), (G.SUM, t.LONG)]
        return [(G.SUM, self.dtype)]

    def merge_ops(self):
        return self.update_ops()

    def evaluate(self, refs):
        if self._wide():
            return _WideSumEvaluate(refs[0], refs[1], self.dtype)
        return refs[0]

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        if self._wide():
            words = _word_sums(v, g)
            if words is None:
                sums, counts = g.reduce(np.add, v.unscaled())
                return H.wide_column(sums, counts > 0, self.dtype)
            h, a_lo, counts = words
            return H.words_column(h, a_lo, counts > 0, self.dtype)
        lane = v.data.astype(t.physical_np_dtype(self.dtype))
        with np.errstate(over="ignore"):
            sums, counts = g.reduce(np.add, lane)
        return H.column(sums, counts > 0, self.dtype)


class Min(AggregateFunction):
    name = "min"
    _kind = G.MIN

    def _resolve(self):
        self.dtype = self.child.dtype
        self.nullable = True

    def inputs(self):
        return [self.child]

    def update_ops(self):
        return [(self._kind, self.dtype)]

    def merge_ops(self):
        return [(self._kind, self.dtype)]

    def evaluate(self, refs):
        return refs[0]

    def unsupported_reasons(self, conf):
        out = AggregateFunction.unsupported_reasons(self, conf)
        if isinstance(self.child.dtype, t.StringType):
            out.append("string min/max not yet on device")
        return out

    def cpu_agg(self, batch, groups):
        col, v, g = self._valid_input(batch, groups)
        ufunc = np.minimum if self._kind == G.MIN else np.maximum
        data = v.data
        if v.hi is not None:
            out, counts = g.reduce(ufunc, v.unscaled())
            return H.wide_column(out, counts > 0, self.dtype)
        if data.dtype.kind == "f":
            red, counts = g.reduce(ufunc, H.float_order(data,
                                                        signed_zero=True))
            out = H.float_from_order(red).astype(data.dtype)
        else:
            out, counts = g.reduce(ufunc, data)
        return H.column(out, counts > 0, self.dtype, col.dictionary)


class Max(Min):
    name = "max"
    _kind = G.MAX


class Average(AggregateFunction):
    name = "avg"

    def _is_decimal(self):
        return isinstance(self.child.dtype, t.DecimalType)

    def _resolve(self):
        if self._is_decimal():
            # Spark: avg(decimal(p,s)) -> decimal(p+4, s+4)
            d = self.child.dtype
            self.dtype = t.DecimalType(min(38, d.precision + 4),
                                       min(38, d.scale + 4))
        else:
            self.dtype = t.DOUBLE
        self.nullable = True

    def _sum_type(self) -> t.DataType:
        if self._is_decimal():
            d = self.child.dtype
            return t.DecimalType(min(38, d.precision + 10), d.scale)
        return t.DOUBLE

    def _wide(self) -> bool:
        return _is_wide_decimal(self._sum_type())

    def inputs(self):
        if self._wide():
            # the count reads the high half (the same object: projected,
            # gathered and counted once)
            lo, hi = _halves(self.child)
            return [lo, hi, hi]
        if self._is_decimal():
            return [self.child, self.child]
        # sum in double space (Spark: avg sums as double for non-decimal)
        return [_resolved(E.Cast(self.child, t.DOUBLE)), self.child]

    def update_ops(self):
        if self._wide():
            return [(G.SUM, t.LONG), (G.SUM, t.LONG), (G.COUNT, t.LONG)]
        return [(G.SUM, self._sum_type()), (G.COUNT, t.LONG)]

    def merge_ops(self):
        if self._wide():
            return [(G.SUM, t.LONG)] * 3
        return [(G.SUM, self._sum_type()), (G.SUM, t.LONG)]

    def _shift(self) -> int:
        return self.dtype.scale - self.child.dtype.scale

    def evaluate(self, refs):
        if self._is_decimal():
            return _DecimalAvgEvaluate(refs[:-1], refs[-1], self.dtype,
                                       self._shift())
        return E.Divide(refs[0], refs[1])

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        if self._is_decimal():
            words = _word_sums(v, g)
            if words is None:
                sums, counts = g.reduce(np.add, v.unscaled())
                return _exact_average(sums, counts, self.dtype,
                                      self._shift())
            return _average_words(*words, None, self.dtype, self._shift())
        sums, counts = g.reduce(np.add, E._f64_np(v))
        with np.errstate(all="ignore"):
            return H.column(sums / np.maximum(counts, 1), counts > 0,
                            t.DOUBLE)


class First(AggregateFunction):
    name = "first"

    def __init__(self, child, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def _resolve(self):
        self.dtype = self.child.dtype
        self.nullable = True

    def inputs(self):
        return [self.child]

    def _kind(self):
        return G.FIRST_NN if self.ignore_nulls else G.FIRST

    def update_ops(self):
        return [(self._kind(), self.dtype)]

    def merge_ops(self):
        return [(self._kind(), self.dtype)]

    def evaluate(self, refs):
        return refs[0]

    def cpu_agg(self, batch, groups):
        col = self.child.eval_cpu(batch)
        rows = np.arange(len(col), dtype=np.int64)
        if self.ignore_nulls and col.validity is not None:
            rows = rows[col.validity]
        pick = H.first_rows(groups.gid[rows], groups.count,
                            last=isinstance(self, Last))
        return H.take(col, np.where(pick >= 0, rows[np.maximum(pick, 0)]
                                    if len(rows) else -1, -1))


class Last(First):
    name = "last"

    def _kind(self):
        return G.LAST_NN if self.ignore_nulls else G.LAST


class BoolAnd(AggregateFunction):
    name = "bool_and"
    _kind = G.EVERY

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = True

    def inputs(self):
        return [self.child]

    def update_ops(self):
        return [(self._kind, t.BOOLEAN)]

    def merge_ops(self):
        return [(self._kind, t.BOOLEAN)]

    def evaluate(self, refs):
        return refs[0]

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        ufunc = np.logical_and if self._kind == G.EVERY else np.logical_or
        out, counts = g.reduce(ufunc, v.data.astype(bool))
        return H.column(out, counts > 0, t.BOOLEAN)


class BoolOr(BoolAnd):
    name = "bool_or"
    _kind = G.ANY


class CountDistinct(AggregateFunction):
    """count(DISTINCT x): never null, 0 for an empty group.  It has no
    update/merge buffers: an aggregation whose functions are all
    CountDistinct runs exec/distinct.py's sorted count instead of the
    hash aggregate (plan/overrides.py)."""
    name = "count_distinct"

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = False

    def inputs(self):
        return [self.child]

    def unsupported_reasons(self, conf):
        out = AggregateFunction.unsupported_reasons(self, conf)
        dt = self.child.dtype
        if isinstance(dt, t.DecimalType) and dt.is_wide:
            out.append("count(DISTINCT) over decimal128 "
                       "(no single device lane)")
        return out

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        if not len(g.gid):
            return _count_column(np.zeros(g.count, np.int64))
        ids, n = H.factorize([g.gid] + H.order_lanes(v))
        pair_group = np.empty(n, np.int64)
        pair_group[ids] = g.gid             # each pair lies in one group
        return _count_column(np.bincount(pair_group, minlength=g.count))


def _resolved(e: E.Expression) -> E.Expression:
    """Resolve an expression wrapped around already-bound children."""
    e._resolve()
    return e


def _deep_resolved(e: E.Expression) -> E.Expression:
    """Recursively resolve an evaluate() tree whose leaves (buffer refs,
    literals) are already bound but whose inner nodes are not."""
    for c in e.children:
        if getattr(c, "dtype", None) is None:
            _deep_resolved(c)
    if getattr(e, "dtype", None) is None:
        e._resolve()
    return e


_MASK32 = 0xFFFFFFFF
#: A wide DECIMAL sum's half lanes are exact while the aggregation reads
#: at most this many rows: the low lane's sum, read as unsigned, stays
#: below 2^64, and the high lane's within int64.
ROWS_EXACT = (1 << 32) - 1
# A quotient's vectorised step needs |upscaled sum| below this (no
# overflow in |us| + count / 2).
_QUOT_SAFE = 1 << 62


class _HalfLane(E.Expression):
    """One 32-bit half of an int64 DECIMAL lane as a LONG: the low half
    taken unsigned, or the arithmetic high half.  A wide SUM's buffer
    sums the two apart (`Sum`); hi * 2^32 + lo is the exact sum."""

    def __init__(self, child: E.Expression, high: bool):
        self.children = (child,)
        self.high = high

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = self.children[0].nullable

    def _eval_dev(self, ctx, kids):
        x = kids[0].data.to(torch.int64)
        return E.DevVal(x >> 32 if self.high else x & _MASK32,
                        kids[0].validity, t.LONG)

    def _eval_cpu(self, batch, kids):
        x = kids[0].data.astype(np.int64)
        return H.column(x >> 32 if self.high else x & _MASK32,
                        kids[0].validity, t.LONG)

    def _fp_extra(self):
        return "hi" if self.high else "lo"


def _wide_words(lo_sum, hi_sum):
    """(h, a_lo): the 128-bit value hi_sum * 2^32 + lo_sum, lo_sum read as
    unsigned, as h * 2^32 + a_lo with 0 <= a_lo < 2^32, both int64 (no
    step overflows up to `ROWS_EXACT` rows).  numpy arrays or torch
    tensors."""
    return hi_sum + ((lo_sum >> 32) & _MASK32), lo_sum & _MASK32


def _fits_words(h: torch.Tensor, a_lo: torch.Tensor, p: int
                ) -> torch.Tensor:
    """|h * 2^32 + a_lo| <= 10^p - 1, compared in int64 words."""
    b = 10 ** p - 1
    ok = torch.ones_like(h, dtype=torch.bool)
    q, r = b >> 32, b & _MASK32
    if q < 2 ** 63 - 1:
        ok &= (h < q) | ((h == q) & (a_lo <= r))
    nq, nr = (-b) >> 32, (-b) & _MASK32
    if nq > -2 ** 63:
        ok &= (h > nq) | ((h == nq) & (a_lo >= nr))
    return ok


def past_rows_error(rows: int) -> NotImplementedError:
    return NotImplementedError(
        f"an aggregation over {rows} rows (more than {ROWS_EXACT}) passes "
        "the exact range of a wide DECIMAL sum's half lanes "
        f"({E.WIDE_DECIMAL_SLICE})")


class _WideSumEvaluate(E.Expression):
    """The finished wide DECIMAL sum from its two half-lane buffers: the
    low word (h's low 32 bits above a_lo, as a signed int64) and the
    high word (h >> 32), null past the result precision.  The result
    carries the high word (`DevVal.hi`); a consumer reads one int64 lane
    only where every value fits it (`expressions.narrow_dev`)."""

    def __init__(self, lo_e: E.Expression, hi_e: E.Expression,
                 out_t: t.DecimalType):
        self.children = (lo_e, hi_e)
        self.out_t = out_t
        self._resolve()

    def _resolve(self):
        self.dtype = self.out_t
        self.nullable = True

    def _eval_dev(self, ctx, kids):
        from ..ops.kernels import merge_validity
        live = merge_validity(kids[0].validity, kids[1].validity)
        h, a_lo = _wide_words(kids[0].data.to(torch.int64),
                              kids[1].data.to(torch.int64))
        low32 = h & _MASK32
        signed32 = (low32 ^ (1 << 31)) - (1 << 31)
        lo = signed32 * (1 << 32) + a_lo
        valid = merge_validity(live,
                               _fits_words(h, a_lo, self.out_t.precision))
        return E.DevVal(lo, valid, self.out_t, hi=h >> 32)

    def _eval_cpu(self, batch, kids):
        live = H.and_valid(kids[0].validity, kids[1].validity)
        h, a_lo = _wide_words(kids[0].data.astype(np.int64),
                              kids[1].data.astype(np.int64))
        return H.words_column(h, a_lo, live, self.out_t)

    def _fp_extra(self):
        return self.out_t.simple_string


def _half_up_quotient(us, counts):
    """us / counts rounded half away from zero, for |us| < `_QUOT_SAFE`
    (a count <= 0 is taken as 1): numpy arrays or torch tensors."""
    safe = counts * (counts > 0) + (counts <= 0)
    mag = (abs(us) + safe // 2) // safe
    return mag - 2 * mag * (us < 0)


_M16 = 0xFFFF
#: a count below this divides exactly in 16-bit limbs (no int64 step
#: overflows): 2^47 rows, far past what one query can aggregate
_COUNT_LIMBS16 = 1 << 47


def _exact_average_dev(h: torch.Tensor, a_lo: torch.Tensor,
                       counts: torch.Tensor, shift: int, p: int):
    """(lo int64, hi int64, fits bool): (h * 2^32 + a_lo) * 10^shift /
    counts, HALF_UP, as the 128-bit two's complement words lo + hi *
    2^64, and whether it has at most `p` digits; on the device with no
    host read, in eight 16-bit limbs of the magnitude (schoolbook
    multiply and long division).  Every group computes it and the fast
    quotient keeps the groups within int64: a graph cannot bring the
    rare rest to the host, and the eager path then needs no sync."""
    neg = h < 0
    carry = neg & (a_lo > 0)
    hh = torch.where(neg, torch.where(carry, -h - 1, -h), h)
    ll = torch.where(carry, (1 << 32) - a_lo, a_lo)
    limbs = [ll & _M16, ll >> 16, hh & _M16, (hh >> 16) & _M16,
             (hh >> 32) & _M16, (hh >> 48) & _M16,
             torch.zeros_like(h), torch.zeros_like(h)]
    over = torch.zeros_like(neg)
    left = shift
    while left > 0:
        step = min(left, 4)
        left -= step
        g = 10 ** step
        c = torch.zeros_like(h)
        for i in range(8):
            v = limbs[i] * g + c
            limbs[i] = v & _M16
            c = v >> 16
        over = over | (c != 0)
    den = torch.clamp(counts, min=1)
    rem = torch.zeros_like(h)
    q = [None] * 8
    for i in range(7, -1, -1):
        v = (rem << 16) | limbs[i]
        q[i] = v // den
        rem = v - q[i] * den
    # HALF_UP: add one when the remainder is at least half the count
    c = (2 * rem >= den).to(torch.int64)
    for i in range(8):
        v = q[i] + c
        q[i] = v & _M16
        c = v >> 16
    over = over | (c != 0) | (counts >= _COUNT_LIMBS16)
    gt = torch.zeros_like(neg)
    eq = torch.ones_like(neg)
    b = 10 ** p - 1
    for i in range(7, -1, -1):
        bi = (b >> (16 * i)) & _M16
        gt = gt | (eq & (q[i] > bi))
        eq = eq & (q[i] == bi)
    lo = q[0] | (q[1] << 16) | (q[2] << 32) | (q[3] << 48)
    hi = q[4] | (q[5] << 16) | (q[6] << 32) | (q[7] << 48)
    nlo = -lo
    nhi = ~hi + (lo == 0).to(torch.int64)
    fits = ~gt & ~over
    zero = torch.zeros_like(lo)
    return (torch.where(fits, torch.where(neg, nlo, lo), zero),
            torch.where(fits, torch.where(neg, nhi, hi), zero), fits)


def _exact_average(sums: np.ndarray, counts: np.ndarray,
                   out_t: t.DecimalType, shift: int) -> HostColumn:
    """Per-group sum / count at `shift` more digits of scale, HALF_UP,
    in Python ints; null for an empty group and past the precision."""
    f = 10 ** shift
    q = [H._div_half_up(int(s) * f, int(c)) if c > 0 else 0
         for s, c in zip(sums.tolist(), counts.tolist())]
    return H.wide_column(np.array(q + [0], object)[:-1],
                         np.asarray(counts) > 0, out_t)


def _average_words(h: np.ndarray, a_lo: np.ndarray, counts: np.ndarray,
                   validity: Optional[np.ndarray], out_t: t.DecimalType,
                   shift: int) -> HostColumn:
    """The CPU engine's `_DecimalAvgEvaluate`: the groups whose upscaled
    sum stays within int64 divide in numpy, the rest in Python ints."""
    s, fits = H.words_int64(h, a_lo)
    us, ok = H.upscale(s, shift)
    live = H.valid_of(validity, len(s)) & (counts > 0)
    fast = fits & ok & (us < _QUOT_SAFE) & (us > -_QUOT_SAFE)
    base = H.wide_column(np.where(fast, _half_up_quotient(us, counts), 0),
                         live & fast, out_t)
    redo = np.flatnonzero(live & ~fast)
    if not len(redo):
        return base
    return H.patch_rows(base, redo, _exact_average(
        H.words_ints(h[redo], a_lo[redo]), counts[redo], out_t, shift))


class _DecimalAvgEvaluate(E.Expression):
    """AVG(DECIMAL)'s finish, grouped and global: sum / count at Spark's
    result scale (s + 4), HALF_UP, exact.  The sum is one int64 lane, or
    the two half lanes of a sum type past 18 digits (`Sum`).  Every group
    whose upscaled sum stays within int64 divides in one vectorised step
    on the device; the groups that leave it divide exactly on the device
    too (`_exact_average_dev`), so the finish never syncs."""

    def __init__(self, sums: List[E.Expression], count_e: E.Expression,
                 out_t: t.DecimalType, shift: int):
        self.children = (*sums, count_e)
        self.out_t = out_t
        self.shift = shift
        self._resolve()

    def _resolve(self):
        self.dtype = self.out_t
        self.nullable = True

    def _words(self, lanes):
        if len(lanes) == 2:
            return _wide_words(*lanes)
        return lanes[0] >> 32, lanes[0] & _MASK32

    def _eval_dev(self, ctx, kids):
        from ..ops import decimal as D
        from ..ops.kernels import merge_validity
        lanes = [k.data.to(torch.int64) for k in kids]
        c = lanes[-1]
        h, a_lo = self._words(lanes[:-1])
        s, fits = H.words_int64(h, a_lo)
        us, ok = D.upscale(s, self.shift)
        live = merge_validity(*(k.validity for k in kids), c > 0)
        fast = fits & ok & (us < _QUOT_SAFE) & (us > -_QUOT_SAFE)
        q = _half_up_quotient(us, c)
        valid = live & fast & D.fits_precision(q, self.out_t.precision)
        slow = live & ~fast
        hi = q >> 63 if self.out_t.is_wide else None
        elo, ehi, efits = _exact_average_dev(h, a_lo, c, self.shift,
                                             self.out_t.precision)
        q = torch.where(slow, elo, q)
        valid = torch.where(slow, live & efits, valid)
        if hi is not None:
            hi = torch.where(slow, ehi, hi)
        return E.DevVal(q, valid, self.out_t, hi=hi)

    def _eval_cpu(self, batch, kids):
        lanes = [k.data.astype(np.int64) for k in kids]
        live = H.and_valid(*(k.validity for k in kids))
        return _average_words(*self._words(lanes[:-1]), lanes[-1], live,
                              self.out_t, self.shift)

    def _fp_extra(self):
        return f"{self.out_t.simple_string};{self.shift}"


# ---------------------------------------------------------------------------
# Statistical aggregates: COUNT and SUM over projected moments, as the
# reference composes them; no kernel of their own
# ---------------------------------------------------------------------------

def _moments(x: np.ndarray, y: np.ndarray, g: H.Groups):
    """(rows per group, sum of (x - mean x)(y - mean y) per group): the
    two-pass form of the reference's CPU engine."""
    sx, n = g.reduce(np.add, x)
    sy, _n = g.reduce(np.add, y)
    with np.errstate(all="ignore"):
        mx = sx / np.maximum(n, 1)
        my = sy / np.maximum(n, 1)
        dev = (x - mx[g.gid]) * (y - my[g.gid])
    out, _n = g.reduce(np.add, dev)
    return n, out


def _null_double():
    return E.Literal(None, t.DOUBLE)


def _clamp_nonneg(e: E.Expression) -> E.Expression:
    """max(e, 0): the moment formula ss - s^2/n can round to a tiny
    negative for a constant column; a variance is never negative.  The
    test is `e < 0`, so a NaN moment (a NaN input) stays NaN."""
    zero = E.Literal(0.0, t.DOUBLE)
    return E.If(E.LessThan(e, zero), zero, e)


def _masked_pair(x: E.Expression, other: E.Expression) -> E.Expression:
    """x where the partner is non-null: the binary statistics drop rows
    with either side null."""
    return _resolved(E.If(E.IsNotNull(other), x, _null_double()))


class VariancePop(AggregateFunction):
    """var_pop: buffers (n, sum x, sum x^2), merged by summation; the final
    (ss - s^2/n) / (n - ddof) runs in float64 (the moment form can lose
    digits to cancellation when the mean dwarfs the spread, as the
    reference's does).  Null for n <= ddof (Spark 3.1+: n = 0, and n = 1
    for the sample forms)."""
    name = "var_pop"
    ddof = 0

    def _resolve(self):
        self.dtype = t.DOUBLE
        self.nullable = True
        self._xd = _resolved(E.Cast(self.child, t.DOUBLE))

    def inputs(self):
        return [self.child, self._xd,
                _resolved(E.Multiply(self._xd, self._xd))]

    def update_ops(self):
        return [(G.COUNT, t.LONG), (G.SUM, t.DOUBLE), (G.SUM, t.DOUBLE)]

    def merge_ops(self):
        return [(G.SUM, t.LONG), (G.SUM, t.DOUBLE), (G.SUM, t.DOUBLE)]

    def _legacy_nan(self) -> bool:
        """Spark < 3.1 (SPARK-33726): the sample variance of one row is
        NaN, not null; `_shims` (shims.py) is set at plan conversion
        (plan/overrides.AggregateMeta)."""
        shims = getattr(self, "_shims", None)
        return self.ddof == 1 and shims is not None and \
            shims.legacy_statistical_aggregate

    def evaluate(self, refs):
        n = E.Cast(refs[0], t.DOUBLE)
        s, ss = refs[1], refs[2]
        m2 = _clamp_nonneg(E.Subtract(ss, E.Divide(E.Multiply(s, s), n)))
        var = E.Divide(m2, E.Subtract(n, E.Literal(float(self.ddof),
                                                   t.DOUBLE)))
        empty = _null_double()
        if self._legacy_nan():
            empty = E.If(E.EqualTo(refs[0], E.Literal(1, t.LONG)),
                         E.Literal(float("nan"), t.DOUBLE), empty)
        return E.If(E.GreaterThan(refs[0], E.Literal(self.ddof, t.LONG)),
                    var, empty)

    def _finish(self, var: np.ndarray) -> np.ndarray:
        return var

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        x = E._f64_np(v)
        n, m2 = _moments(x, x, g)
        ok = n > self.ddof
        with np.errstate(all="ignore"):
            var = m2 / np.where(ok, n - self.ddof, 1)
        if self._legacy_nan():
            var = np.where(n == 1, np.nan, var)
            ok = ok | (n == 1)
        return H.column(self._finish(var), ok, t.DOUBLE)


class VarianceSamp(VariancePop):
    name = "var_samp"
    ddof = 1


class StddevPop(VariancePop):
    name = "stddev_pop"

    def evaluate(self, refs):
        return E.Sqrt(super().evaluate(refs))

    def _finish(self, var):
        with np.errstate(invalid="ignore"):
            return np.sqrt(var)


class StddevSamp(StddevPop):
    name = "stddev_samp"
    ddof = 1


class _BinaryStatAgg(AggregateFunction):
    """corr / covar over two children, complete pairs only."""

    def __init__(self, x: E.Expression, y: E.Expression):
        super().__init__(x)
        self.child2 = y

    def bind(self, schema):
        b = copy.copy(self)
        b.child = self.child.bind(schema)
        b.child2 = self.child2.bind(schema)
        b._resolve()
        return b

    def unsupported_reasons(self, conf):
        return AggregateFunction.unsupported_reasons(self, conf) + \
            self.child2.tree_unsupported(conf)

    def _resolve(self):
        self.dtype = t.DOUBLE
        self.nullable = True
        xd = _resolved(E.Cast(self.child, t.DOUBLE))
        yd = _resolved(E.Cast(self.child2, t.DOUBLE))
        self._x = _masked_pair(xd, self.child2)
        self._y = _masked_pair(yd, self.child)

    def _pair_count_input(self):
        # null unless both sides are: COUNT counts the complete pairs
        return _resolved(E.Multiply(self._x, self._y))

    def _pairs(self, batch, groups):
        """(x, y, groups) of the rows where both sides are valid."""
        a = self.child.eval_cpu(batch)
        b = self.child2.eval_cpu(batch)
        keep = H.and_valid(a.validity, b.validity)
        if keep is None:
            return E._f64_np(a), E._f64_np(b), groups
        return (E._f64_np(a)[keep], E._f64_np(b)[keep],
                groups.subset(keep))

    def __repr__(self):
        return f"{self.name}({self.child!r}, {self.child2!r})"


class CovarPop(_BinaryStatAgg):
    """covar_pop: buffers (n, sum x, sum y, sum xy); (sxy - sx sy / n) /
    (n - ddof), null for n <= ddof."""
    name = "covar_pop"
    ddof = 0

    def inputs(self):
        xy = self._pair_count_input()
        return [xy, self._x, self._y, xy]

    def update_ops(self):
        return [(G.COUNT, t.LONG)] + [(G.SUM, t.DOUBLE)] * 3

    def merge_ops(self):
        return [(G.SUM, t.LONG)] + [(G.SUM, t.DOUBLE)] * 3

    def evaluate(self, refs):
        n = E.Cast(refs[0], t.DOUBLE)
        sx, sy, sxy = refs[1], refs[2], refs[3]
        num = E.Subtract(sxy, E.Divide(E.Multiply(sx, sy), n))
        cov = E.Divide(num, E.Subtract(n, E.Literal(float(self.ddof),
                                                    t.DOUBLE)))
        return E.If(E.GreaterThan(refs[0], E.Literal(self.ddof, t.LONG)),
                    cov, _null_double())

    def cpu_agg(self, batch, groups):
        x, y, g = self._pairs(batch, groups)
        n, sxy = _moments(x, y, g)
        ok = n > self.ddof
        with np.errstate(all="ignore"):
            return H.column(sxy / np.where(ok, n - self.ddof, 1), ok,
                            t.DOUBLE)


class CovarSamp(CovarPop):
    name = "covar_samp"
    ddof = 1


class Corr(_BinaryStatAgg):
    """corr: cov / sqrt(var_x var_y) from (n, sx, sy, sxy, sxx, syy);
    null for n = 0, NaN where a variance is zero (Spark; Divide alone
    would give null)."""
    name = "corr"

    def inputs(self):
        xy = self._pair_count_input()
        return [xy, self._x, self._y, xy,
                _resolved(E.Multiply(self._x, self._x)),
                _resolved(E.Multiply(self._y, self._y))]

    def update_ops(self):
        return [(G.COUNT, t.LONG)] + [(G.SUM, t.DOUBLE)] * 5

    def merge_ops(self):
        return [(G.SUM, t.LONG)] + [(G.SUM, t.DOUBLE)] * 5

    def evaluate(self, refs):
        n = E.Cast(refs[0], t.DOUBLE)
        sx, sy, sxy, sxx, syy = refs[1:6]
        cov = E.Subtract(sxy, E.Divide(E.Multiply(sx, sy), n))
        vx = _clamp_nonneg(E.Subtract(sxx, E.Divide(E.Multiply(sx, sx), n)))
        vy = _clamp_nonneg(E.Subtract(syy, E.Divide(E.Multiply(sy, sy), n)))
        denom = E.Sqrt(E.Multiply(vx, vy))
        corr = E.If(E.EqualTo(denom, E.Literal(0.0, t.DOUBLE)),
                    E.Literal(float("nan"), t.DOUBLE),
                    E.Divide(cov, denom))
        return E.If(E.GreaterThan(refs[0], E.Literal(0, t.LONG)), corr,
                    _null_double())

    def cpu_agg(self, batch, groups):
        x, y, g = self._pairs(batch, groups)
        n, sxy = _moments(x, y, g)
        _n, sxx = _moments(x, x, g)
        _n, syy = _moments(y, y, g)
        with np.errstate(all="ignore"):
            d = np.sqrt(sxx * syy)
            out = np.where(d != 0, sxy / np.where(d != 0, d, 1.0), np.nan)
        return H.column(out, n > 0, t.DOUBLE)


# ---------------------------------------------------------------------------
# The holistic aggregates: collect_list / collect_set (exec/collect.py)
# and the percentile family (exec/percentile.py) on the device; `cpu_agg`
# on the CPU engine
# ---------------------------------------------------------------------------

class CollectList(AggregateFunction):
    """collect_list as a device group-by emitting a ragged column
    (exec/collect.py CollectAggregateExec over ops/percentile.py
    `collect_trace`): a group's non-null values in input order.  Flat
    element types only."""
    name = "collect_list"

    def _resolve(self):
        self.dtype = t.ArrayType(self.child.dtype)
        self.nullable = False

    def inputs(self):
        return [self.child]

    def unsupported_reasons(self, conf):
        out = [] if conf is None or \
            conf.is_op_enabled("expression", type(self).__name__) \
            else [f"{type(self).__name__} disabled by conf"]
        if self.child is not None and conf is not None:
            out += self.child.tree_unsupported(conf)
        if self.child is not None and E.consumes_wide_host(self.child):
            out.append(E.WIDE_HOST_REASON)
        dt = None if self.child is None else self.child.dtype
        if isinstance(dt, (t.ArrayType, t.MapType, t.StructType,
                           t.BinaryType)):
            out.append(f"collect over {dt.simple_string} "
                       "(nested elements have no flat values lane)")
        if isinstance(dt, t.DecimalType) and dt.is_wide:
            out.append("collect over decimal(>18)")
        return out

    def _kept(self, col: HostColumn, order: np.ndarray,
              gid: np.ndarray) -> np.ndarray:
        """The rows (in group order) that enter each group's list."""
        return order

    def cpu_agg(self, batch, groups):
        from ..columnar.host import list_column
        col = self.child.eval_cpu(batch)
        order, _starts, _counts = groups.bounds()
        order = order[H.valid_of(col.validity, len(col))[order]]
        order = self._kept(col, order, groups.gid[order])
        counts = np.bincount(groups.gid[order], minlength=groups.count)
        off = np.zeros(groups.count + 1, np.int64)
        off[1:] = np.cumsum(counts)
        values = H.take(col, order)
        values.validity = None
        return list_column(values, off)


class CollectSet(CollectList):
    """collect_set: a group's distinct non-null values (Spark's set
    equality: every NaN one value, -0.0 equal to 0.0, which comes out
    as 0.0), the first occurrence of each in input order."""
    name = "collect_set"

    def _kept(self, col, order, gid):
        if not len(order):
            return order
        ids, n = H.factorize([gid, H.order_lane(H.take(col, order))])
        first = H.first_of_ids(ids, n)
        return order[np.sort(first)]

    def cpu_agg(self, batch, groups):
        out = CollectList.cpu_agg(self, batch, groups)
        if out.data.dtype.kind == "f":
            out.data = out.data + out.data.dtype.type(0.0)
        return out


def _percentile_values(col: HostColumn):
    """(the values as float64, Spark-ordered within each run by the
    caller) of a numeric column."""
    if isinstance(col.dtype, t.DecimalType):
        return H.decimal_to_double(col.data, col.dtype.scale)
    return col.data.astype(np.float64)


class Percentile(AggregateFunction):
    """percentile(col, p), exact.  plan/overrides.py routes an
    aggregation of only percentile functions to the device sort-segment
    path (exec/percentile.py PercentileAggregateExec over
    ops/percentile.py); `cpu_agg` is the CPU engine's: linear
    interpolation at (n - 1) * p over the group's non-null values with
    NaN the greatest (the reference's `_percentile_exact`)."""
    name = "percentile"

    def __init__(self, child: E.Expression, percentage: float):
        super().__init__(child)
        assert 0.0 <= percentage <= 1.0
        self.percentage = percentage

    def _resolve(self):
        self.dtype = t.DOUBLE
        self.nullable = True

    def inputs(self):
        return [self.child]

    def unsupported_reasons(self, conf):
        out = AggregateFunction.unsupported_reasons(self, conf)
        if self.child is not None and self.child.dtype is not None and \
                not t.is_numeric(self.child.dtype):
            out.append(f"percentile over "
                       f"{self.child.dtype.simple_string} (numeric only)")
        return out

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        vals = _percentile_values(v)
        order = np.lexsort((H.float_order(vals), g.gid))
        counts = np.bincount(g.gid, minlength=g.count).astype(np.int64)
        starts = np.cumsum(counts) - counts
        s = vals[order]
        pos = (np.maximum(counts, 1) - 1).astype(np.float64) * \
            self.percentage
        lo = np.floor(pos).astype(np.int64)
        frac = pos - lo
        hi = np.minimum(lo + 1, np.maximum(counts - 1, 0))
        have = counts > 0
        v_lo = np.where(have, s[np.minimum(starts + lo, len(s) - 1)]
                        if len(s) else 0.0, 0.0)
        v_hi = np.where(have, s[np.minimum(starts + hi, len(s) - 1)]
                        if len(s) else 0.0, 0.0)
        with np.errstate(invalid="ignore"):
            out = np.where(frac == 0.0, v_lo,
                           v_lo * (1 - frac) + v_hi * frac)
        return H.column(out, have, t.DOUBLE)

    def __repr__(self):
        return f"percentile({self.child!r}, {self.percentage})"


class ApproximatePercentile(Percentile):
    """approx_percentile: exact on a single batch (zero rank error); over
    several batches the device path merges per-batch equi-rank sketches
    (ops/quantile_sketch.py).  The CPU engine's is exact."""
    name = "approx_percentile"


class Median(Percentile):
    name = "median"

    def __init__(self, child: E.Expression):
        super().__init__(child, 0.5)
