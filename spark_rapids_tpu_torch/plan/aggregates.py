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


class Sum(AggregateFunction):
    name = "sum"

    def _resolve(self):
        self.dtype = _sum_result_type(self.child.dtype)
        self.nullable = True

    def inputs(self):
        return [self.child]

    def update_ops(self):
        return [(G.SUM, self.dtype)]

    def merge_ops(self):
        return [(G.SUM, self.dtype)]

    def evaluate(self, refs):
        return refs[0]

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
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

    def inputs(self):
        if self._is_decimal():
            return [self.child, self.child]
        # sum in double space (Spark: avg sums as double for non-decimal)
        return [_resolved(E.Cast(self.child, t.DOUBLE)), self.child]

    def update_ops(self):
        return [(G.SUM, self._sum_type()), (G.COUNT, t.LONG)]

    def merge_ops(self):
        return [(G.SUM, self._sum_type()), (G.SUM, t.LONG)]

    def evaluate(self, refs):
        if self._is_decimal():
            return _DecimalAvgEvaluate(refs[0], refs[1], self.dtype)
        return E.Divide(refs[0], refs[1])

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        if self._is_decimal():
            sums, counts = g.reduce(np.add, v.data.astype(np.int64))
            q, ok = H.decimal_avg(sums, counts,
                                  self.dtype.scale - self.child.dtype.scale)
            return H.column(q, ok, self.dtype)
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
            out.append(E.Unported(
                "count(DISTINCT) over decimal128 (no single device lane; "
                f"the CPU engine waits on {E.WIDE_DECIMAL_SLICE})"))
        return out

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        if not len(g.gid):
            return _count_column(np.zeros(g.count, np.int64))
        ids, n = H.factorize([g.gid, H.order_lane(v)])
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


class _DecimalAvgEvaluate(E.Expression):
    """sum_buffer / count at Spark's avg scale (s+4), HALF_UP — exact
    integer arithmetic on the unscaled lanes (no float round-trip)."""

    def __init__(self, sum_e: E.Expression, count_e: E.Expression,
                 out_t: t.DecimalType):
        self.children = (sum_e, count_e)
        self.out_t = out_t
        self._resolve()

    def _resolve(self):
        self.dtype = self.out_t
        self.nullable = True

    def _eval_dev(self, ctx, kids):
        from ..ops import decimal as D
        from ..ops.kernels import merge_validity
        shift = self.out_t.scale - self.children[0].dtype.scale
        us, ok = D.upscale(kids[0].data.to(torch.int64), shift)
        c = kids[1].data.to(torch.int64)
        safe_c = torch.clamp(c, min=1)
        mag = torch.div(torch.abs(us) + torch.div(safe_c, 2,
                                                  rounding_mode="floor"),
                        safe_c, rounding_mode="floor")
        q = torch.where(us < 0, -mag, mag)
        valid = merge_validity(kids[0].validity, kids[1].validity,
                               ok & (c > 0))
        return E.DevVal(q, valid, self.out_t)

    def _fp_extra(self):
        return self.out_t.simple_string


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

    def evaluate(self, refs):
        n = E.Cast(refs[0], t.DOUBLE)
        s, ss = refs[1], refs[2]
        m2 = _clamp_nonneg(E.Subtract(ss, E.Divide(E.Multiply(s, s), n)))
        var = E.Divide(m2, E.Subtract(n, E.Literal(float(self.ddof),
                                                   t.DOUBLE)))
        return E.If(E.GreaterThan(refs[0], E.Literal(self.ddof, t.LONG)),
                    var, _null_double())

    def _finish(self, var: np.ndarray) -> np.ndarray:
        return var

    def cpu_agg(self, batch, groups):
        _c, v, g = self._valid_input(batch, groups)
        x = E._f64_np(v)
        n, m2 = _moments(x, x, g)
        ok = n > self.ddof
        with np.errstate(all="ignore"):
            var = m2 / np.where(ok, n - self.ddof, 1)
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
