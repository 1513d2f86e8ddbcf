"""Expression trees evaluated on torch tensors.

Counterpart of spark_rapids_tpu/plan/expressions.py.  This slice ports
the device evaluation (`eval_dev`) of what the ported TPC-H queries and
the MIN/MAX/FIRST/LAST group-bys reach: column references, literals,
aliases, + - * (integral, floating and decimal with Spark's result-type
rules and overflow-to-null), / on doubles, the six comparisons (numeric,
date and decimal), = and != of a dictionary-coded string column against
a string literal or another string column, Kleene AND/OR/NOT, IS [NOT]
NULL, COALESCE, IF, CASE WHEN, IN and numeric/decimal casts (floating to
integral as the reference truncates and clamps).  Anything
else reports itself in `unsupported_reasons`, and plan/overrides.py
refuses the plan with that reason: the port has no CPU engine to fall
back to yet.

Evaluation keeps the reference's two phases: a host `prepare` walk
(dictionary metadata) and the device `eval_dev` walk, which here runs
eagerly on tensors of one batch instead of being traced into an XLA
program.

Spark (non-ANSI) semantics as in the reference: integer ops wrap like
Java; division by zero -> NULL; three-valued AND/OR; comparisons null
out when either side is null.
"""
from __future__ import annotations

import copy
import datetime as pydt
import decimal as pydec
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as t
from ..config import TpuConf
from ..ops.kernels import compute_dtype, merge_validity, valid_or_true


class PrepCtx:
    """Host-phase context: the batch's dictionaries."""

    def __init__(self, conf: TpuConf, dicts: Dict[str, Optional[np.ndarray]]):
        self.conf = conf
        self.dicts = dicts            # input column name -> dictionary


class HostVal:
    """Per-node host metadata flowing through prepare (dictionaries)."""

    def __init__(self, dictionary: Optional[np.ndarray] = None):
        self.dictionary = dictionary


class EvalCtx:
    """Device-phase context: one batch's input lanes."""

    def __init__(self, capacity: int, num_rows, inputs, conf: TpuConf,
                 device):
        self.capacity = capacity
        self.num_rows = num_rows
        self.inputs = inputs          # name -> DevVal
        self.conf = conf
        self.device = device

    def full(self, value, dtype) -> torch.Tensor:
        return torch.full((self.capacity,), value, dtype=dtype,
                          device=self.device)


class DevVal:
    """A column value on the device: compute lane + validity (None = all
    rows valid) + logical type (+ dictionary for strings)."""

    def __init__(self, data, validity, dtype: t.DataType,
                 dictionary: Optional[np.ndarray] = None):
        self.data = data
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary


class Expression:
    children: Tuple["Expression", ...] = ()
    dtype: t.DataType = None
    nullable: bool = True

    # ---- resolution ----
    def bind(self, schema: t.StructType) -> "Expression":
        """Return a copy with children bound and dtype resolved."""
        bound = self._with_children([c.bind(schema) for c in self.children])
        bound._resolve()
        return bound

    def _with_children(self, kids) -> "Expression":
        c = copy.copy(self)
        c.children = tuple(kids)
        return c

    def _resolve(self):
        raise NotImplementedError(type(self).__name__)

    # ---- tagging ----
    def unsupported_reasons(self, conf: TpuConf) -> List[str]:
        """Reasons THIS node can't run on the device ([] = supported)."""
        return []

    def tree_unsupported(self, conf: TpuConf) -> List[str]:
        out = []
        if not conf.is_op_enabled("expression", type(self).__name__):
            out.append(f"{type(self).__name__} disabled by conf")
        out += [f"{type(self).__name__}: {r}"
                for r in self.unsupported_reasons(conf)]
        for c in self.children:
            out += c.tree_unsupported(conf)
        return out

    # ---- host phase ----
    def prepare(self, pctx: PrepCtx) -> HostVal:
        kids = [c.prepare(pctx) for c in self.children]
        return self._prepare(pctx, kids)

    def _prepare(self, pctx: PrepCtx, kids: List[HostVal]) -> HostVal:
        return HostVal()

    # ---- device phase ----
    def eval_dev(self, ctx: EvalCtx) -> DevVal:
        kids = [c.eval_dev(ctx) for c in self.children]
        return self._eval_dev(ctx, kids)

    def _eval_dev(self, ctx: EvalCtx, kids: List[DevVal]) -> DevVal:
        raise NotImplementedError(type(self).__name__)

    # ---- identity ----
    def fingerprint(self) -> str:
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}({self._fp_extra()};{kids})"

    def _fp_extra(self) -> str:
        return ""

    def __repr__(self):
        return self.fingerprint()



# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class ColumnRef(Expression):
    def __init__(self, name: str):
        self.name = name
        self.children = ()

    def bind(self, schema: t.StructType) -> "Expression":
        b = ColumnRef(self.name)
        f = schema[self.name]
        b.dtype = f.data_type
        b.nullable = f.nullable
        return b

    def _prepare(self, pctx, kids):
        return HostVal(pctx.dicts.get(self.name))

    def _eval_dev(self, ctx, kids):
        return ctx.inputs[self.name]

    def _fp_extra(self):
        return self.name


class Literal(Expression):
    def __init__(self, value, dtype: Optional[t.DataType] = None):
        self.value = value
        self.children = ()
        self.dtype = dtype if dtype is not None else self._infer(value)
        self.nullable = value is None

    @staticmethod
    def _infer(v) -> t.DataType:
        if v is None:
            return t.NULL
        if isinstance(v, bool):
            return t.BOOLEAN
        if isinstance(v, int):
            return t.INT if -(2**31) <= v < 2**31 else t.LONG
        if isinstance(v, float):
            return t.DOUBLE
        if isinstance(v, str):
            return t.STRING
        if isinstance(v, pydec.Decimal):
            _sign, digits, exp = v.as_tuple()
            scale = max(0, -exp)
            # positive exponents widen the integral part: 1E+2 is 100 ->
            # 3 integral digits, decimal(3, 0)
            integral = len(digits) + max(exp, 0)
            precision = max(integral + scale if exp >= 0 else len(digits),
                            scale + 1)
            return t.DecimalType(min(precision, 38), scale)
        if isinstance(v, pydt.datetime):
            return t.TIMESTAMP
        if isinstance(v, pydt.date):
            return t.DATE
        raise TypeError(f"cannot infer literal type of {v!r}")

    def _physical_value(self):
        """Host value -> device lane value per the storage mapping."""
        v, dt = self.value, self.dtype
        if isinstance(dt, t.DecimalType):
            d = v if isinstance(v, pydec.Decimal) else pydec.Decimal(str(v))
            return int(d.scaleb(dt.scale).to_integral_value(
                rounding=pydec.ROUND_HALF_UP))
        if isinstance(dt, t.DateType):
            if isinstance(v, pydt.date):
                return (v - pydt.date(1970, 1, 1)).days
            return int(v)
        if isinstance(dt, t.TimestampType):
            if isinstance(v, pydt.datetime):
                epoch = pydt.datetime(1970, 1, 1,
                                      tzinfo=v.tzinfo and pydt.timezone.utc)
                return int((v - epoch).total_seconds() * 1e6)
            return int(v)
        return v

    def bind(self, schema):
        return self

    def _resolve(self):
        pass

    def _prepare(self, pctx, kids):
        if isinstance(self.dtype, t.StringType) and self.value is not None:
            return HostVal(np.array([self.value], str))
        return HostVal()

    def _eval_dev(self, ctx, kids):
        if self.value is None:
            dt = self.dtype if not isinstance(self.dtype, t.NullType) \
                else t.INT
            return DevVal(ctx.full(0, compute_dtype(dt)),
                          ctx.full(False, torch.bool), self.dtype)
        if isinstance(self.dtype, t.StringType):
            return DevVal(ctx.full(0, torch.int32), None, self.dtype,
                          np.array([self.value], str))
        return DevVal(ctx.full(self._physical_value(),
                               compute_dtype(self.dtype)), None, self.dtype)

    def _fp_extra(self):
        return f"{self.value!r}:{self.dtype.simple_string}"


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _prepare(self, pctx, kids):
        return kids[0]          # forward dictionary metadata transparently

    def _eval_dev(self, ctx, kids):
        return kids[0]

    def _fp_extra(self):
        return self.name


# ---------------------------------------------------------------------------
# Numeric binary arithmetic
# ---------------------------------------------------------------------------

def _promote_binary(a: Expression, b: Expression) -> t.DataType:
    da, db = a.dtype, b.dtype
    if isinstance(da, t.NullType):
        return db
    if isinstance(db, t.NullType):
        return da
    if da == db:
        return da
    return t.numeric_promote(da, db)


def _is_decimal_op(da: t.DataType, db: t.DataType) -> bool:
    return isinstance(da, t.DecimalType) or isinstance(db, t.DecimalType)


def _as_decimal(dt: t.DataType) -> t.DecimalType:
    from ..ops import decimal as D
    if isinstance(dt, t.DecimalType):
        return dt
    return D.integral_as_decimal(dt)


def _cast_dev(v: torch.Tensor, src: t.DataType, dst: t.DataType):
    if src == dst:
        return v
    return v.to(compute_dtype(dst))


def _remap_codes(codes: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """Dictionary codes translated through a host remap table (codes of
    null rows may be anything: they are clamped into the table)."""
    table = torch.from_numpy(remap).to(codes.device)
    return table[torch.clamp(codes, 0, table.shape[0] - 1).long()]


class BinaryArithmetic(Expression):
    symbol = "?"
    #: ops/decimal.py result-type rule / kernel; None -> not for decimals
    decimal_rule = None
    decimal_kernel = None

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def _is_decimal(self):
        return _is_decimal_op(self.children[0].dtype, self.children[1].dtype)

    def _resolve(self):
        if self._is_decimal():
            rule = self.decimal_rule
            if rule is None:
                raise TypeError(
                    f"{type(self).__name__} not defined for decimal")
            self.dtype = rule(_as_decimal(self.children[0].dtype),
                              _as_decimal(self.children[1].dtype))
        else:
            self.dtype = _promote_binary(*self.children)
        self.nullable = True

    def unsupported_reasons(self, conf):
        for c in self.children:
            if not t.is_numeric(c.dtype) and \
                    not isinstance(c.dtype, t.NullType):
                return [f"non-numeric operand {c.dtype.simple_string}"]
            if isinstance(c.dtype, t.DecimalType) and \
                    isinstance(c, ColumnRef) and c.dtype.is_wide:
                return ["128-bit host decimal lane not consumable on device"]
        if self._is_decimal() and self.decimal_kernel is None:
            return [f"decimal {self.symbol} not yet on device"]
        return []

    def _eval_dev(self, ctx, kids):
        l, r = kids
        if self._is_decimal():
            sa = _as_decimal(l.dtype).scale
            sb = _as_decimal(r.dtype).scale
            data, ok = self.decimal_kernel(l.data.to(torch.int64), sa,
                                           r.data.to(torch.int64), sb,
                                           self.dtype)
            return DevVal(data, merge_validity(l.validity, r.validity, ok),
                          self.dtype)
        ld = _cast_dev(l.data, l.dtype, self.dtype)
        rd = _cast_dev(r.data, r.dtype, self.dtype)
        data, extra_valid = self._op_dev(ld, rd)
        return DevVal(data, merge_validity(l.validity, r.validity,
                                           extra_valid), self.dtype)

    def _fp_extra(self):
        return self.symbol


class Add(BinaryArithmetic):
    symbol = "+"

    @property
    def decimal_rule(self):
        from ..ops import decimal as D
        return D.add_result

    @property
    def decimal_kernel(self):
        from ..ops import decimal as D
        return D.add_dev

    def _op_dev(self, l, r):
        return l + r, None


class Subtract(BinaryArithmetic):
    symbol = "-"

    @property
    def decimal_rule(self):
        from ..ops import decimal as D
        return D.add_result

    @property
    def decimal_kernel(self):
        from ..ops import decimal as D
        return D.sub_dev

    def _op_dev(self, l, r):
        return l - r, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    @property
    def decimal_rule(self):
        from ..ops import decimal as D
        return D.mul_result

    @property
    def decimal_kernel(self):
        from ..ops import decimal as D
        return D.mul_dev

    def _op_dev(self, l, r):
        return l * r, None


class Divide(BinaryArithmetic):
    """Spark Divide on non-decimals: DOUBLE result, x/0 -> NULL.  Decimal
    division is not on the device in the reference either (its CPU
    engine runs it); here it is refused until the CPU engine ports."""
    symbol = "/"

    def _resolve(self):
        if self._is_decimal():
            raise NotImplementedError(
                "decimal divide runs on the CPU engine, which is not "
                "ported yet")
        for c in self.children:
            if not (t.is_numeric(c.dtype) or isinstance(c.dtype, t.NullType)):
                raise TypeError(f"divide on {c.dtype}")
        self.dtype = t.DOUBLE

    def _eval_dev(self, ctx, kids):
        l, r = kids
        ld = l.data.to(torch.float64)
        rd = r.data.to(torch.float64)
        nz = rd != 0.0
        data = ld / torch.where(nz, rd, torch.ones_like(rd))
        return DevVal(data, merge_validity(l.validity, r.validity, nz),
                      t.DOUBLE)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left, right):
        self.children = (left, right)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _string_literal_side(self) -> Optional[int]:
        """Index of a string (or null) Literal child whose sibling is a
        plain (possibly aliased) column reference, or None."""
        for lit_i in (1, 0):
            lit = self.children[lit_i]
            if isinstance(lit, Literal) and (
                    isinstance(lit.dtype, t.StringType) or lit.value is None):
                other = self.children[1 - lit_i]
                inner = other.children[0] if isinstance(other, Alias) \
                    else other
                if isinstance(inner, ColumnRef):
                    return lit_i
        return None

    def unsupported_reasons(self, conf):
        if any(isinstance(c.dtype, t.StringType) for c in self.children) \
                and type(self) not in (EqualTo, NotEqual):
            return ["string ordering comparisons (<, <=, >, >=) port with "
                    "the strings slice (ROADMAP Queue 1 item 2)"]
        return []

    def _string_op_dev(self, ctx, kids) -> DevVal:
        """String = / != in code space.  Against a literal: the literal's
        code in the column's dictionary (a literal the dictionary lacks
        matches no row).  Between two string values: both sides' codes
        remapped into one unified dictionary, as the reference's
        `_prepare_string` does.  Nulls on either side give null."""
        lit_i = self._string_literal_side()
        if lit_i is None:
            return self._string_pair_dev(ctx, kids)
        col = kids[1 - lit_i]
        value = self.children[lit_i].value
        if value is None:
            return DevVal(ctx.full(False, torch.bool),
                          ctx.full(False, torch.bool), t.BOOLEAN)
        d = col.dictionary if col.dictionary is not None \
            else np.array([], str)
        if len(d) > 1 and not bool(np.all(d[:-1] < d[1:])):
            # a dictionary with repeats: value equality per code
            hit = torch.from_numpy(d == value).to(col.data.device)
            eq = hit[torch.clamp(col.data, 0, len(d) - 1).long()]
        else:
            pos = int(np.searchsorted(d, value))
            code = pos if pos < len(d) and d[pos] == value else -1
            eq = col.data == code
        return DevVal(eq if isinstance(self, EqualTo) else ~eq,
                      col.validity, t.BOOLEAN)

    def _string_pair_dev(self, ctx, kids) -> DevVal:
        from ..ops.batch_ops import unify_dictionaries
        l, r = kids
        _unified, remaps = unify_dictionaries([l.dictionary, r.dictionary])
        lc, rc = (_remap_codes(v.data, m) for v, m in zip(kids, remaps))
        return DevVal(self._op_dev(lc, rc),
                      merge_validity(l.validity, r.validity), t.BOOLEAN)

    def _common(self):
        l, r = self.children
        if _is_decimal_op(l.dtype, r.dtype):
            da, db = _as_decimal(l.dtype), _as_decimal(r.dtype)
            s = max(da.scale, db.scale)
            p = max(da.precision - da.scale, db.precision - db.scale) + s
            return t.DecimalType(min(p, 38), s)
        if l.dtype == r.dtype:
            return l.dtype
        return _promote_binary(*self.children)

    def _eval_dev(self, ctx, kids):
        if any(isinstance(c.dtype, t.StringType) for c in self.children):
            return self._string_op_dev(ctx, kids)
        l, r = kids
        extra = None
        common = self._common()
        if isinstance(common, t.DecimalType):
            from ..ops import decimal as D
            sa = _as_decimal(self.children[0].dtype).scale
            sb = _as_decimal(self.children[1].dtype).scale
            ld, ok_a = D.rescale(l.data.to(torch.int64), sa, common.scale)
            rd, ok_b = D.rescale(r.data.to(torch.int64), sb, common.scale)
            extra = ok_a & ok_b
        else:
            ld = _cast_dev(l.data, l.dtype, common)
            rd = _cast_dev(r.data, r.dtype, common)
        return DevVal(self._op_dev(ld, rd),
                      merge_validity(l.validity, r.validity, extra),
                      t.BOOLEAN)

    def _fp_extra(self):
        return self.symbol


class EqualTo(BinaryComparison):
    symbol = "="

    def _op_dev(self, l, r):
        return l == r


class NotEqual(BinaryComparison):
    symbol = "!="

    def _op_dev(self, l, r):
        return l != r


class LessThan(BinaryComparison):
    symbol = "<"

    def _op_dev(self, l, r):
        return l < r


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _op_dev(self, l, r):
        return l <= r


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _op_dev(self, l, r):
        return l > r


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _op_dev(self, l, r):
        return l >= r


# ---------------------------------------------------------------------------
# Boolean logic (Kleene) and null handling
# ---------------------------------------------------------------------------

class And(Expression):
    def __init__(self, l, r):
        self.children = (l, r)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        l, r = kids
        lv = valid_or_true(l.validity, ctx.capacity, ctx.device)
        rv = valid_or_true(r.validity, ctx.capacity, ctx.device)
        data = (l.data & lv) & (r.data & rv)
        # Kleene: false AND anything = false (valid); else null if either
        valid = (lv & rv) | (lv & ~l.data) | (rv & ~r.data)
        return DevVal(data, valid, t.BOOLEAN)


class Or(Expression):
    def __init__(self, l, r):
        self.children = (l, r)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        l, r = kids
        lv = valid_or_true(l.validity, ctx.capacity, ctx.device)
        rv = valid_or_true(r.validity, ctx.capacity, ctx.device)
        true_l = lv & l.data
        true_r = rv & r.data
        return DevVal(true_l | true_r, (lv & rv) | true_l | true_r,
                      t.BOOLEAN)


class Not(Expression):
    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = self.children[0].nullable

    def _eval_dev(self, ctx, kids):
        return DevVal(~kids[0].data, kids[0].validity, t.BOOLEAN)


class IsNull(Expression):
    nullable = False

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        v = kids[0].validity
        return DevVal(ctx.full(False, torch.bool) if v is None else ~v, None,
                      t.BOOLEAN)


class IsNotNull(Expression):
    nullable = False

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        v = kids[0].validity
        return DevVal(ctx.full(True, torch.bool) if v is None else v, None,
                      t.BOOLEAN)


class Coalesce(Expression):
    def __init__(self, *children):
        self.children = tuple(children)

    def _resolve(self):
        non_null = [c.dtype for c in self.children
                    if not isinstance(c.dtype, t.NullType)]
        self.dtype = non_null[0] if non_null else t.NULL

    def unsupported_reasons(self, conf):
        if isinstance(self.dtype, t.StringType):
            return ["string coalesce not yet on device"]
        return []

    def _eval_dev(self, ctx, kids):
        data = ctx.full(0, compute_dtype(self.dtype))
        taken = ctx.full(False, torch.bool)
        for k in kids:
            use = valid_or_true(k.validity, ctx.capacity, ctx.device) & ~taken
            data = torch.where(use, _cast_dev(k.data, k.dtype, self.dtype),
                               data)
            taken = taken | use
        return DevVal(data, taken, self.dtype)


# ---------------------------------------------------------------------------
# Conditionals and IN
# ---------------------------------------------------------------------------

class If(Expression):
    """IF(pred, then, else): a null predicate takes the else branch."""

    def __init__(self, pred, then, other):
        self.children = (pred, then, other)

    def _resolve(self):
        _, then, other = self.children
        self.dtype = then.dtype if not isinstance(then.dtype, t.NullType) \
            else other.dtype

    def unsupported_reasons(self, conf):
        if isinstance(self.dtype, t.StringType):
            return ["string-valued if not yet on device"]
        return []

    def _eval_dev(self, ctx, kids):
        p, a, b = kids
        cond = p.data & valid_or_true(p.validity, ctx.capacity, ctx.device)
        data = torch.where(cond, _cast_dev(a.data, a.dtype, self.dtype),
                           _cast_dev(b.data, b.dtype, self.dtype))
        valid = torch.where(
            cond, valid_or_true(a.validity, ctx.capacity, ctx.device),
            valid_or_true(b.validity, ctx.capacity, ctx.device))
        return DevVal(data, valid, self.dtype)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2]* [ELSE e] END.  The result
    type is the first non-null branch value's type, else the else
    value's (the reference's rule, not Spark's coercion).  A null
    predicate falls through; with no else, no hit gives null.  String
    values are remapped into one unified dictionary."""

    def __init__(self, branches, otherwise: Optional[Expression] = None):
        flat = []
        for c, v in branches:
            flat += [c, v]
        self.n_branches = len(branches)
        self.has_else = otherwise is not None
        self.children = tuple(flat) + ((otherwise,) if self.has_else
                                       else ())

    def _resolve(self):
        for i in range(self.n_branches):
            v = self.children[2 * i + 1]
            if not isinstance(v.dtype, t.NullType):
                self.dtype = v.dtype
                break
        else:
            self.dtype = self.children[-1].dtype if self.has_else else t.NULL

    def _value_slots(self) -> List[int]:
        """Indices of the branch-value (and else) children."""
        out = [2 * i + 1 for i in range(self.n_branches)]
        if self.has_else:
            out.append(len(self.children) - 1)
        return out

    def _unified(self, dicts):
        """(output dictionary, per-value remaps) of a string CASE."""
        from ..ops.batch_ops import unify_dictionaries
        unified, remaps = unify_dictionaries(dicts)
        if len(unified) == 0:
            # all-null result: its codes are never read, but the
            # dictionary must stay indexable
            unified = np.array([""], str)
        return unified, remaps

    def _prepare(self, pctx, kids):
        if not isinstance(self.dtype, t.StringType):
            return HostVal()
        for i in self._value_slots():
            e = self.children[i]
            if kids[i].dictionary is None and \
                    not isinstance(e.dtype, t.NullType) and \
                    not (isinstance(e, Literal) and e.value is None):
                raise TypeError(
                    "device CASE over a dictionary-less string value")
        return HostVal(self._unified(
            [kids[i].dictionary for i in self._value_slots()])[0])

    def _eval_dev(self, ctx, kids):
        cap, dev = ctx.capacity, ctx.device
        vals = [kids[i] for i in self._value_slots()]
        dictionary = None
        if isinstance(self.dtype, t.StringType):
            dictionary, remaps = self._unified([v.dictionary for v in vals])
            lanes = [_remap_codes(v.data, m) for v, m in zip(vals, remaps)]
        else:
            lanes = [_cast_dev(v.data, v.dtype, self.dtype) for v in vals]
        if self.has_else:
            data = lanes[-1]
            valid = valid_or_true(vals[-1].validity, cap, dev)
        else:
            data = ctx.full(0, compute_dtype(self.dtype)
                            if dictionary is None else torch.int32)
            valid = ctx.full(False, torch.bool)
        decided = ctx.full(False, torch.bool)
        for i in range(self.n_branches):
            c = kids[2 * i]
            hit = c.data & valid_or_true(c.validity, cap, dev) & ~decided
            data = torch.where(hit, lanes[i], data)
            valid = torch.where(hit, valid_or_true(vals[i].validity, cap, dev),
                                valid)
            decided = decided | hit
        if not self.has_else:
            valid = valid & decided
        return DevVal(data, valid, self.dtype, dictionary)


class In(Expression):
    """value IN (literals...), with Spark's null semantics: a null value
    gives null, and so does no match when the list holds a null.  A
    string value tests its code against a membership mask over its
    dictionary."""

    def __init__(self, value: Expression, items):
        self.items = tuple(items)
        self.children = (value,)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        v = kids[0]
        non_null = [x for x in self.items if x is not None]
        has_null_item = len(non_null) < len(self.items)
        if isinstance(self.children[0].dtype, t.StringType):
            d = v.dictionary if v.dictionary is not None \
                else np.array([], str)
            mask = np.isin(d, np.array(non_null, str)) if len(d) \
                else np.zeros(1, bool)
            data = _remap_codes(v.data, mask)
        else:
            data = ctx.full(False, torch.bool)
            for x in non_null:
                data = data | (v.data == torch.tensor(
                    x, dtype=v.data.dtype, device=ctx.device))
        vv = valid_or_true(v.validity, ctx.capacity, ctx.device)
        valid = vv & data if has_null_item else vv
        return DevVal(data & vv, valid, t.BOOLEAN)

    def _fp_extra(self):
        return repr(self.items)


# ---------------------------------------------------------------------------
# Casts (numeric, boolean and decimal)
# ---------------------------------------------------------------------------

class Cast(Expression):
    def __init__(self, child, to: t.DataType):
        self.children = (child,)
        self.to = to

    def _resolve(self):
        self.dtype = self.to
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        src, dst = self.children[0].dtype, self.to
        if src == dst:
            return []
        numeric = (t.NumericType, t.BooleanType)
        if isinstance(src, numeric) and isinstance(dst, numeric):
            return []
        return [f"cast {src.simple_string}->{dst.simple_string} "
                "not ported yet"]

    def _eval_dev(self, ctx, kids):
        from ..ops import decimal as D
        src, dst = self.children[0].dtype, self.to
        x, valid = kids[0].data, kids[0].validity
        if src == dst:
            return kids[0]
        if isinstance(src, t.DecimalType):
            u = x.to(torch.int64)
            if isinstance(dst, t.DecimalType):
                data, ok = D.rescale(u, src.scale, dst.scale)
                ok = ok & D.fits_precision(data, dst.precision)
                return DevVal(data, merge_validity(valid, ok), dst)
            if t.is_floating(dst):
                return DevVal(D.to_double(u, src.scale).to(
                    compute_dtype(dst)), valid, dst)
            if isinstance(dst, t.BooleanType):
                return DevVal(u != 0, valid, dst)
            ints = D.cast_to_integral(u, src.scale)
            info = np.iinfo(t.physical_np_dtype(dst))
            ok = (ints >= int(info.min)) & (ints <= int(info.max))
            return DevVal(ints.to(compute_dtype(dst)),
                          merge_validity(valid, ok), dst)
        if isinstance(dst, t.DecimalType):
            if t.is_floating(src):
                data, ok = D.from_double(x.to(torch.float64), dst)
            else:
                data, ok = D.from_integral(x, dst)
            return DevVal(data, merge_validity(valid, ok), dst)
        if isinstance(dst, t.BooleanType):
            data = x != 0
        elif t.is_floating(src) and t.is_integral(dst):
            data = _floating_to_integral(x, dst)
        else:
            data = x.to(compute_dtype(dst))
        return DevVal(data, valid, dst)

    def _fp_extra(self):
        return self.to.simple_string


def _floating_to_integral(x: torch.Tensor, dst: t.DataType) -> torch.Tensor:
    """The reference's floating -> integral cast: NaN -> 0, truncation
    toward zero, saturation at the f64 values nearest Long's bounds,
    then a clamp to the target's bounds in the integer domain (which
    differs from Java's wrapping narrowing for BYTE and SHORT, as the
    reference documents)."""
    f = x.to(torch.float64)
    f = torch.trunc(torch.where(torch.isnan(f), 0.0, f))
    i64 = torch.clamp(f, -9.223372036854776e18,
                      9.223372036854775e18).to(torch.int64)
    info = np.iinfo(t.physical_np_dtype(dst))
    return torch.clamp(i64, int(info.min), int(info.max)).to(
        compute_dtype(dst))
