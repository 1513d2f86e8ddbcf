"""Expression trees evaluated on torch tensors.

Counterpart of spark_rapids_tpu/plan/expressions.py.  This slice ports
the device evaluation (`eval_dev`) of what the ported TPC-H queries and
the MIN/MAX/FIRST/LAST group-bys reach: column references, literals,
aliases, + - * (integral, floating and decimal with Spark's result-type
rules and overflow-to-null), / on doubles, the six comparisons (numeric,
date and decimal), = and != of a dictionary-coded string column against
a string literal or another string column, Kleene AND/OR/NOT, IS [NOT]
NULL, COALESCE, IF, CASE WHEN, IN, numeric/decimal casts (floating to
integral as the reference truncates and clamps), the bitwise and shift
operators with Java's shift-distance masking, and the scalar families:
integral divide and remainder with Java's wrapping and sign rules, unary
minus, abs, <=>, IS NaN, the math functions (DOUBLE results, Spark's
null domain for the logarithms), floor / ceil to LONG, greatest /
least in Java's order, round / bround (exact on DECIMAL and integral
lanes, binary on DOUBLE), width_bucket and raise_error; casts from
STRING to every numeric type, BOOLEAN and DATE (each dictionary entry
parsed once on the host, as the reference's `_parse_entry` does, and
gathered by code), and < <= > >= of a string column against a string
literal (the literal's insertion point in the column's sorted
dictionary, against the codes).  Anything else reports itself in
`unsupported_reasons`, and plan/overrides.py sends the operator to the
CPU engine with that reason, as the reference's tagging does; a reason
that the port refuses instead, where the reference runs the expression
on its device, is an `Unported` naming the slice that ports it.

Every class also evaluates on the CPU engine (`eval_cpu`, numpy over a
`HostBatch`, exec/host_exec.py), the counterpart of the reference's
pyarrow `eval_cpu`: the families that the reference runs only there
(string COALESCE, IF and CASE over two dictionaries, string ordering
between two columns, casts to STRING) too.

Where the reference is wrong by Spark's rules the port follows its CPU
oracle (ROADMAP Queue 3 item 10): a DECIMAL operand of a math function,
floor or ceil is its value, not its unscaled lane; `div` by
Long.MIN_VALUE truncates; a DOUBLE rounds by a true division.

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
import threading
import datetime as pydt
import decimal as pydec
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as t
from ..columnar.host import EXACT, HostBatch, HostColumn, decimal_value
from ..config import TpuConf
from ..ops import host as H
from ..ops.kernels import compute_dtype, merge_validity, valid_or_true
from ..runtime.capture import host_constant, host_reads_ok, recording


#: where the two-lane device forms of a DECIMAL wider than 18 digits
#: (arithmetic, comparisons, MIN/MAX over a value past int64) port
WIDE_DECIMAL_SLICE = ("the two-lane device decimal forms (ROADMAP Queue 1 "
                      "item 2)")


# -- whole-plan literal bindings --------------------------------------------
# While exec/compiled.py captures a whole plan, each lifted literal reads
# its value from a 0-d device tensor (a slot), so that the captured graph
# reads it from a fixed address and a literal variant of the plan replays
# the same graph with other values in the slots.  The binding maps each
# Literal (by identity) to its slot; thread-local, since a background
# capture runs on another thread.

_LIFT_BINDINGS = threading.local()


def set_literal_bindings(bindings: Optional[Dict[int, torch.Tensor]]
                         ) -> None:
    """Install (or clear, with None) the id(Literal) -> 0-d tensor map
    of the capture or replay running on THIS thread."""
    _LIFT_BINDINGS.map = bindings


def get_literal_binding(lit: "Expression") -> Optional[torch.Tensor]:
    m = getattr(_LIFT_BINDINGS, "map", None)
    return None if m is None else m.get(id(lit))


class Unported(str):
    """A reason that the port refuses instead of falling back: the
    reference runs this on its device, and the port's device form is
    not ported yet (the reason names the slice).  plan/overrides.py
    raises NotImplementedError for an operator that holds one unless
    another reason already sends it to the CPU engine, so the CPU
    engine takes only what the reference's own tagging puts there."""


def has_device_rule(e: "Expression") -> bool:
    """The port's own expression classes have a device rule (the
    reference's `_EXPR_RULES` registry); any other class (a test's, a
    user's) runs on the CPU engine only, and so does a port class the
    reference registers no rule for (`has_rule = False`)."""
    return type(e).__module__.startswith(__name__.rsplit(".", 2)[0] + ".") \
        and getattr(type(e), "has_rule", True)
#: dictionaries an expression keeps derived tensors for at once
_CACHE_ENTRIES = 4


class PerDictionary:
    """What an expression derived from each dictionary it met, by the
    dictionary's identity (the entry holds the dictionary, so its id is
    not reused while cached)."""

    def __init__(self):
        self.entries = {}

    def get(self, d: np.ndarray, make):
        hit = self.entries.get(id(d))
        if hit is not None and hit[0] is d:
            return hit[1]
        value = make()
        if recording():
            return value          # filled only by the graph's replays
        if len(self.entries) >= _CACHE_ENTRIES:
            self.entries.pop(next(iter(self.entries)))
        self.entries[id(d)] = (d, value)
        return value


def per_dictionary(e: "Expression", name: str) -> PerDictionary:
    """The expression's own cache (bound copies each make theirs)."""
    cache = e.__dict__.get(name)
    if cache is None:
        cache = e.__dict__[name] = PerDictionary()
    return cache


def dict_or_empty(d: Optional[np.ndarray]) -> np.ndarray:
    return np.array([], str) if d is None else d


class PrepCtx:
    """Host-phase context: the batch's dictionaries and its device (where
    a dictionary transform rewrites a large dictionary)."""

    def __init__(self, conf: TpuConf, dicts: Dict[str, Optional[np.ndarray]],
                 device=None):
        self.conf = conf
        self.dicts = dicts            # input column name -> dictionary
        self.device = device


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
    rows valid) + logical type (+ dictionary for strings) (+ an exact
    (lo, hi) bound of its valid integer values where the expression knows
    one: a cast of a string parses a whole dictionary, so the group-by
    can pack such a key as it packs a scanned column) (+ the high word
    of a DECIMAL wider than 18 digits, `hi`: see `narrow_dev`).

    `narrow` is a FOR-narrowed lane of the same values in a narrower
    signed dtype (ops/encodings.py): a scan column's (NarrowColumn) or a
    narrow sum, difference or product's.  The rule every expression
    obeys: `data` is the lane widened to the compute dtype, made when it
    is first read (`widen`, else a plain cast), so no expression sees a
    narrow dtype unless it asks for `narrow`.  Only the guarded sites
    read `narrow`: comparisons (`encodings.narrow_compare`), IN, and
    arithmetic between two narrow lanes at its exact width.  PyTorch
    needs the rule: a Python scalar or a 0-d tensor never promotes a
    narrow lane, and an out-of-range value wraps silently.

    A ragged ARRAY value (plan/collections.py) carries `offsets` (int32,
    rows + 1) and `elem_valid` (per value): `data` is then its flat
    values lane and `validity` per row (columnar/device.DeviceColumn)."""

    def __init__(self, data, validity, dtype: t.DataType,
                 dictionary: Optional[np.ndarray] = None,
                 value_range: Optional[Tuple[int, int]] = None,
                 hi=None, narrow=None, widen=None, offsets=None,
                 elem_valid=None):
        self.offsets = offsets
        self.elem_valid = elem_valid
        self._data = data
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary
        self.value_range = value_range
        self.hi = hi
        self.narrow = narrow
        self._widen = widen

    @property
    def data(self) -> torch.Tensor:
        if self._data is None and self.narrow is not None:
            self._data = self._widen() if self._widen is not None \
                else self.narrow.to(compute_dtype(self.dtype))
        return self._data


def narrow_dev(v: DevVal, consumer: str) -> DevVal:
    """`v` as one int64 lane for a device consumer without a two-lane
    form: every valid row's high word must be the sign extension of its
    low word (then the low word is the value), else this raises naming
    the slice that brings the two-lane forms; it never returns a
    wrapped value.  One host sync, paid only by a value that has a high
    word (a finished wide DECIMAL sum)."""
    if v.hi is None:
        return v
    bad = v.hi != (v.data.to(torch.int64) >> 63)
    if v.validity is not None:
        bad = bad & v.validity
    if bool(bad.any()):
        raise NotImplementedError(
            f"{consumer}: a DECIMAL({v.dtype.precision}) value leaves "
            "int64 on the device, and this consumer has no two-lane form "
            f"yet ({WIDE_DECIMAL_SLICE})")
    return DevVal(v.data, v.validity, v.dtype, v.dictionary, v.value_range)


class Expression:
    children: Tuple["Expression", ...] = ()
    dtype: t.DataType = None
    nullable: bool = True
    #: True when this node reads its literal children only through their
    #: device values (never their `.value` on the host): the gate for
    #: constant lifting.  An unmarked parent keeps its literal children
    #: baked into the graph and keyed by value.
    lifts_literal_children = False

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
        # an Unported reason stays one through the prefix
        out += [type(r)(f"{type(self).__name__}: {r}")
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
    #: reads a child's DECIMAL high word itself; every other class sees
    #: its children as one int64 lane (`narrow_dev`)
    reads_hi = False

    def eval_dev(self, ctx: EvalCtx) -> DevVal:
        kids = [c.eval_dev(ctx) for c in self.children]
        if not self.reads_hi:
            kids = [narrow_dev(k, type(self).__name__) for k in kids]
        return self._eval_dev(ctx, kids)

    def _eval_dev(self, ctx: EvalCtx, kids: List[DevVal]) -> DevVal:
        raise NotImplementedError(type(self).__name__)

    # ---- CPU engine (exec/host_exec.py) ----
    def eval_cpu(self, batch: HostBatch) -> HostColumn:
        """This expression over a host batch, on numpy: the CPU engine's
        evaluation, as the reference's `eval_cpu` is its pyarrow one."""
        kids = [c.eval_cpu(batch) for c in self.children]
        return self._eval_cpu(batch, kids)

    def _eval_cpu(self, batch: HostBatch, kids: List[HostColumn]
                  ) -> HostColumn:
        raise NotImplementedError(type(self).__name__)

    # ---- identity ----
    def fingerprint(self) -> str:
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}({self._fp_extra()};{kids})"

    def _fp_extra(self) -> str:
        return ""

    def canonical_fingerprint(self, lift_ok: bool = True) -> str:
        """The fingerprint with each LIFTED literal's value erased to a
        dtype-only slot marker: the whole-plan cache key under constant
        lifting (the reference's).  `lift_ok` carries the parent's
        `lifts_literal_children` down the tree (the top-level call is a
        root position, liftable) and mirrors exec/compiled's
        collect_plan_literals, so a value this fingerprint hides is a
        value the graph reads from its slot."""
        kids = ",".join(
            c.canonical_fingerprint(self.lifts_literal_children)
            for c in self.children)
        return f"{type(self).__name__}({self._fp_extra()};{kids})"

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

    def _eval_cpu(self, batch, kids):
        return batch.column_by_name(self.name)

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
            return int(d.scaleb(dt.scale, EXACT).to_integral_value(
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

    def lift_type_ok(self) -> bool:
        """The value half of lift eligibility (the reference's): a
        non-null literal of one flat numeric lane.  Strings carry
        dictionaries, wide decimals a second lane and nulls an all-false
        validity, so they stay baked."""
        if self.value is None:
            return False
        dt = self.dtype
        if isinstance(dt, t.DecimalType):
            return not dt.is_wide
        return isinstance(dt, (t.ByteType, t.ShortType, t.IntegerType,
                               t.LongType, t.FloatType, t.DoubleType,
                               t.BooleanType, t.DateType, t.TimestampType))

    def canonical_fingerprint(self, lift_ok: bool = True) -> str:
        if lift_ok and self.lift_type_ok():
            return f"Literal(?:{self.dtype.simple_string};)"
        return self.fingerprint()

    def _dictionary(self) -> Optional[np.ndarray]:
        """A string literal's one-entry dictionary; a null one's is empty
        (every row null), so a projected null STRING column carries one."""
        if not isinstance(self.dtype, t.StringType):
            return None
        return np.array([] if self.value is None else [self.value], str)

    def _prepare(self, pctx, kids):
        return HostVal(self._dictionary())

    def _eval_dev(self, ctx, kids):
        slot = get_literal_binding(self)
        if slot is not None:
            # lifted: every row reads the slot, which a replay rewrites
            return DevVal(slot.to(compute_dtype(self.dtype))
                          .expand(ctx.capacity).contiguous(), None,
                          self.dtype)
        if self.value is None:
            dt = self.dtype if not isinstance(self.dtype, t.NullType) \
                else t.INT
            return DevVal(ctx.full(0, compute_dtype(dt)),
                          ctx.full(False, torch.bool), self.dtype,
                          self._dictionary())
        if isinstance(self.dtype, t.StringType):
            return DevVal(ctx.full(0, torch.int32), None, self.dtype,
                          np.array([self.value], str))
        v = self._physical_value()
        if isinstance(self.dtype, t.DecimalType) and \
                not -2 ** 63 <= v < 2 ** 63:
            lo = (v & ((1 << 64) - 1)) - ((v >> 63 & 1) << 64)
            return DevVal(ctx.full(lo, torch.int64), None, self.dtype,
                          hi=ctx.full(v >> 64, torch.int64))
        return DevVal(ctx.full(v, compute_dtype(self.dtype)), None,
                      self.dtype)

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        if isinstance(self.dtype, t.StringType):
            return H.string_literal_column(self.value, n)
        dt = self.dtype if not isinstance(self.dtype, t.NullType) else t.INT
        lane = t.physical_np_dtype(dt)
        if self.value is None:
            return HostColumn(np.zeros(n, lane), np.zeros(n, bool),
                              self.dtype)
        v = self._physical_value()
        if isinstance(dt, t.DecimalType) and not -2 ** 63 <= v < 2 ** 63:
            return H.wide_column(np.array([v] * n + [0], object)[:-1], None,
                                 dt)
        return HostColumn(np.full(n, v, lane), None, self.dtype)

    def _fp_extra(self):
        return f"{self.value!r}:{self.dtype.simple_string}"


class Alias(Expression):
    lifts_literal_children = True
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    reads_hi = True

    def _prepare(self, pctx, kids):
        return kids[0]          # forward dictionary metadata transparently

    def _eval_dev(self, ctx, kids):
        return kids[0]

    def _fp_extra(self):
        return self.name

    def _eval_cpu(self, batch, kids):
        return kids[0]


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


WIDE_HOST_REASON = "128-bit host decimal lane not consumable on device"


def consumes_wide_host(e: Expression) -> bool:
    """True when `e` reads a wide (p > 18) decimal straight off a column
    (the reference's `_consumes_wide_host`): such a column may carry a
    high word, which the single-lane device forms cannot read, so the
    reference tags its consumer for the CPU engine.  A reference through
    an Alias counts too."""
    inner = e.children[0] if isinstance(e, Alias) else e
    return isinstance(inner, ColumnRef) and \
        isinstance(inner.dtype, t.DecimalType) and inner.dtype.is_wide


def _integral(dt: t.DataType) -> bool:
    return isinstance(dt, (t.ByteType, t.ShortType, t.IntegerType,
                           t.LongType))


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
    table = host_constant(remap, codes.device)
    return table[torch.clamp(codes, 0, table.shape[0] - 1).long()]


def _lane(col: HostColumn, dt: t.DataType) -> np.ndarray:
    """A host column's data lane in `dt`'s storage dtype (the CPU
    engine's `_cast_dev`)."""
    want = t.physical_np_dtype(dt if not isinstance(dt, t.NullType)
                               else t.INT)
    return col.data.astype(want, copy=False)


def _unified_codes(cols: List[HostColumn]):
    """(sorted unified dictionary, each string column's codes in it)."""
    from ..ops.batch_ops import unify_dictionaries
    unified, remaps = unify_dictionaries([c.dictionary for c in cols])
    codes = [m[np.clip(c.data, 0, len(m) - 1)] if len(c) else
             np.zeros(0, np.int32) for c, m in zip(cols, remaps)]
    return unified, codes


def _f64_np(col: HostColumn) -> np.ndarray:
    """A numeric host column as float64 (a decimal by its value)."""
    if isinstance(col.dtype, t.DecimalType):
        return H.decimal_to_double(col.data.astype(np.int64),
                                   col.dtype.scale)
    return col.data.astype(np.float64)


class BinaryArithmetic(Expression):
    lifts_literal_children = True
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
            if consumes_wide_host(c):
                return [WIDE_HOST_REASON]
        if self._is_decimal() and self.decimal_kernel is None:
            return [f"decimal {self.symbol} not yet on device"]
        return []

    #: the int64 numpy form of this operator over decimals (None: only
    #: the exact Python-int form, ops/host.wide_decimal_op)
    _decimal_cpu = None

    def _decimal_eval_cpu(self, l: HostColumn, r: HostColumn) -> HostColumn:
        """Decimal arithmetic on the CPU engine, exact at Spark's result
        type as the reference's CPU engine is: the int64 lanes in numpy,
        and the rows whose int64 step overflows (or an operand with a
        high word) again in Python ints, where the result type is wider
        than 18 digits."""
        sa = _as_decimal(l.dtype).scale
        sb = _as_decimal(r.dtype).scale
        out_t = self.dtype
        if self._decimal_cpu is None or l.hi is not None or r.hi is not None:
            return H.wide_decimal_op(self.symbol, l, sa, r, sb, out_t)
        data, ok = self._decimal_cpu(l.data.astype(np.int64), sa,
                                     r.data.astype(np.int64), sb, out_t)
        valid = H.and_valid(l.validity, r.validity)
        return H.exact_where_int64_fails(
            H.column(data, H.and_valid(valid, ok), out_t), valid, ok,
            lambda rows: H.wide_decimal_op(self.symbol, H.take(l, rows), sa,
                                           H.take(r, rows), sb, out_t))

    def _eval_cpu(self, batch, kids):
        l, r = kids
        if self._is_decimal():
            return self._decimal_eval_cpu(l, r)
        with np.errstate(all="ignore"):
            data, extra = self._op_cpu(_lane(l, self.dtype),
                                       _lane(r, self.dtype))
        return H.column(data, H.and_valid(l.validity, r.validity, extra),
                        self.dtype)

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
        op = {"+": "add", "-": "add", "*": "mul"}.get(self.symbol)
        if l.narrow is not None and r.narrow is not None and \
                op is not None and _integral(l.dtype) and \
                _integral(r.dtype) and _integral(self.dtype):
            # two FOR-narrowed operands: compute at the exact width of the
            # result (ops/encodings.exact_arith_dtype), which cannot wrap;
            # the logical dtype only where that width needs it
            from ..ops.encodings import count_dispatch, exact_arith_dtype
            adt = exact_arith_dtype(l.narrow.dtype, r.narrow.dtype, op,
                                    compute_dtype(self.dtype))
            if adt is not None:
                data, _ = self._op_dev(l.narrow.to(adt), r.narrow.to(adt))
                count_dispatch("arith_narrow")
                return DevVal(None, merge_validity(l.validity, r.validity),
                              self.dtype, narrow=data)
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

    def _op_cpu(self, l, r):
        return l + r, None

    @staticmethod
    def _decimal_cpu(ua, sa, ub, sb, out):
        return H.decimal_add(ua, sa, ub, sb, out)


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

    def _op_cpu(self, l, r):
        return l - r, None

    @staticmethod
    def _decimal_cpu(ua, sa, ub, sb, out):
        return H.decimal_add(ua, sa, -ub, sb, out)


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

    def _op_cpu(self, l, r):
        return l * r, None

    @staticmethod
    def _decimal_cpu(ua, sa, ub, sb, out):
        return H.decimal_mul(ua, sa, ub, sb, out)


class Divide(BinaryArithmetic):
    """Spark Divide: DOUBLE result for non-decimals, x/0 -> NULL.  Decimal
    division runs on the CPU engine, as in the reference: exact at
    Spark's result type (`ops/decimal.div_result`), HALF_UP."""
    symbol = "/"

    @property
    def decimal_rule(self):
        from ..ops import decimal as D
        return D.div_result

    def _resolve(self):
        if self._is_decimal():
            self.dtype = self.decimal_rule(
                _as_decimal(self.children[0].dtype),
                _as_decimal(self.children[1].dtype))
            self.nullable = True
            return
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

    def _eval_cpu(self, batch, kids):
        l, r = kids
        if self._is_decimal():
            return self._decimal_eval_cpu(l, r)
        ld = l.data.astype(np.float64)
        rd = r.data.astype(np.float64)
        nz = rd != 0.0
        with np.errstate(all="ignore"):
            data = ld / np.where(nz, rd, 1.0)
        return H.column(data, H.and_valid(l.validity, r.validity, nz),
                        t.DOUBLE)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

class BinaryComparison(Expression):
    lifts_literal_children = True
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
        if any(isinstance(c.dtype, t.StringType) for c in self.children):
            if type(self) not in (EqualTo, NotEqual) and \
                    self._string_literal_side() is None:
                return ["string ordering comparison not yet on device"]
            return []
        for c in self.children:
            if consumes_wide_host(c):
                return [WIDE_HOST_REASON]
        return []

    def _string_op_dev(self, ctx, kids) -> DevVal:
        """String comparisons against a literal (ops/encodings.py).
        = / !=: the literal's code in the column's duplicate-free
        dictionary (`literal_code`; one the dictionary lacks matches no
        row), else the decode rung, a per-entry match table gathered by
        code.  < <= > >=: `_string_order_dev`.  = / != between two
        string values: both sides' codes remapped into one unified
        dictionary, as the reference's `_prepare_string` does.  Nulls on
        either side give null."""
        from ..ops import encodings as ENC
        lit_i = self._string_literal_side()
        if lit_i is None:
            return self._string_pair_dev(ctx, kids)
        col = kids[1 - lit_i]
        value = self.children[lit_i].value
        if value is None:
            return DevVal(ctx.full(False, torch.bool),
                          ctx.full(False, torch.bool), t.BOOLEAN)
        d = dict_or_empty(col.dictionary)
        if isinstance(self, (LessThan, LessThanOrEqual, GreaterThan,
                             GreaterThanOrEqual)):
            return self._string_order_dev(ctx, col, d, value, lit_i)
        pol = ENC.encoding_policy(ctx.conf)
        if pol.enabled and pol.dict_predicates and \
                ENC.is_unique_dict(d) and \
                ENC.elect_encoded(ctx.conf, "predicate_code"):
            eq = col.data == ENC.literal_code(d, value)
        else:
            if pol.enabled:
                ENC.count_decode("predicate_code", ctx.capacity)
            eq = _remap_codes(col.data, d == value if len(d)
                              else np.zeros(1, bool))
        return DevVal(~eq if isinstance(self, NotEqual) else eq,
                      col.validity, t.BOOLEAN)

    def _string_order_dev(self, ctx, col: DevVal, d: np.ndarray, value: str,
                          lit_i: int) -> DevVal:
        """col OP literal, ordered as Spark orders strings (by UTF-8
        bytes, which is code-point order, numpy's).  The literal's
        counts bound the ranks: col < v iff rank < #(entries < v), col <=
        v iff rank < #(entries <= v) (`encodings.rank_bounds`).  Over an
        ordered dictionary the codes are the ranks; over any other, or
        with `dict.predicates=OFF`, the decode rung gathers a rank table
        by code."""
        from ..ops import encodings as ENC
        sym = self.symbol if lit_i == 1 else \
            {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[self.symbol]
        less, leq = ENC.rank_bounds(d, value)
        pol = ENC.encoding_policy(ctx.conf)
        if pol.enabled and pol.dict_predicates and \
                ENC.is_ordered_dict(d) and \
                ENC.elect_encoded(ctx.conf, "predicate_range"):
            rank = col.data
        else:
            if pol.enabled:
                ENC.count_decode("predicate_range", ctx.capacity * 4)
            rank = _remap_codes(col.data, ENC.rank_table(d))
        out = {"<": rank < less, "<=": rank < leq, ">": rank >= leq,
               ">=": rank >= less}[sym]
        return DevVal(out, col.validity, t.BOOLEAN)

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
            narrow = self._narrow_op_dev(kids, common)
            if narrow is not None:
                return DevVal(narrow, merge_validity(l.validity,
                                                     r.validity), t.BOOLEAN)
            ld = _cast_dev(l.data, l.dtype, common)
            rd = _cast_dev(r.data, r.dtype, common)
        return DevVal(self._op_dev(ld, rd),
                      merge_validity(l.validity, r.validity, extra),
                      t.BOOLEAN)

    def _narrow_op_dev(self, kids, common) -> Optional[torch.Tensor]:
        """A comparison on FOR-narrowed lanes (ops/encodings.py): two
        narrow lanes compare in their common narrow dtype; a narrow lane
        against a full-width integer lane (a literal's) by
        `narrow_compare`, whose range guards answer where the wide value
        lies outside the narrow dtype.  None: the full-width path."""
        l, r = kids
        if l.narrow is None and r.narrow is None:
            return None
        # the narrow lanes hold their own type's values: an integral type
        # widens to `common` unchanged, a DATE or TIMESTAMP only to itself
        for k in (l, r):
            if k.narrow is not None and not (
                    _integral(k.dtype) and _integral(common) or
                    k.dtype == common and isinstance(
                        common, (t.DateType, t.TimestampType))):
                return None
        from ..ops.encodings import (common_narrow_dtype, count_dispatch,
                                     narrow_compare)
        if l.narrow is not None and r.narrow is not None:
            cdt = common_narrow_dtype(l.narrow.dtype, r.narrow.dtype)
            if cdt is None:
                return None
            count_dispatch("predicate_narrow")
            return self._op_dev(l.narrow.to(cdt), r.narrow.to(cdt))
        nar, wide = (l, r) if l.narrow is not None else (r, l)
        sym = self.symbol
        if nar is r:
            sym = {"=": "=", "!=": "!=", "<": ">", "<=": ">=",
                   ">": "<", ">=": "<="}.get(sym)
        if sym not in ("=", "!=", "<", "<=", ">", ">="):
            return None
        wd = _cast_dev(wide.data, wide.dtype, common)
        if wd.dtype.is_floating_point or wd.dtype == torch.bool:
            return None
        count_dispatch("predicate_narrow")
        return narrow_compare(sym, nar.narrow, wd)

    def _eval_cpu(self, batch, kids):
        l, r = kids
        valid = H.and_valid(l.validity, r.validity)
        if any(isinstance(c.dtype, t.StringType) for c in self.children):
            # codes in one sorted dictionary order as the strings do
            _u, (lc, rc) = _unified_codes([l, r])
            return H.column(self._op_cpu(lc, rc), valid, t.BOOLEAN)
        common = self._common()
        if isinstance(common, t.DecimalType):
            sa = _as_decimal(self.children[0].dtype).scale
            sb = _as_decimal(self.children[1].dtype).scale
            ld, ok_a = H.rescale(l.data.astype(np.int64), sa, common.scale)
            rd, ok_b = H.rescale(r.data.astype(np.int64), sb, common.scale)
            if l.hi is None and r.hi is None and (ok_a & ok_b).all():
                return H.column(self._op_cpu(ld, rd), valid, t.BOOLEAN)
            # a value past int64 (a high word, or the common scale's
            # upscale): compare the exact values
            ld = l.unscaled() * 10 ** (common.scale - sa)
            rd = r.unscaled() * 10 ** (common.scale - sb)
            return H.column(np.asarray(self._op_cpu(ld, rd), bool), valid,
                            t.BOOLEAN)
        with np.errstate(invalid="ignore"):
            data = self._op_cpu(_lane(l, common), _lane(r, common))
        return H.column(data, valid, t.BOOLEAN)

    def _op_cpu(self, l, r):
        return self._op_dev(l, r)

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
    lifts_literal_children = True
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

    def _eval_cpu(self, batch, kids):
        l, r = kids
        n = batch.num_rows
        lv, rv = H.valid_of(l.validity, n), H.valid_of(r.validity, n)
        ld, rd = l.data.astype(bool), r.data.astype(bool)
        return H.column((ld & lv) & (rd & rv),
                        (lv & rv) | (lv & ~ld) | (rv & ~rd), t.BOOLEAN)


class Or(Expression):
    lifts_literal_children = True
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

    def _eval_cpu(self, batch, kids):
        l, r = kids
        n = batch.num_rows
        lv, rv = H.valid_of(l.validity, n), H.valid_of(r.validity, n)
        true_l = lv & l.data.astype(bool)
        true_r = rv & r.data.astype(bool)
        return H.column(true_l | true_r, (lv & rv) | true_l | true_r,
                        t.BOOLEAN)


class Not(Expression):
    lifts_literal_children = True
    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = self.children[0].nullable

    def _eval_dev(self, ctx, kids):
        return DevVal(~kids[0].data, kids[0].validity, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        return H.column(~kids[0].data.astype(bool), kids[0].validity,
                        t.BOOLEAN)


class IsNull(Expression):
    lifts_literal_children = True
    nullable = False

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        v = kids[0].validity
        return DevVal(ctx.full(False, torch.bool) if v is None else ~v, None,
                      t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        return H.column(~H.valid_of(kids[0].validity, batch.num_rows), None,
                        t.BOOLEAN)


class IsNotNull(Expression):
    lifts_literal_children = True
    nullable = False

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def _eval_dev(self, ctx, kids):
        v = kids[0].validity
        return DevVal(ctx.full(True, torch.bool) if v is None else v, None,
                      t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        return H.column(H.valid_of(kids[0].validity, batch.num_rows).copy(),
                        None, t.BOOLEAN)


class Coalesce(Expression):
    lifts_literal_children = True
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

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        dictionary = None
        if isinstance(self.dtype, t.StringType):
            dictionary, lanes = _unified_codes(kids)
        else:
            lanes = [_lane(k, self.dtype) for k in kids]
        data = np.zeros(n, t.physical_np_dtype(self.dtype))
        taken = np.zeros(n, bool)
        for k, lane in zip(kids, lanes):
            use = H.valid_of(k.validity, n) & ~taken
            data = np.where(use, lane, data)
            taken |= use
        return H.column(data, taken, self.dtype, dictionary)

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
    lifts_literal_children = True

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

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        p, a, b = kids
        cond = p.data.astype(bool) & H.valid_of(p.validity, n)
        dictionary = None
        if isinstance(self.dtype, t.StringType):
            dictionary, (ad, bd) = _unified_codes([a, b])
        else:
            ad, bd = _lane(a, self.dtype), _lane(b, self.dtype)
        return H.column(np.where(cond, ad, bd),
                        np.where(cond, H.valid_of(a.validity, n),
                                 H.valid_of(b.validity, n)),
                        self.dtype, dictionary)

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
    lifts_literal_children = True

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

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        vals = [kids[i] for i in self._value_slots()]
        dictionary = None
        if isinstance(self.dtype, t.StringType):
            dictionary, lanes = _unified_codes(vals)
            if len(dictionary) == 0:
                dictionary = np.array([""], str)
        else:
            lanes = [_lane(v, self.dtype) for v in vals]
        if self.has_else:
            data = lanes[-1]
            valid = H.valid_of(vals[-1].validity, n)
        else:
            data = np.zeros(n, t.physical_np_dtype(self.dtype))
            valid = np.zeros(n, bool)
        decided = np.zeros(n, bool)
        for i in range(self.n_branches):
            c = kids[2 * i]
            hit = c.data.astype(bool) & H.valid_of(c.validity, n) & ~decided
            data = np.where(hit, lanes[i], data)
            valid = np.where(hit, H.valid_of(vals[i].validity, n), valid)
            decided |= hit
        if not self.has_else:
            valid = valid & decided
        return H.column(data, valid, self.dtype, dictionary)


class In(Expression):
    """value IN (literals...), with Spark's null semantics: a null value
    gives null, and so does no match when the list holds a null.  A
    string value over a duplicate-free dictionary compares its code with
    each item's (`encodings.literal_code`) when the list has at most
    `encoded.dict.inMaxCodes` items, else it gathers a membership mask
    over its dictionary by code.  A FOR-narrowed integer value compares
    its narrow lane with each item through `encodings.narrow_compare`;
    any other compares its lane with each item as a tensor of the lane's
    dtype."""

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
            from ..ops import encodings as ENC
            d = v.dictionary if v.dictionary is not None \
                else np.array([], str)
            pol = ENC.encoding_policy(ctx.conf)
            if pol.enabled and pol.dict_predicates and \
                    len(non_null) <= pol.in_max_codes and \
                    ENC.is_unique_dict(d) and \
                    ENC.elect_encoded(ctx.conf, "in_codes"):
                data = ctx.full(False, torch.bool)
                for code in sorted({ENC.literal_code(d, x)
                                    for x in non_null}):
                    data = data | (v.data == code)
            else:
                mask = np.isin(d, np.array(non_null, str)) if len(d) \
                    else np.zeros(1, bool)
                if pol.enabled:
                    ENC.count_decode("in_codes", ctx.capacity)
                data = _remap_codes(v.data, mask)
        else:
            data = ctx.full(False, torch.bool)
            # each item a tensor of the (widened) lane's dtype, never a
            # Python scalar against a narrow lane, which would not promote
            wide = compute_dtype(self.children[0].dtype) \
                if v.narrow is not None else v.data.dtype
            for x in non_null:
                item = host_constant(np.asarray(x), ctx.device, wide)
                if v.narrow is not None:
                    from ..ops.encodings import (count_dispatch,
                                                 narrow_compare)
                    count_dispatch("in_narrow")
                    data = data | narrow_compare("=", v.narrow, item)
                else:
                    data = data | (v.data == item)
        vv = valid_or_true(v.validity, ctx.capacity, ctx.device)
        valid = vv & data if has_null_item else vv
        return DevVal(data & vv, valid, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        v = kids[0]
        n = batch.num_rows
        non_null = [x for x in self.items if x is not None]
        if isinstance(self.children[0].dtype, t.StringType):
            d = v.dictionary if v.dictionary is not None \
                else np.array([], str)
            mask = np.isin(d, np.array(non_null, str)) if len(d) \
                else np.zeros(1, bool)
            data = mask[np.clip(v.data, 0, len(mask) - 1)]
        elif non_null:
            data = np.isin(v.data, np.array(non_null).astype(v.data.dtype))
        else:
            data = np.zeros(n, bool)
        vv = H.valid_of(v.validity, n)
        valid = vv & data if len(non_null) < len(self.items) else vv
        return H.column(data & vv, valid, t.BOOLEAN)

    def _fp_extra(self):
        return repr(self.items)


# ---------------------------------------------------------------------------
# Casts (numeric, boolean and decimal; from STRING by the dictionary)
# ---------------------------------------------------------------------------

def _date_timestamp_pair(src: t.DataType, dst: t.DataType) -> bool:
    return (isinstance(src, t.DateType) and
            isinstance(dst, t.TimestampType)) or \
        (isinstance(src, t.TimestampType) and isinstance(dst, t.DateType))


def _date_timestamp(x, src: t.DataType, tz: str, device):
    """DATE -> TIMESTAMP: the local midnight's instant in `tz`; TIMESTAMP
    -> DATE: the instant's local day (floor).  A tensor with a device,
    numpy without."""
    from .datetime import local_us, utc_us_of_wall
    from ..ops.datetime import US_PER_DAY
    wide = x.to(torch.int64) if device is not None else x.astype(np.int64)
    if isinstance(src, t.DateType):
        return utc_us_of_wall(wide * US_PER_DAY, tz, device)
    days = local_us(wide, tz, device) // US_PER_DAY
    return days.to(torch.int32) if device is not None \
        else days.astype(np.int32)


class Cast(Expression):
    """CAST(child AS to).  From STRING, each dictionary entry is parsed
    once on the host by `_parse_entry` (the reference's rules: trimmed
    input, non-ANSI, null for anything invalid) into a value lane and an
    ok lane, which the rows gather by code."""
    lifts_literal_children = True

    reads_hi = True

    def __init__(self, child, to: t.DataType):
        self.children = (child,)
        self.to = to

    def _resolve(self):
        self.dtype = self.to
        self.nullable = self.children[0].nullable or isinstance(
            self.children[0].dtype, t.StringType)

    def unsupported_reasons(self, conf):
        src, dst = self.children[0].dtype, self.to
        if consumes_wide_host(self.children[0]):
            # two-lane -> f64 (_eval_dev), the reference's one form
            return [] if t.is_floating(dst) else [WIDE_HOST_REASON]
        if src == dst:
            return []
        numeric = (t.NumericType, t.BooleanType)
        if isinstance(src, numeric) and isinstance(dst, numeric):
            return []
        if isinstance(src, t.StringType) and \
                isinstance(dst, numeric + (t.DateType,)):
            return []
        if _date_timestamp_pair(src, dst):
            return []
        if isinstance(dst, t.StringType):
            return [f"cast {src.simple_string}->string not yet on device"]
        # the reference's CPU oracle casts these with pyarrow; the port's
        # CPU engine has no such cast yet, so the port refuses
        return [Unported(f"cast {src.simple_string}->{dst.simple_string} "
                         "has no form in either engine of the port")]

    @staticmethod
    def _parse_entry(s: Optional[str], dst: t.DataType):
        """Spark's non-ANSI string cast as the reference (and its CPU
        oracle) runs it: the text trimmed by str.strip(); invalid text,
        and a value outside the target type, give None.  Integral
        targets parse through Decimal and truncate toward zero; DECIMAL
        rounds HALF_UP to the scale (its unscaled value); DATE takes
        'y-m-d' before any 'T' or ' '; BOOLEAN takes t/true/y/yes/1 and
        f/false/n/no/0 in any case."""
        if s is None:
            return None
        s = s.strip()
        if not s:
            return None
        try:
            if isinstance(dst, t.DateType):
                parts = s.split("T")[0].split(" ")[0].split("-")
                if len(parts) != 3:
                    return None
                y, m, d = (int(p) for p in parts)
                return (pydt.date(y, m, d) - pydt.date(1970, 1, 1)).days
            if isinstance(dst, t.DecimalType):
                v = pydec.Decimal(s).scaleb(dst.scale, EXACT).to_integral_value(
                    rounding=pydec.ROUND_HALF_UP)
                iv = int(v)
                if abs(iv) > 10 ** min(dst.precision, 18) - 1:
                    return None
                return iv
            if t.is_floating(dst):
                return float(s)
            if t.is_integral(dst):
                d = pydec.Decimal(s)
                iv = int(d.to_integral_value(rounding=pydec.ROUND_DOWN))
                info = np.iinfo(t.physical_np_dtype(dst))
                if iv < info.min or iv > info.max:
                    return None
                return iv
            if isinstance(dst, t.BooleanType):
                low = s.lower()
                if low in ("t", "true", "y", "yes", "1"):
                    return True
                if low in ("f", "false", "n", "no", "0"):
                    return False
                return None
        except (ValueError, ArithmeticError):
            return None
        return None

    def parsed(self, d: np.ndarray, device):
        """(value lane, ok lane, exact (lo, hi) of the ok integral values
        or None) of dictionary `d` on `device`, one entry each (one
        not-ok entry for an empty dictionary)."""
        def make():
            dst = self.to
            out = [self._parse_entry(v, dst) for v in d.tolist()] or [None]
            ok = np.array([v is not None for v in out], bool)
            vals = np.array([0 if v is None else v for v in out],
                            np.float64 if t.is_floating(dst)
                            else t.physical_np_dtype(dst))
            with np.errstate(over="ignore"):     # FLOAT: past it is inf
                vals = vals.astype(t.physical_np_dtype(dst))
            rng = (int(vals[ok].min()), int(vals[ok].max())) \
                if t.is_integral(dst) and ok.any() else None
            return (host_constant(vals, device), host_constant(ok, device),
                    rng)
        return per_dictionary(self, "_parsed").get(d, make)

    def parsed_np(self, d: np.ndarray):
        """(value lane, ok lane) of dictionary `d` on the host, one entry
        each (one not-ok entry for an empty dictionary)."""
        def make():
            dst = self.to
            out = [self._parse_entry(v, dst) for v in d.tolist()] or [None]
            ok = np.array([v is not None for v in out], bool)
            vals = np.array([0 if v is None else v for v in out],
                            np.float64 if t.is_floating(dst)
                            else t.physical_np_dtype(dst))
            with np.errstate(over="ignore"):
                vals = vals.astype(t.physical_np_dtype(dst))
            return vals, ok
        return per_dictionary(self, "_parsed_np").get(d, make)

    def _eval_cpu(self, batch, kids):
        src, dst = self.children[0].dtype, self.to
        k = kids[0]
        x, valid = k.data, k.validity
        if src == dst:
            return k
        if isinstance(dst, t.StringType):
            return _to_string_column(k, src)
        if isinstance(src, t.StringType):
            vals, ok = self.parsed_np(dict_or_empty(k.dictionary))
            codes = np.clip(x, 0, len(vals) - 1)
            return H.column(vals[codes], H.and_valid(valid, ok[codes]), dst)
        if _date_timestamp_pair(src, dst):
            from .datetime import session_timezone
            return H.column(_date_timestamp(x, src, session_timezone(),
                                            None), valid, dst)
        if not isinstance(src, (t.NumericType, t.BooleanType, t.NullType)) \
                or not isinstance(dst, (t.NumericType, t.BooleanType)):
            raise NotImplementedError(
                f"cast {src.simple_string}->{dst.simple_string} has no "
                "CPU form")
        if isinstance(src, t.DecimalType) and k.hi is not None:
            return _wide_cast_cpu(k, src, dst)
        if isinstance(src, t.DecimalType):
            u = x.astype(np.int64)
            if isinstance(dst, t.DecimalType):
                data, ok = H.rescale(u, src.scale, dst.scale)
                ok = ok & H.fits_precision(data, dst.precision)
                return H.exact_where_int64_fails(
                    H.column(data, H.and_valid(valid, ok), dst), valid, ok,
                    lambda rows: H.wide_rescale(H.take(k, rows), src.scale,
                                                dst))
            if t.is_floating(dst):
                return H.column(H.decimal_to_double(u, src.scale), valid,
                                dst)
            if isinstance(dst, t.BooleanType):
                return H.column(u != 0, valid, dst)
            ints = H.decimal_to_integral(u, src.scale)
            info = np.iinfo(t.physical_np_dtype(dst))
            ok = (ints >= int(info.min)) & (ints <= int(info.max))
            return H.column(ints, H.and_valid(valid, ok), dst)
        if isinstance(dst, t.DecimalType):
            if t.is_floating(src):
                data, ok = H.decimal_from_double(x, dst)
            else:
                data, ok = H.upscale(x.astype(np.int64), dst.scale)
                ok = ok & H.fits_precision(data, dst.precision)
                return H.exact_where_int64_fails(
                    H.column(data, H.and_valid(valid, ok), dst), valid, ok,
                    lambda rows: H.wide_rescale(H.take(k, rows), 0, dst))
            return H.column(data, H.and_valid(valid, ok), dst)
        if isinstance(dst, t.BooleanType):
            data = x != 0
        elif t.is_floating(src) and t.is_integral(dst):
            f = np.trunc(np.where(np.isnan(x), 0.0, x.astype(np.float64)))
            i64 = np.clip(f, -9.223372036854776e18,
                          9.223372036854775e18).astype(np.int64)
            info = np.iinfo(t.physical_np_dtype(dst))
            data = np.clip(i64, int(info.min), int(info.max))
        else:
            with np.errstate(over="ignore"):
                data = x.astype(t.physical_np_dtype(dst))
        return H.column(data, valid, dst)

    def _eval_dev(self, ctx, kids):
        from ..ops import decimal as D
        src, dst = self.children[0].dtype, self.to
        if src == dst:
            return kids[0]
        if kids[0].hi is not None and t.is_floating(dst):
            return DevVal(D.wide_to_double(kids[0].data, kids[0].hi,
                                           src.scale).to(compute_dtype(dst)),
                          kids[0].validity, dst)
        kids = [narrow_dev(kids[0], "Cast")]
        x, valid = kids[0].data, kids[0].validity
        if _date_timestamp_pair(src, dst):
            from .datetime import conf_timezone
            return DevVal(_date_timestamp(x, src, conf_timezone(ctx.conf),
                                          ctx.device), valid, dst)
        if isinstance(src, t.StringType):
            vals, ok, rng = self.parsed(dict_or_empty(kids[0].dictionary),
                                        ctx.device)
            codes = torch.clamp(x, 0, vals.shape[0] - 1).long()
            return DevVal(vals[codes], merge_validity(valid, ok[codes]), dst,
                          value_range=rng)
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


def _wide_cast_cpu(k: HostColumn, src: t.DecimalType,
                   dst: t.DataType) -> HostColumn:
    """CAST of a DECIMAL column holding a high word, exact in Python
    ints: to DECIMAL HALF_UP and null past the precision, to DOUBLE the
    correctly rounded quotient, to an integral type truncated and null
    outside it, to BOOLEAN non-zero."""
    ints = k.unscaled()
    if isinstance(dst, t.DecimalType):
        return H.wide_rescale(k, src.scale, dst)
    if isinstance(dst, t.StringType):
        return _to_string_column(k, src)
    f = 10 ** src.scale
    vals = ints.tolist()
    if t.is_floating(dst):
        return H.column(np.array([v / f for v in vals], np.float64),
                        k.validity, dst)
    if isinstance(dst, t.BooleanType):
        return H.column(np.array([v != 0 for v in vals], bool), k.validity,
                        dst)
    info = np.iinfo(t.physical_np_dtype(dst))
    q = [(abs(v) // f) * (-1 if v < 0 else 1) for v in vals]
    ok = np.array([int(info.min) <= x <= int(info.max) for x in q], bool)
    data = np.array([x if o else 0 for x, o in zip(q, ok)] + [0],
                    np.int64)[:-1]
    return H.column(data, H.and_valid(k.validity, ok), dst)


def format_double(v: float, single: bool = False) -> str:
    """A FLOAT or DOUBLE as the reference's CPU engine writes it in a
    cast to STRING: the shortest digits that read back to the value,
    fixed notation for decimal exponents -6 to 9 and scientific beyond
    (1e+10, 1e-7), no trailing '.0', and nan, inf, -inf."""
    if v != v:
        return "nan"
    if v in (float("inf"), float("-inf")):
        return "inf" if v > 0 else "-inf"
    if v == 0:
        return "-0" if np.signbit(v) else "0"
    x = np.float32(v) if single else np.float64(v)
    sci = np.format_float_scientific(x, unique=True, trim="-")
    mant, exp = sci.split("e")
    e = int(exp)
    sign = "-" if mant.startswith("-") else ""
    digits = mant.lstrip("-").replace(".", "")
    if -6 <= e < 10:
        if e >= 0:
            whole = digits[:e + 1].ljust(e + 1, "0")
            frac = digits[e + 1:]
        else:
            whole, frac = "0", "0" * (-e - 1) + digits
        return sign + whole + ("." + frac if frac else "")
    body = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return f"{sign}{body}e{'+' if e >= 0 else '-'}{abs(e)}"


def _format_value(v, src: t.DataType) -> str:
    """One storage-lane value of type `src` as a cast to STRING writes
    it (the reference's CPU engine: Arrow's casts)."""
    if isinstance(src, t.BooleanType):
        return "true" if v else "false"
    if t.is_floating(src):
        return format_double(float(v), isinstance(src, t.FloatType))
    if isinstance(src, t.DecimalType):
        return format(decimal_value(v, src.scale), "f")
    if isinstance(src, t.DateType):
        d = np.datetime64(int(v), "D").astype(object)
        if isinstance(d, pydt.date):
            return f"{d.year:04d}-{d.month:02d}-{d.day:02d}"
        return str(np.datetime64(int(v), "D"))
    if isinstance(src, t.TimestampType):
        us = int(v)
        ts = pydt.datetime(1970, 1, 1) + pydt.timedelta(microseconds=us)
        return ts.strftime("%Y-%m-%d %H:%M:%S.%f") + "Z"
    return str(int(v))


def _to_string_column(k: HostColumn, src: t.DataType) -> HostColumn:
    """CAST(k AS STRING): each distinct value formatted once, the rows
    re-encoded into a sorted dictionary."""
    n = len(k)
    if isinstance(src, t.NullType):
        return H.string_literal_column(None, n)
    if isinstance(src, t.StringType):
        return k
    lane = k.data if k.hi is None else k.unscaled()
    if lane.dtype.kind == "f":
        # by bits: -0.0 and 0.0 print differently
        lane = lane.astype(np.float64).view(np.int64)
    uniq, inv = np.unique(lane, return_inverse=True)
    values = uniq.view(np.float64) if k.data.dtype.kind == "f" else uniq
    entries = [_format_value(v, src) for v in values.tolist()]
    return H.strings_from_entries(inv.reshape(-1), entries, k.validity)


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


# ---------------------------------------------------------------------------
# Bitwise family (GroupingSets.grouping() compiles to BitwiseAnd of a
# ShiftRight of the grouping id)
# ---------------------------------------------------------------------------

def _bits_of(dt: t.DataType) -> int:
    return 8 * np.dtype(t.physical_np_dtype(dt)).itemsize


class _BitwiseBinary(Expression):
    """a op b on integral lanes, the left operand's type; the operands
    combine in int64 and the result narrows (wraps) to that type."""
    _op = None

    def __init__(self, left, right):
        self.children = (left, right)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = any(c.nullable for c in self.children)

    def unsupported_reasons(self, conf):
        return [f"bitwise over {c.dtype.simple_string}"
                for c in self.children if not t.is_integral(c.dtype)]

    def _eval_dev(self, ctx, kids):
        a, b = kids
        out = type(self)._op(a.data.to(torch.int64), b.data.to(torch.int64))
        return DevVal(out.to(compute_dtype(self.dtype)),
                      merge_validity(a.validity, b.validity), self.dtype)

    def _eval_cpu(self, batch, kids):
        a, b = kids
        out = type(self)._np_op(a.data.astype(np.int64),
                                b.data.astype(np.int64))
        return H.column(out.astype(t.physical_np_dtype(self.dtype)),
                        H.and_valid(a.validity, b.validity), self.dtype)


class BitwiseAnd(_BitwiseBinary):
    _op = staticmethod(torch.bitwise_and)
    _np_op = staticmethod(np.bitwise_and)


class BitwiseOr(_BitwiseBinary):
    _op = staticmethod(torch.bitwise_or)
    _np_op = staticmethod(np.bitwise_or)


class BitwiseXor(_BitwiseBinary):
    _op = staticmethod(torch.bitwise_xor)
    _np_op = staticmethod(np.bitwise_xor)


class BitwiseNot(Expression):
    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        if not t.is_integral(self.children[0].dtype):
            return [f"bitwise over {self.children[0].dtype.simple_string}"]
        return []

    def _eval_dev(self, ctx, kids):
        return DevVal(torch.bitwise_not(kids[0].data), kids[0].validity,
                      self.dtype)

    def _eval_cpu(self, batch, kids):
        return H.column(np.bitwise_not(kids[0].data), kids[0].validity,
                        self.dtype)


class _Shift(Expression):
    """Java shift semantics (Spark ShiftLeft/ShiftRight/
    ShiftRightUnsigned): the distance is masked to 5 bits for INT and 6
    for LONG.  Every shift runs in int64: PyTorch has no unsigned 64-bit
    shift on CUDA, so `>>>` is an arithmetic shift with the sign copies
    masked off, and INT results wrap back to 32 bits."""
    _kind = "left"

    def __init__(self, child, amount):
        self.children = (child, amount)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = any(c.nullable for c in self.children)

    def unsupported_reasons(self, conf):
        out = []
        if not isinstance(self.children[0].dtype,
                          (t.IntegerType, t.LongType)):
            out.append("shift base must be INT or BIGINT")
        if not t.is_integral(self.children[1].dtype):
            out.append("shift amount must be integral")
        return out

    def _eval_dev(self, ctx, kids):
        bits = _bits_of(self.dtype)
        sh = kids[1].data.to(torch.int64) & (bits - 1)
        v = kids[0].data.to(torch.int64)
        if self._kind == "left":
            out = v << sh
        elif self._kind == "right":
            out = v >> sh
        else:
            if bits == 32:
                v = v & 0xFFFFFFFF
            # the top `sh` bits of an arithmetic shift are sign copies:
            # clear them (sh == 0 keeps every bit)
            keep = torch.where(sh == 0, torch.full_like(sh, -1),
                               ~(torch.full_like(sh, -1) << (64 - sh)))
            out = (v >> sh) & keep
        if bits == 32:
            # wrap to 32 bits, two's complement
            out = out & 0xFFFFFFFF
            out = torch.where(out >= 1 << 31, out - (1 << 32), out)
        return DevVal(out.to(compute_dtype(self.dtype)),
                      merge_validity(kids[0].validity, kids[1].validity),
                      self.dtype)

    def _eval_cpu(self, batch, kids):
        bits = _bits_of(self.dtype)
        sh = kids[1].data.astype(np.int64) & (bits - 1)
        v = kids[0].data.astype(np.int64)
        with np.errstate(over="ignore"):
            if self._kind == "left":
                out = np.left_shift(v, sh)
            elif self._kind == "right":
                out = np.right_shift(v, sh)
            else:
                u = v.view(np.uint64) if bits == 64 else \
                    (v & 0xFFFFFFFF).astype(np.uint64)
                out = np.right_shift(u, sh.astype(np.uint64)).view(np.int64)
        if bits == 32:
            out = out & 0xFFFFFFFF
            out = np.where(out >= 1 << 31, out - (1 << 32), out)
        return H.column(out.astype(t.physical_np_dtype(self.dtype)),
                        H.and_valid(kids[0].validity, kids[1].validity),
                        self.dtype)


class ShiftLeft(_Shift):
    _kind = "left"


class ShiftRight(_Shift):
    _kind = "right"


class ShiftRightUnsigned(_Shift):
    _kind = "unsigned"


_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101
#: bits set in each byte value
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


class BitCount(Expression):
    """bit_count(x): population count of the two's-complement form of
    the value sign-extended to 64 bits (Spark), by the SWAR steps."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        dt = self.children[0].dtype
        if not (t.is_integral(dt) or isinstance(dt, t.BooleanType)):
            return [f"bit_count over {dt.simple_string}"]
        return []

    def _eval_dev(self, ctx, kids):
        x = kids[0].data.to(torch.int64)
        if kids[0].data.dtype == torch.bool:
            return DevVal(x.to(torch.int32), kids[0].validity, t.INT)
        # each mask clears the sign copies an arithmetic >> brings in
        x = x - ((x >> 1) & _M1)
        x = (x & _M2) + ((x >> 2) & _M2)
        x = (x + (x >> 4)) & _M4
        cnt = ((x * _H01) >> 56) & 0x7F
        return DevVal(cnt.to(torch.int32), kids[0].validity, t.INT)

    def _eval_cpu(self, batch, kids):
        x = kids[0].data
        if x.dtype == np.bool_:
            return H.column(x.astype(np.int32), kids[0].validity, t.INT)
        u = x.astype(np.int64).view(np.uint64)
        cnt = np.zeros(len(u), np.int32)
        for shift in range(0, 64, 8):
            cnt += _POPCOUNT8[(u >> np.uint64(shift)) & np.uint64(0xFF)]
        return H.column(cnt, kids[0].validity, t.INT)


# ---------------------------------------------------------------------------
# Integral division, remainder, negation, abs, <=> and IS NaN
# ---------------------------------------------------------------------------

class IntegralDivide(BinaryArithmetic):
    """Spark `div`: LONG division truncating toward zero (Java), x div 0
    -> NULL, Long.MIN_VALUE div -1 wraps to Long.MIN_VALUE.  The divisor
    -1 is taken apart so no lane divides MIN by it (a trap on the CPU)."""
    symbol = "div"

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = True

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        if any(t.is_floating(c.dtype) for c in self.children):
            out.append("integral divide of floating input")
        return out

    def _eval_dev(self, ctx, kids):
        l, r = kids
        ld = l.data.to(torch.int64)
        rd = r.data.to(torch.int64)
        plain = (rd != 0) & (rd != -1)
        q = torch.div(ld, torch.where(plain, rd, torch.ones_like(rd)),
                      rounding_mode="trunc")
        q = torch.where(rd == -1, -ld, q)
        return DevVal(q, merge_validity(l.validity, r.validity, rd != 0),
                      t.LONG)

    def _eval_cpu(self, batch, kids):
        l, r = kids
        valid = H.and_valid(l.validity, r.validity)
        if self._is_decimal():
            # exact: both unscaled values at one scale, quotient
            # truncated toward zero (Python ints: no int64 step)
            sa = _as_decimal(l.dtype).scale
            sb = _as_decimal(r.dtype).scale
            s_ = max(sa, sb)
            lv = H.valid_of(valid, len(l))
            out = np.zeros(len(l), np.int64)
            ok = np.zeros(len(l), bool)
            for i, (a, b) in enumerate(zip(l.unscaled().tolist(),
                                           r.unscaled().tolist())):
                a, b = int(a) * 10 ** (s_ - sa), int(b) * 10 ** (s_ - sb)
                if not lv[i] or b == 0:
                    continue
                q = abs(a) // abs(b)
                q = -q if (a < 0) != (b < 0) else q
                if -2 ** 63 <= q < 2 ** 63:
                    out[i], ok[i] = q, True
            return H.column(out, ok, t.LONG)
        ld = l.data.astype(np.int64)
        rd = r.data.astype(np.int64)
        plain = (rd != 0) & (rd != -1)
        safe = np.where(plain, rd, 1)
        # floor division, moved toward zero (no abs: |Long.MIN_VALUE|
        # wraps)
        q = ld // safe
        q = np.where((q * safe != ld) & ((ld < 0) != (safe < 0)), q + 1, q)
        with np.errstate(over="ignore"):
            q = np.where(rd == -1, -ld, q)
        return H.column(q, H.and_valid(valid, rd != 0), t.LONG)


def _numpy_on_cpu(torch_fn, numpy_fn):
    """`torch_fn` on card lanes, `numpy_fn` on CPU lanes: for the
    functions whose vectorized PyTorch CPU versions fail where the C
    library and the card's do not."""
    def fn(*lanes: torch.Tensor) -> torch.Tensor:
        if lanes[0].device.type == "cpu":
            # the plain version's own host math, not a host decision:
            # the card runs torch_fn on the device
            with np.errstate(all="ignore"), host_reads_ok():
                return torch.from_numpy(numpy_fn(*(x.numpy()
                                                   for x in lanes)))
        return torch_fn(*lanes)
    return fn


#: C's fmod of float64 lanes, exact: PyTorch's vectorized CPU fmod
#: divides first and gives NaN once |a / b| passes the double range
#: (-1.75e308 % -0.857)
_fmod = _numpy_on_cpu(torch.fmod, np.fmod)


class Remainder(BinaryArithmetic):
    """Spark %: Java's remainder, the dividend's sign (C fmod, not
    Python's modulo), x % 0 -> NULL; integral lanes compute in int64 and
    narrow back, and x % -1 is 0 without dividing (MIN % -1 traps)."""
    symbol = "%"

    @property
    def decimal_rule(self):
        def rule(a: t.DecimalType, b: t.DecimalType) -> t.DecimalType:
            s = max(a.scale, b.scale)
            p = min(a.precision - a.scale, b.precision - b.scale) + s
            return t.DecimalType(max(p, 1), s)
        return rule

    def _eval_dev(self, ctx, kids):
        l, r = kids
        if t.is_floating(self.dtype):
            ld = l.data.to(torch.float64)
            rd = r.data.to(torch.float64)
            nz = rd != 0
            data = _fmod(ld, torch.where(nz, rd, torch.ones_like(rd)))
        else:
            ld = l.data.to(torch.int64)
            rd = r.data.to(torch.int64)
            nz = rd != 0
            plain = nz & (rd != -1)
            data = torch.fmod(ld, torch.where(plain, rd,
                                              torch.ones_like(rd)))
        return DevVal(data.to(compute_dtype(self.dtype)),
                      merge_validity(l.validity, r.validity, nz), self.dtype)

    def _eval_cpu(self, batch, kids):
        l, r = kids
        if self._is_decimal():
            return self._decimal_eval_cpu(l, r)
        with np.errstate(all="ignore"):
            if t.is_floating(self.dtype):
                ld, rd = l.data.astype(np.float64), r.data.astype(np.float64)
                nz = rd != 0
                data = np.fmod(ld, np.where(nz, rd, 1.0))
            else:
                ld, rd = l.data.astype(np.int64), r.data.astype(np.int64)
                nz = rd != 0
                plain = nz & (rd != -1)
                data = np.where(plain, np.fmod(ld, np.where(plain, rd, 1)),
                                0)
        return H.column(data.astype(t.physical_np_dtype(self.dtype)),
                        H.and_valid(l.validity, r.validity, nz), self.dtype)


def _numeric_reasons(children) -> List[str]:
    return [f"non-numeric operand {c.dtype.simple_string}"
            for c in children
            if not (t.is_numeric(c.dtype) or isinstance(c.dtype, t.NullType))]


class UnaryMinus(Expression):
    """-x: integral lanes wrap (-Long.MIN_VALUE is Long.MIN_VALUE), a
    decimal negates its unscaled lane."""
    lifts_literal_children = True

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return _numeric_reasons(self.children)

    def _eval_dev(self, ctx, kids):
        return DevVal(torch.neg(kids[0].data), kids[0].validity, self.dtype)

    def _eval_cpu(self, batch, kids):
        with np.errstate(over="ignore"):
            return H.column(np.negative(kids[0].data), kids[0].validity,
                            self.dtype)


class Abs(Expression):
    """abs(x): integral lanes wrap (abs(Long.MIN_VALUE) is
    Long.MIN_VALUE, Java's Math.abs), floats clear the sign bit (-0.0 ->
    0.0, NaN stays NaN)."""
    lifts_literal_children = True

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return _numeric_reasons(self.children)

    def _eval_dev(self, ctx, kids):
        x = kids[0].data
        data = torch.abs(x) if x.is_floating_point() \
            else torch.where(x < 0, torch.neg(x), x)
        return DevVal(data, kids[0].validity, self.dtype)

    def _eval_cpu(self, batch, kids):
        x = kids[0].data
        with np.errstate(over="ignore"):
            data = np.abs(x) if x.dtype.kind == "f" else \
                np.where(x < 0, np.negative(x), x)
        return H.column(data, kids[0].validity, self.dtype)


class EqualNullSafe(BinaryComparison):
    """a <=> b: never null; true when both sides are null, false when one
    is, else a = b (the same lanes and dictionaries as EqualTo)."""
    symbol = "<=>"
    nullable = False

    def unsupported_reasons(self, conf):
        return []

    def _op_dev(self, l, r):
        return l == r

    def _eval_dev(self, ctx, kids):
        cap, dev = ctx.capacity, ctx.device
        eq = BinaryComparison._eval_dev(self, ctx, kids)
        lv = valid_or_true(kids[0].validity, cap, dev)
        rv = valid_or_true(kids[1].validity, cap, dev)
        same = eq.data & valid_or_true(eq.validity, cap, dev) & lv & rv
        return DevVal(same | (~lv & ~rv), None, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        eq = BinaryComparison._eval_cpu(self, batch, kids)
        lv = H.valid_of(kids[0].validity, n)
        rv = H.valid_of(kids[1].validity, n)
        same = eq.data & H.valid_of(eq.validity, n) & lv & rv
        return H.column(same | (~lv & ~rv), None, t.BOOLEAN)


class IsNaN(Expression):
    """isnan(x) of a FLOAT or DOUBLE: never null (a null input is false).
    Other input types are refused, as the reference's device path does
    (Spark's analyzer accepts only floating input)."""
    nullable = False

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.BOOLEAN

    def unsupported_reasons(self, conf):
        dt = self.children[0].dtype
        if t.is_floating(dt) or isinstance(dt, t.NullType):
            return []
        return [f"input type {dt.simple_string} not supported"]

    def _eval_dev(self, ctx, kids):
        nan = torch.isnan(kids[0].data.to(torch.float64))
        v = kids[0].validity
        return DevVal(nan if v is None else nan & v, None, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        nan = np.isnan(kids[0].data.astype(np.float64))
        return H.column(nan & H.valid_of(kids[0].validity, batch.num_rows),
                        None, t.BOOLEAN)


# ---------------------------------------------------------------------------
# Math functions (DOUBLE results)
# ---------------------------------------------------------------------------

def _f64(kid: DevVal) -> torch.Tensor:
    """A numeric operand as float64: a decimal by its value (the unscaled
    lane over 10^scale, ops/decimal.to_double), any other by its lane."""
    if isinstance(kid.dtype, t.DecimalType):
        from ..ops import decimal as D
        return D.to_double(kid.data.to(torch.int64), kid.dtype.scale)
    return kid.data.to(torch.float64)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root (PyTorch has none): |x|^(1/3) refined by one Newton step,
    the sign put back; 0, ±inf and NaN pass through."""
    a = torch.abs(x)
    y = torch.pow(a, 1.0 / 3.0)
    ok = (a > 0) & torch.isfinite(a)
    ys = torch.where(ok, y, torch.ones_like(y))
    y = torch.where(ok, ys - (ys * ys * ys - a) / (3.0 * ys * ys), y)
    return torch.where(x < 0, -y, torch.where(ok, y, x))


def _signum_np(x: np.ndarray) -> np.ndarray:
    return np.where((x == 0) | np.isnan(x), x, np.where(x > 0, 1.0, -1.0))


def _signum(x: torch.Tensor) -> torch.Tensor:
    """Java Math.signum: ±1.0, a zero keeps its sign, NaN stays NaN."""
    one = torch.ones_like(x)
    return torch.where((x == 0) | torch.isnan(x), x,
                       torch.where(x > 0, one, -one))


class UnaryMathExpression(Expression):
    """f(x) over the operand as float64, DOUBLE result, nulls in -> nulls
    out.  NaN, ±inf and -0.0 follow IEEE (and the C library) as in the
    reference: sqrt(-1) and asin(2) are NaN, not null."""
    fn = None

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.DOUBLE
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return _numeric_reasons(self.children)

    def _eval_dev(self, ctx, kids):
        return DevVal(type(self).fn(_f64(kids[0])), kids[0].validity,
                      t.DOUBLE)

    def _eval_cpu(self, batch, kids):
        with np.errstate(all="ignore"):
            out = type(self).np_fn(_f64_np(kids[0]))
        return H.column(out, kids[0].validity, t.DOUBLE)


class Sqrt(UnaryMathExpression):
    fn = staticmethod(torch.sqrt)
    np_fn = staticmethod(np.sqrt)


class Exp(UnaryMathExpression):
    fn = staticmethod(torch.exp)
    np_fn = staticmethod(np.exp)


class Expm1(UnaryMathExpression):
    fn = staticmethod(torch.expm1)
    np_fn = staticmethod(np.expm1)


class Cbrt(UnaryMathExpression):
    fn = staticmethod(_cbrt)
    np_fn = staticmethod(np.cbrt)


class Sin(UnaryMathExpression):
    fn = staticmethod(torch.sin)
    np_fn = staticmethod(np.sin)


class Cos(UnaryMathExpression):
    fn = staticmethod(torch.cos)
    np_fn = staticmethod(np.cos)


class Tan(UnaryMathExpression):
    fn = staticmethod(torch.tan)
    np_fn = staticmethod(np.tan)


class Asin(UnaryMathExpression):
    fn = staticmethod(torch.asin)
    np_fn = staticmethod(np.arcsin)


class Acos(UnaryMathExpression):
    fn = staticmethod(torch.acos)
    np_fn = staticmethod(np.arccos)


class Atan(UnaryMathExpression):
    fn = staticmethod(torch.atan)
    np_fn = staticmethod(np.arctan)


class Sinh(UnaryMathExpression):
    # PyTorch's vectorized CPU sinh and cosh overflow to ±inf from
    # |x| = 709.78 on, where the result is still finite up to 710.47
    fn = staticmethod(_numpy_on_cpu(torch.sinh, np.sinh))
    np_fn = staticmethod(np.sinh)


class Cosh(UnaryMathExpression):
    fn = staticmethod(_numpy_on_cpu(torch.cosh, np.cosh))
    np_fn = staticmethod(np.cosh)


class Tanh(UnaryMathExpression):
    fn = staticmethod(torch.tanh)
    np_fn = staticmethod(np.tanh)


class Cot(UnaryMathExpression):
    fn = staticmethod(lambda x: torch.reciprocal(torch.tan(x)))
    np_fn = staticmethod(lambda x: 1.0 / np.tan(x))


class Sec(UnaryMathExpression):
    fn = staticmethod(lambda x: torch.reciprocal(torch.cos(x)))
    np_fn = staticmethod(lambda x: 1.0 / np.cos(x))


class Csc(UnaryMathExpression):
    fn = staticmethod(lambda x: torch.reciprocal(torch.sin(x)))
    np_fn = staticmethod(lambda x: 1.0 / np.sin(x))


class ToDegrees(UnaryMathExpression):
    fn = staticmethod(torch.rad2deg)
    np_fn = staticmethod(np.degrees)


class ToRadians(UnaryMathExpression):
    fn = staticmethod(torch.deg2rad)
    np_fn = staticmethod(np.radians)


class Signum(UnaryMathExpression):
    fn = staticmethod(_signum)
    np_fn = staticmethod(_signum_np)


class Rint(UnaryMathExpression):
    """rint: the nearest integer, ties to even."""
    fn = staticmethod(torch.round)
    np_fn = staticmethod(np.rint)


class _DomainLog(UnaryMathExpression):
    """A logarithm with Spark's non-ANSI domain rule: null unless the
    input is above `floor` (x > 0 for ln, log10 and log2; x > -1 for
    log1p), so a NaN input is null too, as in the reference and its
    oracle; +inf at +inf."""
    floor = 0.0

    def _resolve(self):
        self.dtype = t.DOUBLE
        self.nullable = True

    def _eval_dev(self, ctx, kids):
        x = _f64(kids[0])
        ok = x > self.floor
        safe = torch.where(ok, x, torch.full_like(x, self.floor + 1.0))
        return DevVal(type(self).fn(safe),
                      merge_validity(kids[0].validity, ok), t.DOUBLE)

    def _eval_cpu(self, batch, kids):
        x = _f64_np(kids[0])
        with np.errstate(invalid="ignore"):
            ok = x > self.floor
        out = type(self).np_fn(np.where(ok, x, self.floor + 1.0))
        return H.column(out, H.and_valid(kids[0].validity, ok), t.DOUBLE)


class Log(_DomainLog):
    fn = staticmethod(torch.log)
    np_fn = staticmethod(np.log)


class Log10(_DomainLog):
    fn = staticmethod(torch.log10)
    np_fn = staticmethod(np.log10)


class Log2(_DomainLog):
    fn = staticmethod(torch.log2)
    np_fn = staticmethod(np.log2)


class Log1p(_DomainLog):
    fn = staticmethod(torch.log1p)
    np_fn = staticmethod(np.log1p)
    floor = -1.0


_LONG_HI = 9.223372036854775e18        # the double just below 2^63
_LONG_LO = -9.223372036854776e18       # -2^63


def _f64_to_long(f: torch.Tensor) -> torch.Tensor:
    """Spark's double -> long: NaN -> 0, saturation at the doubles
    nearest Long's bounds, then truncation."""
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return torch.clamp(f, _LONG_LO, _LONG_HI).to(torch.int64)


class RoundingToLong(Expression):
    """floor / ceil -> LONG (Spark's `.toLong` of the rounded double).
    Integral input passes through; a decimal rounds its unscaled lane
    exactly in integers."""
    round_fn = None
    #: the rounding mode of an exact integer quotient
    mode = "floor"

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return _numeric_reasons(self.children)

    def _eval_dev(self, ctx, kids):
        dt = self.children[0].dtype
        x = kids[0].data
        if t.is_integral(dt):
            return DevVal(x.to(torch.int64), kids[0].validity, t.LONG)
        if isinstance(dt, t.DecimalType):
            p = 10 ** dt.scale
            u = x.to(torch.int64)
            q = torch.div(u, p, rounding_mode="floor")
            if self.mode == "ceil":
                q = q + (q * p != u).to(torch.int64)
            return DevVal(q, kids[0].validity, t.LONG)
        f = type(self).round_fn(x.to(torch.float64))
        return DevVal(_f64_to_long(f), kids[0].validity, t.LONG)

    def _eval_cpu(self, batch, kids):
        dt = self.children[0].dtype
        x = kids[0].data
        if t.is_integral(dt) or isinstance(dt, t.NullType):
            return H.column(x.astype(np.int64), kids[0].validity, t.LONG)
        if isinstance(dt, t.DecimalType):
            p = np.int64(10 ** dt.scale)
            u = x.astype(np.int64)
            q = u // p
            if self.mode == "ceil":
                q = q + (q * p != u).astype(np.int64)
            return H.column(q, kids[0].validity, t.LONG)
        f = type(self).np_round(x.astype(np.float64))
        f = np.where(np.isnan(f), 0.0, f)
        return H.column(np.clip(f, _LONG_LO, _LONG_HI).astype(np.int64),
                        kids[0].validity, t.LONG)


class Floor(RoundingToLong):
    round_fn = staticmethod(torch.floor)
    np_round = staticmethod(np.floor)


class Ceil(RoundingToLong):
    round_fn = staticmethod(torch.ceil)
    np_round = staticmethod(np.ceil)
    mode = "ceil"


class _BinaryMath(Expression):
    fn = None

    def __init__(self, left, right):
        self.children = (left, right)

    def _resolve(self):
        self.dtype = t.DOUBLE
        self.nullable = any(c.nullable for c in self.children)

    def unsupported_reasons(self, conf):
        return _numeric_reasons(self.children)

    def _eval_dev(self, ctx, kids):
        return DevVal(type(self).fn(_f64(kids[0]), _f64(kids[1])),
                      merge_validity(kids[0].validity, kids[1].validity),
                      t.DOUBLE)

    def _eval_cpu(self, batch, kids):
        with np.errstate(all="ignore"):
            out = type(self).np_fn(_f64_np(kids[0]), _f64_np(kids[1]))
        return H.column(out, H.and_valid(kids[0].validity,
                                         kids[1].validity), t.DOUBLE)


class Pow(_BinaryMath):
    fn = staticmethod(torch.pow)
    np_fn = staticmethod(np.power)


class Atan2(_BinaryMath):
    """atan2(y, x)."""
    fn = staticmethod(torch.atan2)
    np_fn = staticmethod(np.arctan2)


class Hypot(_BinaryMath):
    fn = staticmethod(torch.hypot)
    np_fn = staticmethod(np.hypot)


# ---------------------------------------------------------------------------
# greatest / least, round / bround, width_bucket, raise_error
# ---------------------------------------------------------------------------

class Greatest(Expression):
    """greatest(...): nulls skipped (null only when every input is), NaN
    the greatest value (Java's order: a NaN never loses to +inf, and
    least returns a number while one is present), -0.0 below 0.0.  The
    type is the first non-NULL child's; operands of another type are
    refused (cast them first).  STRING operands run on the CPU engine,
    as in the reference, ordered by value."""
    lifts_literal_children = True
    _is_greatest = True

    def __init__(self, *items):
        assert len(items) >= 2
        self.children = tuple(items)

    def _resolve(self):
        self.dtype = next((c.dtype for c in self.children
                           if not isinstance(c.dtype, t.NullType)), t.NULL)
        self.nullable = all(c.nullable for c in self.children)

    def unsupported_reasons(self, conf):
        types = [c.dtype for c in self.children
                 if not isinstance(c.dtype, t.NullType)]
        if any(isinstance(d, t.StringType) for d in types):
            # the reference's signatures keep STRING off its device (whose
            # path would compare the codes of unrelated dictionaries): its
            # CPU engine, and the port's, order the strings by value
            return ["input type string not supported",
                    "output type string not supported"]
        if any(d != self.dtype for d in types):
            return [Unported("operands of several types: cast them to "
                             "one")]
        return [WIDE_HOST_REASON for c in self.children
                if consumes_wide_host(c)][:1]

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        dictionary = None
        wide = any(k.hi is not None for k in kids)
        if isinstance(self.dtype, t.StringType):
            dictionary, lanes = _unified_codes(kids)
        elif wide:
            lanes = [k.unscaled() for k in kids]
        else:
            lanes = [_lane(k, self.dtype) for k in kids]
        is_fp = t.is_floating(self.dtype)
        acc_d = lanes[0]
        acc_v = H.valid_of(kids[0].validity, n)
        for k, d in zip(kids[1:], lanes[1:]):
            v = H.valid_of(k.validity, n)
            if is_fp:
                na, nb = np.isnan(acc_d), np.isnan(d)
                sa, sb = np.signbit(acc_d), np.signbit(d)
                zero_tie = ~na & ~nb & (d == acc_d)
                with np.errstate(invalid="ignore"):
                    if self._is_greatest:
                        take_b = (nb & ~na) | (~na & ~nb & (d > acc_d)) | \
                            (zero_tie & sa & ~sb)
                    else:
                        take_b = (na & ~nb) | (~na & ~nb & (d < acc_d)) | \
                            (zero_tie & ~sa & sb)
            else:
                take_b = d > acc_d if self._is_greatest else d < acc_d
            pick_b = v & (~acc_v | take_b)
            acc_d = np.where(pick_b, d, acc_d)
            acc_v = acc_v | v
        if wide:
            return H.wide_column(acc_d, acc_v, self.dtype)
        return H.column(acc_d, acc_v, self.dtype, dictionary)

    def _eval_dev(self, ctx, kids):
        cap, dev = ctx.capacity, ctx.device
        is_fp = t.is_floating(self.dtype)
        acc_d = kids[0].data
        acc_v = valid_or_true(kids[0].validity, cap, dev)
        for k in kids[1:]:
            d = k.data
            v = valid_or_true(k.validity, cap, dev)
            if is_fp:
                na, nb = torch.isnan(acc_d), torch.isnan(d)
                sa, sb = torch.signbit(acc_d), torch.signbit(d)
                zero_tie = ~na & ~nb & (d == acc_d)
                if self._is_greatest:
                    take_b = (nb & ~na) | (~na & ~nb & (d > acc_d)) | \
                        (zero_tie & sa & ~sb)
                else:
                    take_b = (na & ~nb) | (~na & ~nb & (d < acc_d)) | \
                        (zero_tie & ~sa & sb)
            else:
                take_b = d > acc_d if self._is_greatest else d < acc_d
            pick_b = v & (~acc_v | take_b)
            acc_d = torch.where(pick_b, d, acc_d)
            acc_v = acc_v | v
        return DevVal(acc_d, acc_v, self.dtype)


class Least(Greatest):
    _is_greatest = False


def _round_int(d: torch.Tensor, drop: int, half_even: bool) -> torch.Tensor:
    """int64 values rounded to a multiple of 10^drop, as the quotient:
    HALF_UP (or HALF_EVEN) away from zero on the magnitude, computed
    from the truncated quotient and its remainder so Long.MIN_VALUE
    needs no abs."""
    if drop >= 19:
        # every int64 is below 10^19 / 2 in magnitude
        return torch.zeros_like(d)
    p = 10 ** drop
    q = torch.div(d, p, rounding_mode="trunc")
    r2 = torch.abs(d - q * p) * 2
    up = r2 > p if half_even else r2 >= p
    if half_even:
        up = up | ((r2 == p) & (q % 2 != 0))
    step = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    return q + torch.where(up, step, torch.zeros_like(d))


def _round_int_np(d: np.ndarray, drop: int, half_even: bool) -> np.ndarray:
    """`_round_int` on numpy lanes."""
    if drop >= 19:
        return np.zeros_like(d)
    p = np.int64(10 ** drop)
    q = d // p
    q = np.where((d < 0) & (q * p != d), q + 1, q)     # toward zero
    with np.errstate(over="ignore"):
        r2 = np.abs(d - q * p) * 2
    up = r2 > p if half_even else r2 >= p
    if half_even:
        up = up | ((r2 == p) & (q % 2 != 0))
    return q + np.where(up, np.where(d < 0, -1, 1), 0)


class Round(Expression):
    """round(x, scale) HALF_UP (BRound: HALF_EVEN), scale may be negative.
    A decimal rounds its unscaled int64 lane exactly, to decimal(p - s +
    max(scale, 0) + 1, max(scale, 0)) (the +1 holds the carry, 999.99 ->
    1000.0); an integral value rounds to a multiple of 10^-scale (Java's
    `toLong` wrap past Long's range); a DOUBLE rounds in binary, x * 10^s
    rounded then divided by 10^s (a 0-d tensor divisor), as the
    reference does, so a value on a decimal half-way point that binary
    cannot hold (2.675) may round the other way than Spark's BigDecimal;
    NaN and ±inf pass through."""
    _half_even = False

    def __init__(self, child, scale: int = 0):
        self.children = (child,)
        self.scale = scale

    def _fp_extra(self):
        return str(self.scale)

    def _resolve(self):
        dt = self.children[0].dtype
        if isinstance(dt, t.DecimalType):
            if self.scale >= dt.scale:
                self.dtype = dt
            else:
                self.dtype = t.DecimalType(
                    min(38, dt.precision - dt.scale + max(self.scale, 0)
                        + 1), max(self.scale, 0))
        elif t.is_integral(dt):
            self.dtype = dt
        else:
            self.dtype = t.DOUBLE
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        out = _numeric_reasons(self.children)
        if consumes_wide_host(self.children[0]):
            out.append(WIDE_HOST_REASON)
        return out

    def _eval_dev(self, ctx, kids):
        dt = self.children[0].dtype
        x = kids[0].data
        if isinstance(dt, t.DecimalType) or t.is_integral(dt):
            d = x.to(torch.int64)
            drop = (dt.scale if isinstance(dt, t.DecimalType) else 0) - \
                self.scale
            if drop <= 0:
                return DevVal(d.to(compute_dtype(self.dtype)),
                              kids[0].validity, self.dtype)
            q = _round_int(d, drop, self._half_even)
            if self.scale < 0:
                q = q * 10 ** (-self.scale)
            return DevVal(q.to(compute_dtype(self.dtype)), kids[0].validity,
                          self.dtype)
        f = x.to(torch.float64)
        p = 10.0 ** self.scale
        y = f * p
        if self._half_even:
            y = torch.round(y)
        else:
            y = torch.trunc(y + torch.where(f >= 0, 0.5, -0.5))
        # a 0-d tensor divisor: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal (ROADMAP Queue 3 item 1)
        p = host_constant(np.float64(p), y.device)
        return DevVal(y / p, kids[0].validity, t.DOUBLE)

    def _eval_cpu(self, batch, kids):
        dt = self.children[0].dtype
        x = kids[0].data
        if isinstance(dt, t.DecimalType) or t.is_integral(dt):
            d = x.astype(np.int64)
            drop = (dt.scale if isinstance(dt, t.DecimalType) else 0) - \
                self.scale
            if drop <= 0:
                return H.column(d, kids[0].validity, self.dtype)
            q = _round_int_np(d, drop, self._half_even)
            if self.scale < 0:
                with np.errstate(over="ignore"):
                    q = q * np.int64(10 ** (-self.scale))
            return H.column(q, kids[0].validity, self.dtype)
        f = x.astype(np.float64)
        p = 10.0 ** self.scale
        with np.errstate(all="ignore"):
            y = f * p
            y = np.rint(y) if self._half_even else \
                np.trunc(y + np.where(f >= 0, 0.5, -0.5))
            return H.column(y / p, kids[0].validity, t.DOUBLE)


class BRound(Round):
    """bround: HALF_EVEN (banker's rounding)."""
    _half_even = True


class WidthBucket(Expression):
    """width_bucket(v, lo, hi, n): 0 below the range, n + 1 at or past
    its end, else floor((v - lo) / (hi - lo) * n) + 1 (a descending range
    mirrors it).  Null for a null input and, as Spark, for n <= 0 or
    n = Long.MAX_VALUE, lo = hi, a NaN v / lo / hi, or an infinite lo or
    hi.  Every bound is the value as a double (a decimal by its value)."""

    def __init__(self, value, lo, hi, nbuckets):
        self.children = (value, lo, hi, nbuckets)

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = True

    def unsupported_reasons(self, conf):
        out = _numeric_reasons(self.children)
        if not (t.is_integral(self.children[3].dtype) or
                isinstance(self.children[3].dtype, t.NullType)):
            out.append("width_bucket's bucket count must be integral")
        return out

    def _eval_dev(self, ctx, kids):
        v, lo, hi = (_f64(k) for k in kids[:3])
        n = kids[3].data.to(torch.int64)
        asc = lo < hi
        below = torch.where(asc, v < lo, v > lo)
        above = torch.where(asc, v >= hi, v <= hi)
        frac = torch.where(asc, (v - lo) / (hi - lo), (lo - v) / (lo - hi))
        bad = (n <= 0) | (n == 2 ** 63 - 1) | (lo == hi) | torch.isnan(v) | \
            torch.isnan(lo) | torch.isnan(hi) | torch.isinf(lo) | \
            torch.isinf(hi)
        inside = ~(below | above | bad)
        mid = torch.where(inside, frac * n.to(torch.float64),
                          torch.zeros_like(frac)).to(torch.int64) + 1
        out = torch.where(below, torch.zeros_like(n),
                          torch.where(above, n + 1, mid))
        valid = merge_validity(*(k.validity for k in kids))
        return DevVal(out, ~bad if valid is None else valid & ~bad, t.LONG)

    def _eval_cpu(self, batch, kids):
        v, lo, hi = (_f64_np(k) for k in kids[:3])
        n = kids[3].data.astype(np.int64)
        with np.errstate(all="ignore"):
            asc = lo < hi
            below = np.where(asc, v < lo, v > lo)
            above = np.where(asc, v >= hi, v <= hi)
            frac = np.where(asc, (v - lo) / (hi - lo), (lo - v) / (lo - hi))
            bad = (n <= 0) | (n == 2 ** 63 - 1) | (lo == hi) | np.isnan(v) | \
                np.isnan(lo) | np.isnan(hi) | np.isinf(lo) | np.isinf(hi)
            inside = ~(below | above | bad)
            mid = np.where(inside, frac * n.astype(np.float64),
                           0.0).astype(np.int64) + 1
        out = np.where(below, 0, np.where(above, n + 1, mid))
        valid = H.and_valid(*(k.validity for k in kids))
        return H.column(out, H.and_valid(valid, ~bad), t.LONG)


class RaiseError(Expression):
    """raise_error(msg): evaluating it over a batch with a live row raises
    RuntimeError with the message (an expression's message is its first
    row's value, "" when null), as the reference's CPU operator does; a
    batch with no live row yields nulls.  On a card the live-row test is
    one host sync at the operator that evaluates it."""

    def __init__(self, message):
        if isinstance(message, Expression):
            self.children = (message,)
            self.message = None
        else:
            self.children = ()
            self.message = str(message)

    def _resolve(self):
        self.dtype = t.NULL
        self.nullable = True

    def _fp_extra(self):
        return repr(self.message)

    def _eval_dev(self, ctx, kids):
        from ..ops.kernels import live_mask
        if bool(live_mask(ctx.capacity, ctx.num_rows, ctx.device).any()):
            msg = self.message
            if msg is None:
                k = kids[0]
                ok = k.validity is None or bool(k.validity[0])
                if not ok:
                    msg = ""
                elif k.dictionary is not None:
                    msg = str(k.dictionary[int(k.data[0])])
                else:
                    msg = str(k.data[0].item())
            raise RuntimeError(msg)
        return DevVal(ctx.full(0, torch.int32), ctx.full(False, torch.bool),
                      t.NULL)

    def _eval_cpu(self, batch, kids):
        n = batch.num_rows
        if n > 0:
            msg = self.message
            if msg is None:
                v0 = kids[0].to_pylist()[0]
                msg = "" if v0 is None else str(v0)
            raise RuntimeError(msg)
        return HostColumn(np.zeros(0, np.int32), np.zeros(0, bool), t.NULL)


# ---------------------------------------------------------------------------
# Spark's hash() and xxhash64() (ops/hashing.py)
# ---------------------------------------------------------------------------

def _wide_decimal_bytes(v: int) -> bytes:
    """Java's BigInteger.toByteArray: minimal big-endian two's
    complement (what Spark hashes for a DECIMAL wider than 18 digits)."""
    n = (v + (v < 0)).bit_length() // 8 + 1
    return v.to_bytes(n, "big", signed=True)


class _SparkHash(Expression):
    """A hash folded across its children from the seed 42, each child's
    hash the seed of the next, nulls passing the running value through
    (ops/hashing.py has the per-type rules).  A STRING child hashes per
    dictionary entry on the host: as the first child every row gathers
    its entry's hash, behind another child each row folds its entry's
    tabled words under its own running seed."""

    #: XXH64 (LONG result) rather than murmur3 (INT)
    _xx = False

    def __init__(self, *items):
        assert items
        self.children = tuple(items)

    def _resolve(self):
        self.dtype = t.LONG if self._xx else t.INT
        self.nullable = False

    def unsupported_reasons(self, conf):
        from ..ops.hashing import hash_width
        name = "xxhash64" if self._xx else "hash"
        out = []
        for c in self.children:
            dt = c.dtype
            if isinstance(dt, t.DecimalType) and dt.is_wide:
                out.append(f"{name} over decimal(>18)")
            elif not isinstance(dt, (t.StringType, t.NullType)) and \
                    hash_width(dt) is None:
                out.append(f"{name} over {dt.simple_string}")
        return out

    def _string_tables(self, d: np.ndarray, first: bool, device):
        """The first child's per-entry hash table, or the word tables of
        a chained one, on `device` (None: numpy), kept per dictionary."""
        from ..ops import hashing as HS
        key = f"_hash_{'first' if first else 'chain'}_{device}"

        def make():
            tab = HS.first_string_table(d, self._xx) if first \
                else HS.StringTables(d)
            if device is None:
                return tab
            return host_constant(tab, device) if first \
                else tab.to(device)
        return per_dictionary(self, key).get(d, make)

    def _fold(self, h, data, validity, dt, dictionary, first, device):
        from ..ops import hashing as HS
        if isinstance(dt, t.NullType):
            return h
        if isinstance(dt, t.StringType):
            d = dict_or_empty(dictionary)
            codes = HS.clip_codes(data, len(d))
            tabs = self._string_tables(d, first, device)
            if first:
                lane = tabs[codes]
            elif self._xx:
                lane = HS.xxhash64_strings(codes, h, tabs)
            else:
                lane = HS.murmur3_strings(codes, h, tabs)
            return lane if validity is None else HS.where(validity, lane, h)
        if self._xx:
            return HS.xxhash64_column(data, validity, dt, h)
        return HS.hash_column(data, validity, dt, h)

    def _eval_dev(self, ctx, kids):
        h = ctx.full(42, torch.int64)
        for i, (k, c) in enumerate(zip(kids, self.children)):
            h = self._fold(h, k.data, k.validity, c.dtype, k.dictionary,
                           i == 0, ctx.device)
        return DevVal(h if self._xx else h.to(torch.int32), None,
                      self.dtype)

    def _wide_fold(self, h: np.ndarray, k: HostColumn) -> np.ndarray:
        from ..ops import hashing as HS
        out = h.copy()
        valid = k.valid_mask()
        for i, v in enumerate(k.unscaled()):
            if valid[i]:
                seed = int(h[i])
                b = _wide_decimal_bytes(int(v))
                out[i] = HS.signed64(np.array(
                    [HS.xxhash64_bytes_host(b, seed)], np.uint64))[0] \
                    if self._xx else HS.murmur3_bytes(b, seed)
        return out

    def _eval_cpu(self, batch, kids):
        h = np.full(batch.num_rows, 42, np.int64)
        for i, (k, c) in enumerate(zip(kids, self.children)):
            if isinstance(c.dtype, t.DecimalType) and c.dtype.is_wide:
                h = self._wide_fold(h, k)
                continue
            h = self._fold(h, k.data, k.validity, c.dtype, k.dictionary,
                           i == 0, None)
        return H.column(h if self._xx else h.astype(np.int32), None,
                        self.dtype)


class Murmur3Hash(_SparkHash):
    """hash(...): Spark's Murmur3_x86_32 with seed 42, an INT."""


class XxHash64(_SparkHash):
    """xxhash64(...): Spark's XXH64 with seed 42, a LONG."""
    _xx = True
