"""ARRAY expressions (collectionOperations.scala, complexTypeCreator,
higherOrderFunctions.scala).

Counterpart of the ARRAY half of spark_rapids_tpu/plan/collections.py.
An ARRAY value is ragged on both engines (columnar/device.DeviceColumn,
columnar/host.HostColumn): a flat values lane, a validity per value and
int32 offsets of rows + 1.  The classes the reference runs on its
device keep their device forms over ops/ragged.py (`_eval_dev`) where
the input qualifies as the reference's `_ragged_child_ok` says (a column
reference or a device higher-order result, over an integral, FLOAT,
BOOLEAN or DATE element); anything else tags itself onto the CPU engine
with the reference's reason.  The CPU forms (`_eval_cpu`) run on numpy
over the same layout: the reference's are pyarrow, so they are
rewritten, not copied; the classes the reference runs only on its CPU
engine (`_CpuArrayExpression`) take Python lists a row, as its own do.

The STRUCT and MAP classes close the module: the field and map
accesses that plan/structs.py rewrites into lanes, the re-nesting
expressions, and the CPU engine's map functions, on numpy over
columnar/host.py's nested layout.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from .. import types as t
from ..columnar.host import (HostBatch, HostColumn, list_column,
                             list_from_pylists, map_column,
                             map_from_pyvalues, struct_column, struct_field)
from ..ops import host as H
from .expressions import DevVal, EvalCtx, Expression, HostVal, PrepCtx

_OFF_DEVICE = "ARRAY values live on the CPU path (device lanes are flat)"


def _device_elem_ok(dt: t.DataType) -> bool:
    """Element types the ragged device kernels handle (ops/ragged.py):
    one integer-comparable lane.  DOUBLE, wide decimals, strings and
    nested elements stay on the CPU path (the reference's)."""
    return isinstance(dt, (t.ByteType, t.ShortType, t.IntegerType,
                           t.LongType, t.FloatType, t.BooleanType,
                           t.DateType))


def _ragged_child_ok(e: Expression) -> bool:
    """The array input has a ragged DEVICE form: a column reference or a
    device-eligible higher-order result, over a device element type."""
    from .expressions import ColumnRef
    if not isinstance(e.dtype, t.ArrayType) or \
            not _device_elem_ok(e.dtype.element_type):
        return False
    if isinstance(e, ColumnRef):
        return True
    return isinstance(e, (ArrayFilter, ArrayTransform, SortArray)) and \
        not e.unsupported_reasons(None)


def _as_ragged_col(dv: DevVal):
    """A ragged DevVal as the DeviceColumn ops/ragged.py takes."""
    from ..columnar.device import DeviceColumn
    validity = dv.validity
    if validity is None:
        validity = torch.ones(dv.offsets.shape[0] - 1, dtype=torch.bool,
                              device=dv.offsets.device)
    return DeviceColumn(dv.data, validity, dv.dtype, dv.dictionary, None,
                        None, dv.offsets, dv.elem_valid)


def _ragged_val(col, dtype: t.DataType, validity=None) -> DevVal:
    """A ragged DeviceColumn (ops/ragged.py's result) as a DevVal."""
    return DevVal(col.data, col.validity if validity is None else validity,
                  dtype, col.dictionary, offsets=col.offsets,
                  elem_valid=col.elem_valid)


def _dev_needle(col, value):
    """A Python literal as a value of the column's values lane."""
    if col.data.dtype == torch.bool:
        return bool(value)
    if col.data.dtype.is_floating_point:
        return float(np.float32(value)) \
            if col.data.dtype == torch.float32 else float(value)
    return int(value)


# ---------------------------------------------------------------------------
# the CPU engine's ragged helpers (numpy)
# ---------------------------------------------------------------------------

def _row_ids(col: HostColumn) -> np.ndarray:
    """The owning row of each value."""
    return np.repeat(np.arange(len(col), dtype=np.int64),
                     np.diff(col.offsets))


def _elem_valid(col: HostColumn) -> np.ndarray:
    return np.ones(len(col.data), bool) if col.elem_valid is None \
        else col.elem_valid


def _seg_any(mask: np.ndarray, rid: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(rid[mask], minlength=n)[:n] > 0


def _elem_order(col: HostColumn) -> np.ndarray:
    """int64 lane ordering the values as Spark orders them."""
    return H.order_lane(col.elements())


def _valid_rows(col: HostColumn) -> np.ndarray:
    return H.valid_of(col.validity, len(col))


def _with_values(col: HostColumn, order: np.ndarray, offsets=None,
                 dtype: Optional[t.DataType] = None) -> HostColumn:
    """The column with its values lane permuted (and new offsets)."""
    ev = None if col.elem_valid is None else col.elem_valid[order]
    return HostColumn(col.data[order], col.validity, dtype or col.dtype,
                      col.dictionary, None,
                      col.offsets if offsets is None
                      else np.asarray(offsets, np.int32), ev)


def _keep_values(col: HostColumn, keep: np.ndarray) -> HostColumn:
    """Each row's values where `keep` holds, in order."""
    rid = _row_ids(col)
    counts = np.bincount(rid[keep], minlength=len(col))[:len(col)]
    off = np.zeros(len(col) + 1, np.int64)
    off[1:] = np.cumsum(counts)
    return _with_values(col, np.flatnonzero(keep), off)


def _scalar_column(values, dtype: t.DataType) -> HostColumn:
    """A column of Python values (None = null)."""
    from ..columnar.host import from_pydict
    return from_pydict({"v": list(values)},
                       t.StructType([t.StructField("v", dtype)])).columns[0]


class ArrayExpression(Expression):
    """Base: the CPU engine's unless a subclass has a ragged device form
    (ops/ragged.py) and its input qualifies (`_ragged_child_ok`)."""

    def unsupported_reasons(self, conf):
        return [_OFF_DEVICE]

    def _prepare(self, pctx: PrepCtx, kids: List[HostVal]) -> HostVal:
        # an ARRAY<STRING> result keeps its input's dictionary
        elem = self.dtype.element_type \
            if isinstance(self.dtype, t.ArrayType) else self.dtype
        if kids and isinstance(elem, t.StringType):
            return HostVal(kids[0].dictionary)
        return HostVal()

    def _eval_dev(self, ctx, kids):    # pragma: no cover - tags prevent it
        raise NotImplementedError(_OFF_DEVICE)


class CreateArray(ArrayExpression):
    """array(e1, e2, ...) — Spark CreateArray (the reference registers
    no device rule for it)."""
    has_rule = False

    def __init__(self, *items: Expression):
        self.children = tuple(items)

    def _resolve(self):
        et = self.children[0].dtype if self.children else t.NULL
        self.dtype = t.ArrayType(et)
        self.nullable = False

    def _eval_cpu(self, batch, kids):
        n, k = batch.num_rows, len(kids)
        et = self.dtype.element_type
        if not k:
            return list_column(_scalar_column([], et),
                               np.zeros(n + 1, np.int64))
        from ..columnar.host import concat_columns
        flat = concat_columns([H.column(c.data, c.validity, et, c.dictionary)
                               if c.offsets is None and c.dtype != et else c
                               for c in kids])
        # row i's item j sits at j * n + i of the stacked children
        idx = (np.arange(k)[None, :] * n + np.arange(n)[:, None]).ravel()
        return list_column(H.take(flat, idx), np.arange(n + 1) * k)


class Size(ArrayExpression):
    """size(array): a null array gives null (the modern default,
    spark.sql.legacy.sizeOfNull=false)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = True

    def unsupported_reasons(self, conf):
        return [] if _ragged_child_ok(self.children[0]) else [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        data, valid = R.sizes(_as_ragged_col(kids[0]))
        return DevVal(data, valid, t.INT)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        return H.column(np.diff(c.offsets).astype(np.int32), c.validity,
                        t.INT)


def _item_cpu(c: HostColumn, pos: np.ndarray, ok: np.ndarray,
              dtype: t.DataType) -> HostColumn:
    """Element `pos` (within each row) where `ok`, else null."""
    idx = np.where(ok, c.offsets[:-1].astype(np.int64) + pos, -1)
    return H.take(c.elements(), idx)


class GetArrayItem(ArrayExpression):
    """array[idx] (0-based, Spark GetArrayItem): out of range gives null."""

    def __init__(self, child: Expression, index: int):
        self.children = (child,)
        self.index = index

    def _resolve(self):
        self.dtype = self.children[0].dtype.element_type
        self.nullable = True

    def _fp_extra(self):
        return str(self.index)

    def unsupported_reasons(self, conf):
        return [] if _ragged_child_ok(self.children[0]) else [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        data, valid = R.get_item(_as_ragged_col(kids[0]), self.index)
        return DevVal(data, valid, self.dtype, kids[0].dictionary)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        lens = np.diff(c.offsets)
        ok = _valid_rows(c) & (self.index >= 0) & (self.index < lens)
        return _item_cpu(c, np.full(len(c), self.index), ok, self.dtype)


class ArrayContains(ArrayExpression):
    """array_contains(arr, value), Spark's null semantics: a null array
    gives null; no match with a null element gives null; else false."""

    def __init__(self, child: Expression, value):
        self.children = (child,)
        self.value = value

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = True

    def _fp_extra(self):
        return repr(self.value)

    def unsupported_reasons(self, conf):
        if _ragged_child_ok(self.children[0]) and \
                isinstance(self.value, (int, float, bool)):
            return []
        return [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        col = _as_ragged_col(kids[0])
        data, valid = R.contains(col, _dev_needle(col, self.value),
                                 ctx.num_rows)
        return DevVal(data, valid, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        n = len(c)
        rid = _row_ids(c)
        ev = _elem_valid(c)
        hit = ev & _equals_value(c, self.value)
        has_hit = _seg_any(hit, rid, n)
        has_null = _seg_any(~ev, rid, n)
        return H.column(has_hit, H.and_valid(c.validity,
                                             has_hit | ~has_null),
                        t.BOOLEAN)


def _equals_value(c: HostColumn, value) -> np.ndarray:
    """Per value: equal to the Python literal `value` (a string by its
    entry in the dictionary)."""
    if value is None:
        return np.zeros(len(c.data), bool)
    et = c.dtype.element_type
    if isinstance(et, t.StringType):
        d = c.dictionary if c.dictionary is not None else np.array([], str)
        hits = np.flatnonzero(d == str(value))
        return np.isin(c.data, hits) if len(hits) else \
            np.zeros(len(c.data), bool)
    if isinstance(et, t.DateType) and not isinstance(value, (int, float)):
        import datetime as pydt
        value = (value - pydt.date(1970, 1, 1)).days
    return c.data == value


class SortArray(ArrayExpression):
    """sort_array(arr, asc): nulls first ascending, last descending
    (Spark)."""

    def __init__(self, child: Expression, ascending: bool = True):
        self.children = (child,)
        self.ascending = ascending

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _fp_extra(self):
        return str(self.ascending)

    def unsupported_reasons(self, conf):
        return [] if _ragged_child_ok(self.children[0]) else [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        out = R.sort_within(_as_ragged_col(kids[0]), ctx.num_rows,
                            self.ascending)
        return _ragged_val(out, self.dtype, kids[0].validity)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        rid = _row_ids(c)
        ev = _elem_valid(c)
        lane = _elem_order(c)
        if not self.ascending:
            lane = ~lane
        lane = np.where(ev, lane, 0)
        nulls = (ev if self.ascending else ~ev).astype(np.int8)
        order = np.lexsort((lane, nulls, rid))
        return _with_values(c, order)


class ArrayMin(ArrayExpression):
    """array_min: the least non-null element (NaN greatest), null for an
    empty or all-null array."""
    _is_min = True

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype.element_type
        self.nullable = True

    def unsupported_reasons(self, conf):
        if _ragged_child_ok(self.children[0]) and not \
                isinstance(self.dtype, t.BooleanType):
            return []
        return [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        col = _as_ragged_col(kids[0])
        fn = R.array_min if self._is_min else R.array_max
        data, valid = fn(col, ctx.num_rows)
        return DevVal(data, valid, self.dtype, kids[0].dictionary)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        n = len(c)
        rid = _row_ids(c)
        ev = _elem_valid(c)
        lane = _elem_order(c)
        # the first value of each row in (row, value) order
        order = np.lexsort((lane if self._is_min else ~lane, rid))
        order = order[ev[order]]
        pick = np.full(n, -1, np.int64)
        first = np.ones(len(order), bool)
        first[1:] = rid[order][1:] != rid[order][:-1]
        pick[rid[order][first]] = order[first]
        pick = np.where(_valid_rows(c), pick, -1)
        return H.take(c.elements(), pick)


class ArrayMax(ArrayMin):
    """array_max: the greatest non-null element (NaN greatest)."""
    _is_min = False


class ExplodeGen:
    """explode(col) / posexplode(col) (+ outer): the generator of a
    LogicalGenerate (the reference's GpuGenerateExec generators)."""

    def __init__(self, child: Expression, pos: bool = False,
                 outer: bool = False):
        self.child = child
        self.pos = pos
        self.outer = outer

    def bind(self, schema):
        b = copy.copy(self)
        b.child = self.child.bind(schema)
        if not isinstance(b.child.dtype, t.ArrayType):
            raise TypeError(
                f"explode requires an array input, got "
                f"{b.child.dtype.simple_string}")
        return b

    def output_fields(self) -> List[t.StructField]:
        et = self.child.dtype.element_type
        fields = []
        if self.pos:
            # an outer row of a null or empty array has a null pos
            fields.append(t.StructField("pos", t.INT, self.outer))
        fields.append(t.StructField("col", et, True))
        return fields

    def __repr__(self):
        name = "posexplode" if self.pos else "explode"
        return f"{name}{'_outer' if self.outer else ''}({self.child!r})"


# ---------------------------------------------------------------------------
# Higher-order functions (transform / filter / exists / forall): the body
# runs once over every row's elements as one batch (the reference's
# bound-lambda batching), then the results go back to their rows
# ---------------------------------------------------------------------------

class LambdaVar(Expression):
    """The lambda's element variable inside a higher-order body, bound
    against the one-column schema its parent makes."""

    def __init__(self, name: str = "x"):
        self.children = ()
        self.name = name

    def bind(self, schema):
        b = copy.copy(self)
        f = schema[self.name]
        b.dtype = f.data_type
        b.nullable = f.nullable
        return b

    def _fp_extra(self):
        return self.name

    def _prepare(self, pctx, kids):
        return HostVal(pctx.dicts.get(self.name))

    def _eval_dev(self, ctx, kids):
        return ctx.inputs[self.name]

    def _eval_cpu(self, batch, kids):
        return batch.column_by_name(self.name)


class _HigherOrder(ArrayExpression):
    """Base: the body over the flat values of every row at once.  Column
    references of the outer row inside the body are not supported on the
    device (tagged)."""

    def __init__(self, arr: Expression, body: Expression, var: str = "x"):
        self.children = (arr,)
        self.body = body
        self.var = var

    def bind(self, schema):
        b = copy.copy(self)
        b.children = tuple(c.bind(schema) for c in self.children)
        elem = b.children[0].dtype.element_type
        b.body = b.body.bind(t.StructType([t.StructField(b.var, elem,
                                                         True)]))
        b._resolve()
        return b

    def _fp_extra(self):
        return f"{self.var};{self.body.fingerprint()}"

    def unsupported_reasons(self, conf):
        if _ragged_child_ok(self.children[0]) and \
                self._body_device_ok(conf):
            return []
        return [_OFF_DEVICE]

    def _body_device_ok(self, conf) -> bool:
        """An elementwise body over the lambda variable only: every leaf a
        LambdaVar or a Literal, every node with a device form."""
        from .expressions import ColumnRef

        def walk(e) -> bool:
            if isinstance(e, ColumnRef) or e.unsupported_reasons(conf):
                return False
            return all(walk(c) for c in e.children)
        return walk(self.body)

    def _prepare(self, pctx, kids):
        self.body.prepare(PrepCtx(pctx.conf, {self.var: kids[0].dictionary},
                                  pctx.device))
        return ArrayExpression._prepare(self, pctx, kids)

    def _lambda_eval(self, ctx, kids):
        """(the input as a ragged column, the body over its values)."""
        from ..ops import ragged as R
        col = _as_ragged_col(kids[0])
        n_vals = R._at(col.offsets, ctx.num_rows)
        elem = DevVal(col.data, col.elem_valid,
                      self.children[0].dtype.element_type, col.dictionary)
        ectx = EvalCtx(col.value_capacity, n_vals, {self.var: elem},
                       ctx.conf, ctx.device)
        return col, self.body.eval_dev(ectx)

    def _flat_eval(self, kids) -> HostColumn:
        """The body over the input's flat values."""
        c = kids[0]
        out = self.body.eval_cpu(HostBatch([c.elements()], [self.var]))
        if len(out) != len(c.data):      # a literal body
            out = H.take(out, np.zeros(len(c.data), np.int64))
        return out


class ArrayTransform(_HigherOrder):
    """transform(arr, x -> body)."""

    def _resolve(self):
        self.dtype = t.ArrayType(self.body.dtype)
        self.nullable = self.children[0].nullable

    def _eval_dev(self, ctx, kids):
        from ..ops.kernels import storage_view
        col, body = self._lambda_eval(ctx, kids)
        ev = body.validity if body.validity is not None \
            else torch.ones(col.value_capacity, dtype=torch.bool,
                            device=col.data.device)
        return DevVal(storage_view(body.data, self.body.dtype),
                      kids[0].validity, self.dtype, body.dictionary,
                      offsets=col.offsets, elem_valid=ev)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        out = self._flat_eval(kids)
        return HostColumn(out.data, c.validity, self.dtype, out.dictionary,
                          None, c.offsets,
                          None if out.validity is None else out.validity)


class ArrayFilter(_HigherOrder):
    """filter(arr, x -> predicate); a null predicate drops the value."""

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        col, body = self._lambda_eval(ctx, kids)
        keep = body.data.to(torch.bool)
        if body.validity is not None:
            keep = keep & body.validity
        out = R.filter_values(col, keep, ctx.num_rows)
        return _ragged_val(out, self.dtype, kids[0].validity)

    def _eval_cpu(self, batch, kids):
        out = self._flat_eval(kids)
        keep = out.data.astype(bool) & H.valid_of(out.validity,
                                                 len(out.data))
        return _keep_values(kids[0], keep)


class ArrayExists(_HigherOrder):
    """exists(arr, x -> predicate), three-valued: true if any is true;
    else null if any is null; else false."""
    _default = False
    _hit = True

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = True

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        col, body = self._lambda_eval(ctx, kids)
        vcap, cap = col.value_capacity, col.capacity
        rid = R.row_ids(col.offsets, vcap)
        live = R.value_live(col.offsets, vcap, ctx.num_rows)
        pred = body.data.to(torch.bool)
        pvalid = body.validity if body.validity is not None \
            else torch.ones(vcap, dtype=torch.bool, device=pred.device)
        hit = R._seg_any((pred == self._hit) & pvalid & live, rid, cap)
        any_null = R._seg_any(~pvalid & live, rid, cap)
        data = hit if self._hit else ~hit
        return DevVal(data, col.validity & (hit | ~any_null), t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        n = len(c)
        out = self._flat_eval(kids)
        rid = _row_ids(c)
        pvalid = H.valid_of(out.validity, len(out.data))
        pred = out.data.astype(bool)
        hit = _seg_any((pred == self._hit) & pvalid, rid, n)
        any_null = _seg_any(~pvalid, rid, n)
        return H.column(hit if self._hit else ~hit,
                        H.and_valid(c.validity, hit | ~any_null), t.BOOLEAN)


class ArrayForAll(ArrayExists):
    """forall(arr, x -> predicate): false if any is false; else null if
    any is null; else true."""
    _default = True
    _hit = False


class ElementAt(ArrayExpression):
    """element_at(arr, i): 1-based, a negative index from the end; out of
    range gives null (Spark ElementAt over arrays)."""

    def __init__(self, child: Expression, index: int):
        self.children = (child,)
        self.index = int(index)

    def _resolve(self):
        self.dtype = self.children[0].dtype.element_type
        self.nullable = True

    def _fp_extra(self):
        return str(self.index)

    def unsupported_reasons(self, conf):
        if self.index == 0:
            return ["element_at index 0 (Spark raises; 1-based)"]
        return [] if _ragged_child_ok(self.children[0]) else [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        data, valid = R.element_at(_as_ragged_col(kids[0]), self.index)
        return DevVal(data, valid, self.dtype, kids[0].dictionary)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        lens = np.diff(c.offsets).astype(np.int64)
        if self.index > 0:
            pos = np.full(len(c), self.index - 1)
            ok = pos < lens
        else:
            pos = lens + self.index
            ok = pos >= 0
        return _item_cpu(c, pos, ok & _valid_rows(c), self.dtype)


class ArrayPosition(ArrayExpression):
    """array_position(arr, v): the 1-based first match, 0 when absent,
    null for a null array."""

    def __init__(self, child: Expression, value):
        self.children = (child,)
        self.value = value

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = True

    def _fp_extra(self):
        return repr(self.value)

    def unsupported_reasons(self, conf):
        if _ragged_child_ok(self.children[0]) and \
                isinstance(self.value, (int, float, bool)):
            return []
        return [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        col = _as_ragged_col(kids[0])
        data, valid = R.position(col, _dev_needle(col, self.value),
                                 ctx.num_rows)
        return DevVal(data, valid, t.LONG)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        n = len(c)
        rid = _row_ids(c)
        hit = _elem_valid(c) & _equals_value(c, self.value)
        within = np.arange(len(c.data)) - c.offsets[:-1][rid]
        first = np.full(n, -1, np.int64)
        idx = np.flatnonzero(hit)[::-1]          # the first hit wins
        first[rid[idx]] = within[idx]
        return H.column(first + 1, c.validity, t.LONG)


class Slice(ArrayExpression):
    """slice(arr, start, length): 1-based start, negative from the end."""

    def __init__(self, child: Expression, start: int, length: int):
        self.children = (child,)
        self.start = int(start)
        self.length = int(length)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _fp_extra(self):
        return f"{self.start},{self.length}"

    def unsupported_reasons(self, conf):
        out = []
        if self.start == 0:
            out.append("slice start 0 (Spark raises; 1-based)")
        if self.length < 0:
            out.append("negative slice length (Spark raises)")
        if out:
            return out
        return [] if _ragged_child_ok(self.children[0]) else [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        out = R.slice_rows(_as_ragged_col(kids[0]), self.start,
                           self.length, ctx.num_rows)
        return _ragged_val(out, self.dtype, kids[0].validity)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        rid = _row_ids(c)
        lens = np.diff(c.offsets).astype(np.int64)
        within = np.arange(len(c.data)) - c.offsets[:-1][rid]
        if self.start > 0:
            lo = np.full(len(c), self.start - 1)
            oob = np.zeros(len(c), bool)
        else:
            lo = lens + self.start
            oob = lo < 0          # a start before the array: empty
            lo = np.maximum(lo, 0)
        keep = (within >= lo[rid]) & (within < lo[rid] + self.length) & \
            ~oob[rid]
        return _keep_values(c, keep)


class ReverseArray(ArrayExpression):
    """reverse(arr): each row's elements reversed."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return [] if _ragged_child_ok(self.children[0]) else [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        out = R.reverse_rows(_as_ragged_col(kids[0]), ctx.num_rows)
        return _ragged_val(out, self.dtype, kids[0].validity)

    def _eval_cpu(self, batch, kids):
        c = kids[0]
        rid = _row_ids(c)
        off = c.offsets.astype(np.int64)
        within = np.arange(len(c.data)) - off[:-1][rid]
        src = off[:-1][rid] + (off[1:] - off[:-1])[rid] - 1 - within
        return _with_values(c, src)


# ---------------------------------------------------------------------------
# The classes the reference runs only on its CPU engine: Python lists a row
# ---------------------------------------------------------------------------

class _CpuArrayExpression(ArrayExpression):
    """Base of the CPU-only collection functions: tagged off the device
    with the standard reason; subclasses give `_rows` (Python values a
    row in, a Python value out)."""

    def unsupported_reasons(self, conf):
        return [_OFF_DEVICE]

    def _eval_cpu(self, batch, kids):
        cols = [k.to_pylist() for k in kids]
        out = [self._row(*vals) for vals in zip(*cols)]
        if isinstance(self.dtype, t.ArrayType):
            return list_from_pylists(out, self.dtype.element_type)
        return _scalar_column(out, self.dtype)


def _dedup(seq) -> list:
    """First occurrences in order, one null at most (Spark's set
    functions)."""
    seen, out, has_null = set(), [], False
    for x in seq:
        if x is None:
            if not has_null:
                has_null = True
                out.append(None)
        elif x not in seen:
            seen.add(x)
            out.append(x)
    return out


class ArrayRepeat(_CpuArrayExpression):
    """array_repeat(e, n)."""

    def __init__(self, child: Expression, count: Expression):
        self.children = (child, count)

    def _resolve(self):
        self.dtype = t.ArrayType(self.children[0].dtype)
        self.nullable = self.children[1].nullable

    def _row(self, v, n):
        return None if n is None else [v] * max(int(n), 0)


class Flatten(_CpuArrayExpression):
    """flatten(array<array<T>>) -> array<T>; a null inner array gives a
    null result."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype.element_type
        self.nullable = True

    def _row(self, v):
        if v is None or any(x is None for x in v):
            return None
        return [e for sub in v for e in sub]


class ArrayDistinct(_CpuArrayExpression):
    """array_distinct: first-occurrence order (Spark)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _row(self, v):
        return None if v is None else _dedup(v)


class ArraysOverlap(_CpuArrayExpression):
    """arrays_overlap(a, b): true if a non-null element is common; else
    null when either side holds a null and neither is empty."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = True

    def _row(self, a, b):
        if a is None or b is None:
            return None
        if {x for x in a if x is not None} & {x for x in b if x is not None}:
            return True
        if not a or not b:
            return False
        if any(x is None for x in a) or any(x is None for x in b):
            return None
        return False


class _ArraySetOp(_CpuArrayExpression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = any(c.nullable for c in self.children)

    def _row(self, a, b):
        return None if a is None or b is None else self._combine(a, b)


class ArrayUnion(_ArraySetOp):
    def _combine(self, a, b):
        return _dedup(list(a) + list(b))


class ArrayIntersect(_ArraySetOp):
    def _combine(self, a, b):
        bs = {x for x in b if x is not None}
        bnull = any(x is None for x in b)
        return _dedup([x for x in a if (x is None and bnull) or x in bs])


class ArrayExcept(_ArraySetOp):
    def _combine(self, a, b):
        bs = {x for x in b if x is not None}
        bnull = any(x is None for x in b)
        return _dedup([x for x in a
                       if not ((x is None and bnull) or x in bs)])


class ArrayRemove(_CpuArrayExpression):
    """array_remove(arr, v): the elements equal to v dropped (nulls
    kept)."""

    def __init__(self, child: Expression, value):
        self.children = (child,)
        self.value = value

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _fp_extra(self):
        return repr(self.value)

    def _row(self, v):
        return None if v is None else [x for x in v if x != self.value]


class ArrayJoin(_CpuArrayExpression):
    """array_join(arr, delimiter[, null_replacement])."""

    def __init__(self, child: Expression, delimiter: str,
                 null_replacement: Optional[str] = None):
        self.children = (child,)
        self.delimiter = delimiter
        self.null_replacement = null_replacement

    def _resolve(self):
        self.dtype = t.STRING
        self.nullable = True

    def _fp_extra(self):
        return f"{self.delimiter};{self.null_replacement}"

    def _row(self, v):
        if v is None:
            return None
        parts = [str(x) if x is not None else self.null_replacement
                 for x in v]
        return self.delimiter.join(p for p in parts if p is not None)


class Sequence(_CpuArrayExpression):
    """sequence(start, stop[, step]) over integral inputs (Spark)."""

    def __init__(self, start: Expression, stop: Expression,
                 step: Optional[Expression] = None):
        self.children = (start, stop) if step is None \
            else (start, stop, step)

    def _resolve(self):
        self.dtype = t.ArrayType(self.children[0].dtype)
        self.nullable = True

    def unsupported_reasons(self, conf):
        for c in self.children:
            if not t.is_integral(c.dtype):
                return [f"sequence over {c.dtype.simple_string}"]
        return [_OFF_DEVICE]

    def _row(self, a, b, st=None):
        if a is None or b is None:
            return None
        if st is None:
            st = 1 if b >= a else -1
        if st == 0:
            return None
        return list(range(int(a), int(b) + (1 if st > 0 else -1), int(st)))


# ---------------------------------------------------------------------------
# STRUCT and MAP expressions (complexTypeExtractors.scala,
# complexTypeCreator.scala, the map family of collectionOperations.scala)
#
# A STRUCT or MAP value has no device lane: plan/structs.py shatters an
# eligible scan column into flat lanes (a struct) or two ragged lanes
# over shared offsets (a map) and rewrites these expressions into lane
# references, `Size` of the keys lane and `ShatteredMapElementAt`, so the
# device sees only flat and ragged columns.  What survives the shatter
# (an unshatterable input, a computed struct) runs on the CPU engine over
# the host layout of columnar/host.py: the reference registers no device
# rule for these classes (`has_rule = False`).
# ---------------------------------------------------------------------------

def _map_part(col: HostColumn, i: int) -> HostColumn:
    """A MAP column's keys (i = 0) or values (i = 1) as an ARRAY column
    over the map's offsets (a null map is a null array)."""
    part = col.elements().data[i]
    return list_column(part, col.offsets, col.validity)


def _last_hits(keys: HostColumn, key) -> np.ndarray:
    """Per row of a keys ARRAY column: the values-lane position of the
    LAST key equal to `key` (Spark keeps the last of duplicate keys, as
    ops/ragged.map_element_at does), -1 where none is."""
    hit = _equals_value(keys, key) & _elem_valid(keys)
    best = np.full(len(keys), -1, np.int64)
    pos = np.flatnonzero(hit)
    np.maximum.at(best, _row_ids(keys)[pos], pos)
    return best


class GetStructField(ArrayExpression):
    """s.field — Spark GetStructField: a null struct gives a null field."""
    has_rule = False

    def __init__(self, child: Expression, field: str):
        self.children = (child,)
        self.field = field

    def _resolve(self):
        st = self.children[0].dtype
        if not isinstance(st, t.StructType):
            raise TypeError(f"getField over {st.simple_string}")
        self.dtype = st.fields[st.field_index(self.field)].data_type
        self.nullable = True

    def _fp_extra(self):
        return self.field

    def _eval_cpu(self, batch, kids):
        return struct_field(kids[0], self.field)


class CreateNamedStruct(ArrayExpression):
    """named_struct(...) / struct(...), also the re-nesting expression of
    plan/structs.py: `valid` (when given) is a BOOLEAN expression giving
    the struct's own validity (null or false: a null struct)."""
    has_rule = False

    def __init__(self, names, exprs, valid: Optional[Expression] = None):
        self.names = list(names)
        self.children = tuple(exprs) + ((valid,) if valid is not None
                                        else ())
        self.has_valid = valid is not None

    def _resolve(self):
        n = len(self.names)
        self.dtype = t.StructType([t.StructField(nm, e.dtype, True)
                                   for nm, e in zip(self.names,
                                                    self.children[:n])])
        self.nullable = self.has_valid

    def _fp_extra(self):
        return ",".join(self.names) + f"|{self.has_valid}"

    def _eval_cpu(self, batch, kids):
        n = len(self.names)
        valid = None
        if self.has_valid:
            v = kids[n]
            valid = v.data.astype(bool) & H.valid_of(v.validity, len(v))
        return struct_column(kids[:n], self.names, valid, batch.num_rows)


class MapKeys(ArrayExpression):
    """map_keys(m): ARRAY<K> in entry order."""
    has_rule = False

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.ArrayType(self.children[0].dtype.key_type)
        self.nullable = True

    def _eval_cpu(self, batch, kids):
        return _map_part(kids[0], 0)


class MapValues(ArrayExpression):
    """map_values(m): ARRAY<V> in entry order."""
    has_rule = False

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.ArrayType(self.children[0].dtype.value_type)
        self.nullable = True

    def _eval_cpu(self, batch, kids):
        return _map_part(kids[0], 1)


class MapElementAt(ArrayExpression):
    """element_at(map, key): a missing key gives null (non-ANSI Spark)."""
    has_rule = False

    def __init__(self, child: Expression, key):
        self.children = (child,)
        self.key = key

    def _resolve(self):
        self.dtype = self.children[0].dtype.value_type
        self.nullable = True

    def _fp_extra(self):
        return repr(self.key)

    def _eval_cpu(self, batch, kids):
        m = kids[0]
        best = _last_hits(_map_part(m, 0), self.key)
        return H.take(m.elements().data[1], best)


class ShatteredMapElementAt(Expression):
    """element_at over a shattered map: the children are its two ragged
    lanes (keys and values, one offsets) that plan/structs.py keeps.  On
    the device: ops/ragged.map_element_at.  (The reference registers no
    rule for it and runs its projection on its CPU engine; the port
    places it on the device, where its ragged kernel is.)"""

    def __init__(self, keys_col: Expression, vals_col: Expression, key,
                 value_type: t.DataType):
        self.children = (keys_col, vals_col)
        self.key = key
        self.value_type = value_type

    def _resolve(self):
        self.dtype = self.value_type
        self.nullable = True

    def _fp_extra(self):
        return repr(self.key)

    def unsupported_reasons(self, conf):
        if _ragged_child_ok(self.children[0]) and \
                _ragged_child_ok(self.children[1]) and \
                isinstance(self.key, (int, bool)):
            return []
        return [_OFF_DEVICE]

    def _eval_dev(self, ctx, kids):
        from ..ops import ragged as R
        kc = _as_ragged_col(kids[0])
        vc = _as_ragged_col(kids[1])
        data, valid = R.map_element_at(kc, vc, _dev_needle(kc, self.key),
                                       ctx.num_rows)
        return DevVal(data, valid, self.dtype, kids[1].dictionary)

    def _eval_cpu(self, batch, kids):
        keys, vals = kids
        best = _last_hits(keys, self.key)
        best = np.where(H.valid_of(vals.validity, len(vals)), best, -1)
        return H.take(vals.elements(), best)


class RenestMap(ArrayExpression):
    """A MAP column again from its two shattered lanes and its validity
    lane (the inverse of the shatter, at the plan's top)."""
    has_rule = False

    def __init__(self, keys_col: Expression, vals_col: Expression,
                 valid: Expression, map_type: t.MapType):
        self.children = (keys_col, vals_col, valid)
        self.map_type = map_type

    def _resolve(self):
        self.dtype = self.map_type
        self.nullable = True

    def _fp_extra(self):
        return self.map_type.simple_string

    def _eval_cpu(self, batch, kids):
        keys, vals, v = kids
        ok = v.data.astype(bool) & H.valid_of(v.validity, len(v)) & \
            _valid_rows(keys)
        col = map_column(keys.elements(), vals.elements(), keys.offsets, ok)
        col.dtype = self.map_type
        return col


class RenestArrayStruct(Expression):
    """An ARRAY<STRUCT> column again from its shattered lanes: the
    array's validity, the element structs' validity (a ragged BOOLEAN
    lane) and one ragged lane a field, all over one offsets."""
    has_rule = False

    def __init__(self, valid: Expression, elem_valid: Expression,
                 field_lanes: List[Expression], array_type: t.ArrayType):
        self.children = tuple([valid, elem_valid] + list(field_lanes))
        self.array_type = array_type

    def _resolve(self):
        self.dtype = self.array_type
        self.nullable = True

    def _fp_extra(self):
        return self.array_type.simple_string

    def unsupported_reasons(self, conf):
        return ["re-nesting array<struct> (host boundary projection)"]

    def _eval_cpu(self, batch, kids):
        v, ev = kids[0], kids[1]
        ok = v.data.astype(bool) & H.valid_of(v.validity, len(v))
        evs = ev.elements()
        e_ok = evs.data.astype(bool) & H.valid_of(evs.validity, len(evs))
        st = self.array_type.element_type
        elems = struct_column([k.elements() for k in kids[2:]],
                              st.names, e_ok, len(evs))
        elems.dtype = st
        col = list_column(elems, ev.offsets, ok)
        col.dtype = self.array_type
        return col


# ---- the CPU engine's map functions (the reference's _CpuMapExpression
# family: maps have no device lane beyond the shattered forms) ----

def _dedup_policy_error(k, where: str) -> ValueError:
    return ValueError(f"duplicate map key {k!r} in {where} "
                      "(spark.sql.mapKeyDedupPolicy=EXCEPTION)")


class _CpuMapExpression(Expression):
    """Base: the CPU engine only, with the reference's reason;
    subclasses give `_row` (Python values of a row in, a list of
    (key, value) pairs or None out)."""

    def unsupported_reasons(self, conf):
        return ["MAP values live on the CPU path"]

    def _eval_cpu(self, batch, kids):
        cols = [k.to_pylist() for k in kids]
        out = [self._row(*vals) for vals in zip(*cols)]
        return map_from_pyvalues(out, self.dtype)


class StrToMap(_CpuMapExpression):
    """str_to_map(text, pairDelim, keyValueDelim) (Spark StringToMap):
    a pair without the key-value delimiter has a null value; a duplicate
    key raises."""

    def __init__(self, child: Expression, pair_delim: str = ",",
                 kv_delim: str = ":"):
        self.children = (child,)
        self.pair_delim = pair_delim
        self.kv_delim = kv_delim

    def _resolve(self):
        self.dtype = t.MapType(t.STRING, t.STRING)
        self.nullable = self.children[0].nullable

    def _fp_extra(self):
        return f"{self.pair_delim};{self.kv_delim}"

    def _row(self, s):
        if s is None:
            return None
        out, seen = [], set()
        for pair in s.split(self.pair_delim):
            k, found, v = pair.partition(self.kv_delim)
            if k in seen:
                raise _dedup_policy_error(k, "str_to_map")
            seen.add(k)
            out.append((k, v if found else None))
        return out


class MapFromArrays(_CpuMapExpression):
    """map_from_arrays(keys, values)."""

    def __init__(self, keys: Expression, values: Expression):
        self.children = (keys, values)

    def _resolve(self):
        self.dtype = t.MapType(self.children[0].dtype.element_type,
                               self.children[1].dtype.element_type)
        self.nullable = True

    def _row(self, ks, vs):
        return None if ks is None or vs is None else list(zip(ks, vs))


class MapConcat(_CpuMapExpression):
    """map_concat(m1, m2, ...): a null map gives null; a key in two maps
    raises (Spark's default spark.sql.mapKeyDedupPolicy=EXCEPTION)."""

    def __init__(self, *maps: Expression):
        assert maps
        self.children = tuple(maps)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = any(c.nullable for c in self.children)

    def _row(self, *maps):
        if any(m is None for m in maps):
            return None
        merged = {}
        for m in maps:
            for k, v in m:
                if k in merged:
                    raise _dedup_policy_error(k, "map_concat")
                merged[k] = v
        return list(merged.items())


class MapEntries(_CpuMapExpression):
    """map_entries(m): ARRAY<STRUCT<key, value>>, which is the map's own
    layout read as an array."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def _resolve(self):
        mt = self.children[0].dtype
        self.dtype = t.ArrayType(t.StructType([
            t.StructField("key", mt.key_type),
            t.StructField("value", mt.value_type)]))
        self.nullable = self.children[0].nullable

    def _eval_cpu(self, batch, kids):
        m = kids[0]
        entries = HostColumn(m.elements().data, None,
                             self.dtype.element_type)
        return HostColumn(entries, m.validity, self.dtype, None, None,
                          m.offsets)


class _MapLambda(_CpuMapExpression):
    """Base of the map higher-order functions, whose body is a Python
    (key, value) function run a map entry at a time."""

    def __init__(self, child: Expression, fn):
        self.children = (child,)
        self.fn = fn

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = self.children[0].nullable

    def _fp_extra(self):
        return repr(self.fn)


class TransformValues(_MapLambda):
    """transform_values(m, (k, v) -> body)."""

    def _row(self, m):
        return None if m is None else [(k, self.fn(k, v)) for k, v in m]


class TransformKeys(_MapLambda):
    """transform_keys(m, (k, v) -> body)."""

    def _row(self, m):
        return None if m is None else [(self.fn(k, v), v) for k, v in m]


class MapFilter(_MapLambda):
    """map_filter(m, (k, v) -> predicate)."""

    def _row(self, m):
        return None if m is None else [(k, v) for k, v in m
                                       if self.fn(k, v)]
