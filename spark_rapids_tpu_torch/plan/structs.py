"""The nested-type shatter: STRUCT and MAP scan columns become flat and
ragged device lanes, re-nested at the plan's top.

Counterpart of spark_rapids_tpu/plan/structs.py.  Device lanes are flat
(or ragged, since ARRAY columns ported), so an eligible scan column
splits into lanes whose names hold `#`:

  struct s {a, b}     ->  "s#__v" (BOOLEAN, the struct's validity),
                          "s#a", "s#b" (each field with the struct's
                          nulls merged in)
  struct s {a, b {c}} ->  "s#__v", "s#a", "s#b#__v", "s#b#c"
  array<struct> x     ->  "x#__v", "x#__ev" (ARRAY<BOOLEAN>, the element
                          structs' validity), one ragged lane a field,
                          all over the array's offsets
  map m<K, V>         ->  "m#__v", "m#keys" ARRAY<K>, "m#vals" ARRAY<V>
                          (the map's offsets, shared)

and every struct or map expression over such a column is rewritten into
lane form: GetStructField into its lane reference (a whole sub-struct
into a CreateNamedStruct of its lanes), map_keys and map_values into the
ragged lanes, element_at into ShatteredMapElementAt (a device kernel),
size into `Size` of the keys (or element-validity) lane, IsNull on the
container into its validity lane, and a whole container in a projection,
a group-by key or a sort key into its lanes (a struct sorts by its
validity lane first, then by each field, Spark's interpreted struct
ordering).  A projection at the top re-nests what the query returns
(CreateNamedStruct, RenestMap, RenestArrayStruct), on the CPU engine by
placement, as every host boundary is.

A use the rewrite cannot express (a whole container as a join key, an
aggregate input, deeper nesting) keeps that column nested: the pass
excludes it and tries again (a fixpoint), so the column and what reads
it run on the CPU engine as before.  Only scan columns gain lanes: a
computed struct (`with_column(CreateNamedStruct(...))`) is never
rewritten into lanes that do not exist.

The reference flattens its scan with pyarrow; the port's `_flatten_table`
is numpy over the host layout (columnar/host.py), where a struct's
fields and a map's keys and values already are the lanes.  The
flattened batch is kept beside the source batch's statistics, keyed by
the columns it flattens, so a warm query meets the same batch object:
its narrowed lanes (columnar/device.narrowed_lane) and its shared scan
upload (exec/compiled.py) are found again, not rebuilt.
"""
from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from .. import types as t
from ..columnar.host import (HostBatch, HostColumn, list_column,
                             struct_field)
from . import expressions as E
from . import logical as L
from .collections import (CreateNamedStruct, GetStructField, MapElementAt,
                          MapKeys, MapValues, RenestArrayStruct, RenestMap,
                          ShatteredMapElementAt, Size, _device_elem_ok)

_KNOWN_NODES = (L.LogicalScan, L.LogicalProject, L.LogicalFilter,
                L.LogicalAggregate, L.LogicalSort, L.LogicalLimit,
                L.LogicalJoin)


def _flat_ok(dt: t.DataType) -> bool:
    return not isinstance(dt, (t.ArrayType, t.MapType, t.StructType,
                               t.BinaryType))


def _flat_struct(dt: t.DataType) -> bool:
    return isinstance(dt, t.StructType) and len(dt.fields) > 0 and \
        all(_flat_ok(f.data_type) for f in dt.fields)


def _shatterable(dt: t.DataType, depth: int = 0) -> bool:
    """One level deeper than flat, as the reference: a struct's fields
    may be flat structs, an array<struct-of-flat> shatters into ragged
    lanes over one offsets, a map's key and value must have a ragged
    device lane."""
    if isinstance(dt, t.StructType):
        if len(dt.fields) == 0:
            return False
        return all(_flat_ok(f.data_type) or
                   (depth == 0 and _flat_struct(f.data_type))
                   for f in dt.fields)
    if isinstance(dt, t.ArrayType) and depth == 0:
        return _flat_struct(dt.element_type) and all(
            _device_elem_ok(f.data_type)
            for f in dt.element_type.fields)
    if isinstance(dt, t.MapType):
        return _device_elem_ok(dt.key_type) and \
            _device_elem_ok(dt.value_type)
    return False


class _Abort(Exception):
    """A use of column `name` the rewrite cannot express in lanes."""

    def __init__(self, name: str):
        self.name = name


def _lane_names(name: str, dt: t.DataType) -> List[str]:
    if isinstance(dt, t.StructType):
        out = [f"{name}#__v"]
        for f in dt.fields:
            if _flat_struct(f.data_type):
                out.extend(_lane_names(f"{name}#{f.name}", f.data_type))
            else:
                out.append(f"{name}#{f.name}")
        return out
    if isinstance(dt, t.ArrayType):
        st = dt.element_type
        return ([f"{name}#__v", f"{name}#__ev"] +
                [f"{name}#{f.name}" for f in st.fields])
    return [f"{name}#__v", f"{name}#keys", f"{name}#vals"]


def _bool_column(mask: np.ndarray) -> HostColumn:
    return HostColumn(np.ascontiguousarray(mask, bool), None, t.BOOLEAN)


def _flatten_column(name: str, col: HostColumn, out_cols: List[HostColumn],
                    out_names: List[str]) -> None:
    """Append the lanes of one shatterable column."""
    out_cols.append(_bool_column(col.valid_mask()))
    out_names.append(f"{name}#__v")
    dt = col.dtype
    if isinstance(dt, t.StructType):
        for f in dt.fields:
            sub = struct_field(col, f.name)
            if isinstance(f.data_type, t.StructType):
                # struct-of-struct: one level down
                out_cols.append(_bool_column(sub.valid_mask()))
                out_names.append(f"{name}#{f.name}#__v")
                for ss in f.data_type.fields:
                    out_cols.append(struct_field(sub, ss.name))
                    out_names.append(f"{name}#{f.name}#{ss.name}")
            else:
                out_cols.append(sub)
                out_names.append(f"{name}#{f.name}")
        return
    if isinstance(dt, t.ArrayType):                  # array<struct>
        elems = col.elements()
        out_cols.append(list_column(_bool_column(elems.valid_mask()),
                                    col.offsets, col.validity))
        out_names.append(f"{name}#__ev")
        for f in dt.element_type.fields:
            out_cols.append(list_column(struct_field(elems, f.name),
                                        col.offsets, col.validity))
            out_names.append(f"{name}#{f.name}")
        return
    # a map: its keys and values over its offsets; a null map is an
    # empty span in the host layout, so no phantom entry leaks
    kv = col.elements()
    for i, lane in ((0, "keys"), (1, "vals")):
        out_cols.append(list_column(kv.data[i], col.offsets, col.validity))
        out_names.append(f"{name}#{lane}")


def _flatten_table(table: HostBatch, names: Set[str]) -> HostBatch:
    """`table` with the columns `names` replaced by their lanes, kept
    beside the source's statistics so every plan over the same source
    gets the same flattened batch."""
    key = ("shattered", tuple(table.names), frozenset(names))
    hit = table._stats.get(key)
    if hit is not None:
        return hit
    cols: List[HostColumn] = []
    out_names: List[str] = []
    for name, col in zip(table.names, table.columns):
        if name in names:
            _flatten_column(name, col, cols, out_names)
        else:
            cols.append(col)
            out_names.append(name)
    out = HostBatch(cols, out_names)
    table._stats[key] = out
    return out


class _Shatterer:
    """One rewrite attempt over a fixed set of excluded column names;
    raises _Abort naming a column whose use cannot be expressed."""

    def __init__(self, excluded: Set[str], scan_cols: Set[str]):
        self.excluded = excluded
        # only scan columns gain lanes: a computed container stays nested
        self.scan_cols = scan_cols

    def _nested_cols(self, schema: t.StructType) -> Dict[str, t.DataType]:
        return {f.name: f.data_type for f in schema.fields
                if _shatterable(f.data_type) and
                f.name in self.scan_cols and
                f.name not in self.excluded}

    def expr(self, e: E.Expression, nested: Dict[str, t.DataType],
             expand_ok: bool = False):
        """One expression rewritten; with `expand_ok` (a projection list,
        group-by keys, sort keys) a whole container becomes a list of
        (lane expression, lane name)."""
        if isinstance(e, E.Alias):
            inner = self.expr(e.children[0], nested, expand_ok)
            if isinstance(inner, list):
                raise _Abort(_ref_name(e.children[0]))
            return E.Alias(inner, e.name)
        if isinstance(e, E.ColumnRef):
            if e.name in nested:
                if not expand_ok:
                    raise _Abort(e.name)
                return [(E.ColumnRef(ln), ln)
                        for ln in _lane_names(e.name, nested[e.name])]
            return e
        if isinstance(e, GetStructField):
            name, path = _field_path(e)
            if name is not None and name in nested:
                sub_dt = _path_dtype(nested[name], path)
                if sub_dt is None:
                    raise _Abort(name)
                lane = "#".join([name] + path)
                if _flat_ok(sub_dt):
                    return E.ColumnRef(lane)
                if isinstance(sub_dt, t.StructType):
                    # a whole sub-struct: re-nested inline from its lanes
                    return CreateNamedStruct(
                        [sf.name for sf in sub_dt.fields],
                        [E.ColumnRef(f"{lane}#{sf.name}")
                         for sf in sub_dt.fields],
                        valid=E.ColumnRef(f"{lane}#__v"))
                raise _Abort(name)
        if isinstance(e, (E.IsNull, E.IsNotNull)):
            child = e.children[0]
            if isinstance(child, E.ColumnRef) and child.name in nested:
                v = E.ColumnRef(f"{child.name}#__v")
                return E.Not(v) if isinstance(e, E.IsNull) else v
            if isinstance(child, GetStructField):
                name, path = _field_path(child)
                if name is not None and name in nested:
                    sub_dt = _path_dtype(nested[name], path)
                    lane = "#".join([name] + path)
                    if isinstance(sub_dt, t.StructType):
                        v = E.ColumnRef(f"{lane}#__v")
                        return E.Not(v) if isinstance(e, E.IsNull) else v
        child = e.children[0] if e.children else None
        direct = isinstance(child, E.ColumnRef) and child.name in nested
        if direct and isinstance(e, MapKeys):
            return E.ColumnRef(f"{child.name}#keys")
        if direct and isinstance(e, MapValues):
            return E.ColumnRef(f"{child.name}#vals")
        if direct and isinstance(e, MapElementAt):
            return ShatteredMapElementAt(
                E.ColumnRef(f"{child.name}#keys"),
                E.ColumnRef(f"{child.name}#vals"),
                e.key, nested[child.name].value_type)
        if direct and isinstance(e, Size):
            if isinstance(nested[child.name], t.MapType):
                return Size(E.ColumnRef(f"{child.name}#keys"))
            if isinstance(nested[child.name], t.ArrayType):
                return Size(E.ColumnRef(f"{child.name}#__ev"))
        # generic: the children rewritten; a whole container left below
        # raises _Abort through the ColumnRef branch
        kids = [self.expr(c, nested) for c in e.children]
        if all(k is c for k, c in zip(kids, e.children)):
            return e
        return _with_children(e, kids)

    def _expand(self, exprs, names, nested):
        out_e: List[E.Expression] = []
        out_n: List[str] = []
        for e, n in zip(exprs, names):
            r = self.expr(e, nested, expand_ok=True)
            if isinstance(r, list):
                for le, ln in r:
                    out_e.append(le)
                    out_n.append(ln)
            else:
                out_e.append(r)
                out_n.append(n)
        return out_e, out_n

    def _agg(self, fn, nested):
        import copy
        for attr in ("child", "child2"):
            c = getattr(fn, attr, None)
            if c is not None:
                new = self.expr(c, nested)
                if new is not c:
                    fn = copy.copy(fn)
                    setattr(fn, attr, new)
        return fn

    def plan(self, p: L.LogicalPlan) -> L.LogicalPlan:
        nested = self._nested_cols(p.child.schema) if p.children else {}
        if isinstance(p, L.LogicalScan):
            names = set(self._nested_cols(p.schema))
            if not names:
                return p
            return L.LogicalScan(_flatten_table(p.table, names))
        if isinstance(p, L.LogicalProject):
            child = self.plan(p.child)
            exprs, names = self._expand(p.exprs, p.names, nested)
            return L.LogicalProject(exprs, child, names)
        if isinstance(p, L.LogicalFilter):
            cond = self.expr(p.condition, nested)
            return L.LogicalFilter(cond, self.plan(p.child))
        if isinstance(p, L.LogicalAggregate):
            keys, key_names = self._expand(p.keys, p.key_names, nested)
            aggs = [(self._agg(fn, nested), n) for fn, n in p.aggs]
            return L.LogicalAggregate(keys, aggs, self.plan(p.child),
                                      key_names=key_names)
        if isinstance(p, L.LogicalSort):
            orders = []
            for e, asc, nf in p.orders:
                r = self.expr(e, nested, expand_ok=True)
                if isinstance(r, list):
                    # a struct sorts by (validity, fields): the validity
                    # lane ascending (False first) puts null structs
                    # first, as `nf` asks; a field's nulls follow Spark's
                    # interpreted struct ordering (first when ascending)
                    v, *lanes = [le for le, _ln in r]
                    orders.append((v, nf, True))
                    for le in lanes:
                        orders.append((le, asc, asc))
                else:
                    orders.append((r, asc, nf))
            return L.LogicalSort(orders, self.plan(p.child))
        if isinstance(p, L.LogicalLimit):
            return L.LogicalLimit(p.limit, self.plan(p.child))
        if isinstance(p, L.LogicalJoin):
            lnested = self._nested_cols(p.left.schema)
            rnested = self._nested_cols(p.right.schema)
            # a field key becomes its lane; a whole container aborts
            lk = [self.expr(k, lnested) for k in p.left_keys]
            rk = [self.expr(k, rnested) for k in p.right_keys]
            return L.LogicalJoin(p.join_type, self.plan(p.left),
                                 self.plan(p.right), lk, rk)
        raise _Abort("")                    # unknown node (pre-checked)


def _ref_name(e: E.Expression) -> str:
    while isinstance(e, E.Alias):
        e = e.children[0]
    return e.name if isinstance(e, E.ColumnRef) else ""


def _field_path(e: E.Expression):
    """(column name, [field, subfield, ...]) of a GetStructField chain
    over a ColumnRef, else (None, None)."""
    path: List[str] = []
    cur = e
    while isinstance(cur, GetStructField):
        path.append(cur.field)
        cur = cur.children[0]
    if isinstance(cur, E.ColumnRef):
        return cur.name, list(reversed(path))
    return None, None


def _path_dtype(dt: t.DataType, path: List[str]):
    """The type at the end of a struct field path, None if invalid."""
    for f in path:
        if not isinstance(dt, t.StructType):
            return None
        match = [sf.data_type for sf in dt.fields if sf.name == f]
        if not match:
            return None
        dt = match[0]
    return dt


def _renest_expr(name: str, dt: t.DataType) -> E.Expression:
    """The expression rebuilding column `name` from its lanes."""
    if isinstance(dt, t.StructType):
        field_exprs = []
        for sf in dt.fields:
            if _flat_struct(sf.data_type):
                field_exprs.append(
                    _renest_expr(f"{name}#{sf.name}", sf.data_type))
            else:
                field_exprs.append(E.ColumnRef(f"{name}#{sf.name}"))
        return CreateNamedStruct([sf.name for sf in dt.fields],
                                 field_exprs,
                                 valid=E.ColumnRef(f"{name}#__v"))
    if isinstance(dt, t.ArrayType):
        st = dt.element_type
        return RenestArrayStruct(
            E.ColumnRef(f"{name}#__v"), E.ColumnRef(f"{name}#__ev"),
            [E.ColumnRef(f"{name}#{sf.name}") for sf in st.fields], dt)
    return RenestMap(E.ColumnRef(f"{name}#keys"),
                     E.ColumnRef(f"{name}#vals"),
                     E.ColumnRef(f"{name}#__v"), dt)


def _with_children(e: E.Expression, kids: List[E.Expression]):
    out = e._with_children(kids)
    # drop resolution caches so the type re-derives over the new children
    for attr in ("dtype", "nullable"):
        out.__dict__.pop(attr, None)
    return out


def shatter_nested(plan: L.LogicalPlan) -> L.LogicalPlan:
    """The rewritten plan (the plan itself when nothing shatters)."""
    def walk_ok(p) -> bool:
        return isinstance(p, _KNOWN_NODES) and \
            all(walk_ok(c) for c in p.children)

    def scan_candidates(p, out):
        if isinstance(p, L.LogicalScan):
            for f in p.schema.fields:
                if _shatterable(f.data_type):
                    out.add(f.name)
        for c in p.children:
            scan_candidates(c, out)

    candidates: Set[str] = set()
    scan_candidates(plan, candidates)
    if not candidates or not walk_ok(plan):
        return plan

    orig_schema = plan.schema
    excluded: Set[str] = set()
    while True:
        sh = _Shatterer(excluded, candidates)
        try:
            new_plan = sh.plan(plan)
            break
        except _Abort as a:
            if not a.name or a.name in excluded:
                return plan               # cannot localize: no shatter
            excluded.add(a.name)
            if excluded >= candidates:
                return plan

    # re-nest what survives at the top: the schema the user sees stays
    new_names = set(new_plan.schema.names)
    exprs: List[E.Expression] = []
    names: List[str] = []
    changed = False
    for f in orig_schema.fields:
        dt = f.data_type
        lanes = _lane_names(f.name, dt) if _shatterable(dt) else []
        if lanes and all(ln in new_names for ln in lanes):
            changed = True
            exprs.append(_renest_expr(f.name, dt))
        else:
            exprs.append(E.ColumnRef(f.name))
        names.append(f.name)
    if not changed:
        return new_plan
    return L.LogicalProject(exprs, new_plan, names)
