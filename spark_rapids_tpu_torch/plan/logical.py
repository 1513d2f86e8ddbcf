"""Logical plan nodes — the pre-rewrite algebra plan/overrides.py
converts.

Counterpart of spark_rapids_tpu/plan/logical.py for the nodes the ported
slices run: scan (over a host batch instead of an Arrow table), range, project,
filter, aggregate, sort, limit, sample, join, union, expand (the
grouping-sets lowering), window, generate (explode / posexplode) and
the six pandas nodes (mapInPandas, the scalar pandas UDF, applyInPandas,
the grouped pandas UDAF, the pandas window UDF and the cogrouped
applyInPandas): all 20 of the reference's classes.  Each node declares
its schema and nothing else; placement and operator choice belong to
plan/overrides.py.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .. import types as t
from ..columnar.host import HostBatch
from . import expressions as E
from .aggregates import AggregateFunction


class LogicalPlan:
    """Base logical operator. Schema resolves lazily, children first."""

    def __init__(self, *children: "LogicalPlan"):
        self.children = list(children)
        self._schema: Optional[t.StructType] = None

    @property
    def child(self) -> "LogicalPlan":
        return self.children[0]

    @property
    def schema(self) -> t.StructType:
        if self._schema is None:
            self._schema = self._resolve_schema()
        return self._schema

    def _resolve_schema(self) -> t.StructType:
        raise NotImplementedError(type(self).__name__)

    def name(self) -> str:
        return type(self).__name__.removeprefix("Logical")


def _as_expr(e) -> E.Expression:
    return E.ColumnRef(e) if isinstance(e, str) else e


def _out_name(e: E.Expression, i: int) -> str:
    if isinstance(e, (E.Alias, E.ColumnRef)):
        return e.name
    return f"col{i}"


class LogicalScan(LogicalPlan):
    """Leaf over an in-memory host batch (the LocalTableScan analogue)."""

    def __init__(self, table: HostBatch):
        super().__init__()
        self.table = table

    def _resolve_schema(self):
        return self.table.schema


class LogicalRange(LogicalPlan):
    """Leaf: the LONG ids start, start + step, ... below end (above it for
    a negative step), in one non-null column."""

    def __init__(self, start: int, end: int, step: int = 1,
                 name: str = "id"):
        super().__init__()
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.col_name = name

    def _resolve_schema(self):
        return t.StructType([t.StructField(self.col_name, t.LONG, False)])


class LogicalSample(LogicalPlan):
    """Bernoulli sample: each row kept with probability `fraction`,
    decided by a counter-based hash of (seed, the row's global
    position), so the same seed keeps the same rows however the input
    is batched."""

    def __init__(self, fraction: float, seed: int, child: LogicalPlan):
        super().__init__(child)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction {fraction} not in [0, 1]")
        self.fraction = float(fraction)
        self.seed = int(seed)

    def _resolve_schema(self):
        return self.child.schema


class LogicalProject(LogicalPlan):
    def __init__(self, exprs: Sequence, child: LogicalPlan,
                 names: Optional[Sequence[str]] = None):
        super().__init__(child)
        self.exprs = [_as_expr(e) for e in exprs]
        self.names = list(names) if names is not None else \
            [_out_name(e, i) for i, e in enumerate(self.exprs)]

    def _resolve_schema(self):
        bound = [e.bind(self.child.schema) for e in self.exprs]
        return t.StructType([t.StructField(n, e.dtype, e.nullable)
                             for n, e in zip(self.names, bound)])


class LogicalFilter(LogicalPlan):
    def __init__(self, condition: E.Expression, child: LogicalPlan):
        super().__init__(child)
        self.condition = _as_expr(condition)

    def _resolve_schema(self):
        return self.child.schema


class LogicalAggregate(LogicalPlan):
    """group-by keys + aggregate list.  keys may be arbitrary expressions;
    aggs are (AggregateFunction, output name) pairs."""

    def __init__(self, keys: Sequence,
                 aggs: Sequence[Tuple[AggregateFunction, str]],
                 child: LogicalPlan, key_names: Optional[Sequence[str]] = None):
        super().__init__(child)
        self.keys = [_as_expr(k) for k in keys]
        self.key_names = list(key_names) if key_names is not None else \
            [_out_name(k, i) for i, k in enumerate(self.keys)]
        self.aggs = list(aggs)

    def _resolve_schema(self):
        schema = self.child.schema
        fields = [t.StructField(n, k.bind(schema).dtype)
                  for n, k in zip(self.key_names, self.keys)]
        fields += [t.StructField(n, fn.bind(schema).dtype)
                   for fn, n in self.aggs]
        return t.StructType(fields)


class LogicalSort(LogicalPlan):
    """orders: sequence of (expr-or-name, ascending, nulls_first)."""

    def __init__(self, orders: Sequence, child: LogicalPlan):
        super().__init__(child)
        norm = []
        for o in orders:
            if isinstance(o, (str, E.Expression)):
                norm.append((_as_expr(o), True, True))
            else:
                e, *rest = o
                asc = rest[0] if rest else True
                nf = rest[1] if len(rest) > 1 else asc
                norm.append((_as_expr(e), asc, nf))
        self.orders = norm

    def _resolve_schema(self):
        return self.child.schema


class LogicalLimit(LogicalPlan):
    def __init__(self, limit: int, child: LogicalPlan):
        super().__init__(child)
        self.limit = limit

    def _resolve_schema(self):
        return self.child.schema


class LogicalJoin(LogicalPlan):
    """Equi-join on key expression pairs.  join_type: inner, left_outer,
    right_outer, full_outer, left_semi, left_anti, cross."""

    def __init__(self, join_type: str, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence = (), right_keys: Sequence = ()):
        super().__init__(left, right)
        self.join_type = join_type
        self.left_keys = [_as_expr(k) for k in left_keys]
        self.right_keys = [_as_expr(k) for k in right_keys]

    @property
    def left(self) -> LogicalPlan:
        return self.children[0]

    @property
    def right(self) -> LogicalPlan:
        return self.children[1]

    def _resolve_schema(self):
        # key types must match exactly (the join lanes compare raw
        # storage values): callers cast, as in the reference
        for lk, rk in zip(self.left_keys, self.right_keys):
            lt_ = lk.bind(self.left.schema).dtype
            rt_ = rk.bind(self.right.schema).dtype
            if lt_ != rt_:
                raise TypeError(
                    f"join key type mismatch: {lt_.simple_string} vs "
                    f"{rt_.simple_string} — add an explicit Cast")
        lf = list(self.left.schema.fields)
        if self.join_type in ("left_semi", "left_anti"):
            return t.StructType(lf)
        return t.StructType(lf + list(self.right.schema.fields))


class LogicalUnion(LogicalPlan):
    """UNION ALL of schema-aligned children (the first child's names)."""

    def __init__(self, *children: LogicalPlan):
        super().__init__(*children)

    def _resolve_schema(self):
        return self.children[0].schema


class LogicalExpand(LogicalPlan):
    """One output row per input row and projection (rollup, cube and
    grouping sets lower to it, session.GroupingSets)."""

    def __init__(self, projections: Sequence[Sequence], names: Sequence[str],
                 child: LogicalPlan):
        super().__init__(child)
        self.projections = [[_as_expr(e) for e in p] for p in projections]
        self.names = list(names)

    def _resolve_schema(self):
        bound = [e.bind(self.child.schema) for e in self.projections[0]]
        return t.StructType([t.StructField(n, e.dtype)
                             for n, e in zip(self.names, bound)])


class LogicalWindow(LogicalPlan):
    """Window functions over (partition keys, order keys).  window_exprs:
    (WindowFunctionSpec, output name) pairs appended to the child schema
    (plan/window.py)."""

    def __init__(self, window_exprs: Sequence, partition_keys: Sequence,
                 order_keys: Sequence, child: LogicalPlan):
        from .window import check_window_analysis
        super().__init__(child)
        check_window_analysis(window_exprs, order_keys)
        self.window_exprs = list(window_exprs)
        self.partition_keys = [_as_expr(k) for k in partition_keys]
        norm = []
        for o in order_keys:
            if isinstance(o, (str, E.Expression)):
                norm.append((_as_expr(o), True, True))
            else:
                e, *rest = o
                asc = rest[0] if rest else True
                nf = rest[1] if len(rest) > 1 else asc
                norm.append((_as_expr(e), asc, nf))
        self.order_keys = norm

    def _resolve_schema(self):
        fields = list(self.child.schema.fields)
        for spec, name in self.window_exprs:
            bound = spec.bind(self.child.schema)
            fields.append(t.StructField(name, bound.dtype))
        return t.StructType(fields)


class LogicalGenerate(LogicalPlan):
    """A generator (explode / posexplode, plan/collections.ExplodeGen)
    appending its columns to the child's rows: the reference's
    GpuGenerateExec role.  plan/overrides.GenerateMeta places it."""

    def __init__(self, generator, child: LogicalPlan,
                 output_names: Sequence[str] = ()):
        super().__init__(child)
        self.generator = generator
        self.output_names = list(output_names)

    def _resolve_schema(self):
        bound = self.generator.bind(self.child.schema)
        fields = list(self.child.schema.fields)
        gen_fields = bound.output_fields()
        names = self.output_names or [f.name for f in gen_fields]
        for f, n in zip(gen_fields, names):
            fields.append(t.StructField(n, f.data_type, f.nullable))
        return t.StructType(fields)

    def describe(self):
        return f"Generate[{self.generator!r}]"


# ---------------------------------------------------------------------------
# The pandas nodes: host operators by placement (exec/python_exec.py runs
# each through a forked worker over a numpy wire)
# ---------------------------------------------------------------------------

class LogicalMapInPandas(LogicalPlan):
    """mapInPandas: iterator-of-pandas-DataFrames transform in a forked
    python worker (reference GpuMapInPandasExec)."""

    def __init__(self, fn, schema, child: LogicalPlan):
        super().__init__(child)
        self.fn = fn
        self.result_schema = schema

    def _resolve_schema(self):
        return self.result_schema

    def describe(self):
        return f"MapInPandas[{getattr(self.fn, '__name__', 'fn')}]"


class LogicalArrowEvalPython(LogicalPlan):
    """Scalar pandas-UDF projection outputs appended to the child
    (reference GpuArrowEvalPythonExec)."""

    def __init__(self, udfs, child: LogicalPlan):
        super().__init__(child)
        self.udfs = list(udfs)     # (fn, in_cols, name, dtype)

    def _resolve_schema(self):
        fields = list(self.child.schema.fields)
        for _fn, _cols, name, dt in self.udfs:
            fields.append(t.StructField(name, dt, True))
        return t.StructType(fields)

    def describe(self):
        return f"ArrowEvalPython[{[n for _f, _c, n, _t in self.udfs]}]"


class LogicalFlatMapGroupsInPandas(LogicalPlan):
    """groupBy(keys).applyInPandas(fn, schema) — reference
    GpuFlatMapGroupsInPandasExec."""

    def __init__(self, key_names, fn, schema, child: LogicalPlan):
        super().__init__(child)
        self.key_names = list(key_names)
        self.fn = fn
        self.result_schema = schema

    def _resolve_schema(self):
        return self.result_schema

    def describe(self):
        return (f"FlatMapGroupsInPandas[{self.key_names}, "
                f"{getattr(self.fn, '__name__', 'fn')}]")


class LogicalAggregateInPandas(LogicalPlan):
    """groupBy(keys).agg(pandas UDAFs) — reference
    GpuAggregateInPandasExec.  aggs: (fn, in_cols, name, dtype)."""

    def __init__(self, key_names, aggs, child: LogicalPlan):
        super().__init__(child)
        self.key_names = list(key_names)
        self.aggs = list(aggs)

    def _resolve_schema(self):
        schema = self.child.schema
        fields = [schema.fields[schema.field_index(n)]
                  for n in self.key_names]
        for _fn, _cols, name, dt in self.aggs:
            fields.append(t.StructField(name, dt, True))
        return t.StructType(fields)

    def describe(self):
        return f"AggregateInPandas[{[n for _f, _c, n, _t in self.aggs]}]"


class LogicalWindowInPandas(LogicalPlan):
    """Pandas window UDFs over unbounded partition frames — reference
    GpuWindowInPandasExec.  windows: (fn, in_cols, name, dtype)."""

    def __init__(self, partition_names, order_names, windows,
                 child: LogicalPlan):
        super().__init__(child)
        self.partition_names = list(partition_names)
        self.order_names = list(order_names)
        self.windows = list(windows)

    def _resolve_schema(self):
        fields = list(self.child.schema.fields)
        for _fn, _cols, name, dt in self.windows:
            fields.append(t.StructField(name, dt, True))
        return t.StructType(fields)

    def describe(self):
        return f"WindowInPandas[{[n for _f, _c, n, _t in self.windows]}]"


class LogicalFlatMapCoGroupsInPandas(LogicalPlan):
    """cogroup(l.groupBy(keys), r.groupBy(keys)).applyInPandas(fn, schema)
    — fn maps each key's (left DataFrame, right DataFrame) pair to a
    result DataFrame (reference GpuFlatMapCoGroupsInPandasExec)."""

    def __init__(self, left_keys, right_keys, fn, schema,
                 left: LogicalPlan, right: LogicalPlan):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self.result_schema = schema

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def _resolve_schema(self):
        return self.result_schema

    def describe(self):
        return (f"FlatMapCoGroupsInPandas[{self.left_keys}, "
                f"{getattr(self.fn, '__name__', 'fn')}]")
