"""User-facing session + DataFrame API.

Counterpart of spark_rapids_tpu/session.py for what the ported TPC-H
and TPC-DS queries use (`how="cross"` joins, `with_column`, `union`,
`window`, and `rollup` / `cube` / `grouping_sets` through the
`GroupingSets` builder with `grouping()` and `grouping_id()`), and
`from_pydict`, `range`, `sample`, `count` and `explain`, and the pandas
operations (`map_in_pandas`, `with_pandas_udf`,
`with_window_pandas_udf`; on a group-by `apply_in_pandas`,
`agg_in_pandas` and `cogroup(...).apply_in_pandas`, exec/python_exec.py):

    s = TpuSession()                     # device "cuda"
    df = s.from_host(batch).filter(E.GreaterThan(col("x"), lit(1))) \\
         .group_by("k").agg((Sum(col("x")), "sx")).sort("k")
    df.collect()                         # HostBatch (numpy columns)

`TpuSession(conf=None, device=None)`: None means "cuda", and the
constructor raises when no CUDA device is present — nothing carries on
on the CPU by itself.  `device="cpu"` runs the same plan on CPU tensors,
where every kernel wrapper takes its plain PyTorch version (the tests
do this).  Operators that the overrides place on the CPU engine
(exec/host_exec.py) run on numpy either way; with
`spark.rapids.tpu.sql.enabled=false` the whole query does, and
`collect()` returns a HostBatch whichever engine holds the root.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import types as t
from .columnar.device import resolve_device
from .columnar.host import HostBatch, from_arrow, from_pydict, result_struct
from .config import TpuConf
from .exec.plan import ExecContext
from .plan import expressions as E
from .plan import logical as L
from .plan.aggregates import AggregateFunction
from .plan.overrides import PhysicalQuery, _expr_refs, apply_overrides


class TpuSession:
    def __init__(self, conf: Optional[Dict] = None, device=None):
        self.conf = conf if isinstance(conf, TpuConf) else TpuConf(conf)
        self.device = resolve_device(device)

    # -- sources -----------------------------------------------------------
    def from_host(self, batch: HostBatch) -> "DataFrame":
        return DataFrame(L.LogicalScan(batch), self)

    def from_arrow(self, table) -> "DataFrame":
        """A DataFrame over a pyarrow Table (needs pyarrow installed)."""
        return self.from_host(from_arrow(table))

    def from_pydict(self, data: Dict, schema: Optional[t.StructType] = None
                    ) -> "DataFrame":
        """A DataFrame over Python lists or numpy arrays by column name,
        typed as pyarrow would infer them unless `schema` says
        (columnar/host.from_pydict); no pyarrow needed."""
        return self.from_host(from_pydict(data, schema))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              name: str = "id") -> "DataFrame":
        """range(end) or range(start, end[, step]): one LONG column."""
        if end is None:
            start, end = 0, start
        return DataFrame(L.LogicalRange(start, end, step, name), self)


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence):
        self._df = df
        self._keys = list(keys)

    def agg(self, *aggs: Tuple[AggregateFunction, str]) -> "DataFrame":
        return DataFrame(
            L.LogicalAggregate(self._keys, list(aggs), self._df._plan),
            self._df._session)

    def _key_names(self) -> list:
        names = []
        for k in self._keys:
            if isinstance(k, str):
                names.append(k)
            elif isinstance(k, E.ColumnRef):
                names.append(k.name)
            else:
                raise TypeError(
                    "pandas group operations need plain column keys")
        schema_names = set(self._df.schema.names)
        for n in names:
            # fail at plan build, not inside the worker feeder thread
            if n not in schema_names:
                raise KeyError(f"group key {n!r} not in "
                               f"{sorted(schema_names)}")
        return names

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """groupBy(keys).applyInPandas(fn, schema): fn maps each group's
        pandas.DataFrame to a result DataFrame (reference
        GpuFlatMapGroupsInPandasExec).  `schema` is the result
        StructType (or a pyarrow Schema, where pyarrow imports)."""
        return DataFrame(
            L.LogicalFlatMapGroupsInPandas(self._key_names(), fn,
                                           result_struct(schema),
                                           self._df._plan),
            self._df._session)

    def cogroup(self, other: "GroupedData") -> "CoGroupedData":
        """cogroup(l.group_by(k), r.group_by(k)) -> .apply_in_pandas(fn,
        schema) with fn(left_df, right_df) (reference
        GpuFlatMapCoGroupsInPandasExec)."""
        return CoGroupedData(self, other)

    def agg_in_pandas(self, *aggs) -> "DataFrame":
        """Grouped pandas UDAFs: aggs = (fn, input column names, output
        name, output type); each fn maps the group's Series to one
        scalar (reference GpuAggregateInPandasExec)."""
        norm = [(fn, list(cols), name, dt) for fn, cols, name, dt in aggs]
        return DataFrame(
            L.LogicalAggregateInPandas(self._key_names(), norm,
                                       self._df._plan),
            self._df._session)


class CoGroupedData:
    def __init__(self, left: GroupedData, right: GroupedData):
        self._left = left
        self._right = right

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        return DataFrame(
            L.LogicalFlatMapCoGroupsInPandas(
                self._left._key_names(), self._right._key_names(), fn,
                result_struct(schema), self._left._df._plan,
                self._right._df._plan),
            self._left._df._session)


GROUPING_ID_COLUMN = "spark_grouping_id"


class GroupingSets:
    """rollup / cube / grouping-sets aggregation builder.

    Lowers to Expand + Aggregate as the reference does: one Expand
    projection per grouping set, with the aggregated-away key columns
    replaced by typed nulls and a literal `spark_grouping_id` bitmask
    column appended (MSB = first key, 1 = key aggregated away — Spark's
    grouping_id() bit order), then a hash aggregate over
    keys + spark_grouping_id.

    The result carries the keys, `spark_grouping_id`, then the
    aggregates; `grouping(name)` / `grouping_id()` build the Spark
    expressions over that column for post-aggregation selects.
    """

    def __init__(self, df: "DataFrame", keys: Sequence,
                 sets: Sequence[Sequence[str]]):
        self._df = df
        self._keys = [k if isinstance(k, str) else k.name for k in keys]
        schema_names = set(df.schema.names)
        for k in self._keys:
            if k not in schema_names:
                raise KeyError(f"grouping key {k!r} not in "
                               f"{sorted(schema_names)}")
            if k == GROUPING_ID_COLUMN:
                raise ValueError(
                    f"column name {GROUPING_ID_COLUMN!r} is reserved")
        norm, seen = [], set()
        for s in sets:
            tup = tuple(k for k in self._keys if k in set(s))
            extra = set(s) - set(self._keys)
            if extra:
                raise KeyError(f"grouping set columns {sorted(extra)} "
                               f"not in keys {self._keys}")
            if tup not in seen:       # duplicate sets collapse, as in Spark
                seen.add(tup)
                norm.append(tup)
        self._sets = norm

    def grouping_id(self) -> E.Expression:
        """Spark grouping_id(): the bitmask column itself (bit n-1-i set
        when key i is aggregated away in this row's grouping set)."""
        return E.ColumnRef(GROUPING_ID_COLUMN)

    def grouping(self, name: str) -> E.Expression:
        """Spark grouping(col): 1 when `col` is aggregated away in this
        row's grouping set, else 0 — derived from the gid bitmask."""
        if name not in self._keys:
            raise KeyError(f"grouping({name!r}): not a grouping key of "
                           f"{self._keys}")
        shift = len(self._keys) - 1 - self._keys.index(name)
        return E.BitwiseAnd(
            E.ShiftRight(E.ColumnRef(GROUPING_ID_COLUMN), E.Literal(shift)),
            E.Literal(1))

    def agg(self, *aggs: Tuple[AggregateFunction, str]) -> "DataFrame":
        child = self._df._plan
        schema = child.schema
        key_set = set(self._keys)
        for fn, _name in aggs:
            if fn.child is not None:
                refs: set = set()
                _expr_refs(fn.child, refs)
                hit = refs & key_set
                if hit:
                    # Spark's Expand keeps a second, un-nulled copy of the
                    # child attributes for aggregate inputs; this engine
                    # replaces keys in place, so aggregating a grouping
                    # key would silently see the nulled copies
                    raise NotImplementedError(
                        f"aggregating grouping key(s) {sorted(hit)} under "
                        f"rollup/cube is not supported — aggregate a "
                        f"projected copy instead")
        projections = []
        n = len(self._keys)
        for s in self._sets:
            proj = []
            for f in schema.fields:
                if f.name in key_set and f.name not in s:
                    proj.append(E.Literal(None, f.data_type))
                else:
                    proj.append(E.ColumnRef(f.name))
            gid = 0
            for i, k in enumerate(self._keys):
                if k not in s:
                    gid |= 1 << (n - 1 - i)
            proj.append(E.Literal(gid, t.INT))
            projections.append(proj)
        expand = L.LogicalExpand(
            projections, list(schema.names) + [GROUPING_ID_COLUMN], child)
        plan = L.LogicalAggregate(
            list(self._keys) + [GROUPING_ID_COLUMN], list(aggs), expand)
        return DataFrame(plan, self._df._session)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: TpuSession):
        self._plan = plan
        self._session = session

    # -- transformations ---------------------------------------------------
    def select(self, *exprs, names: Optional[Sequence[str]] = None
               ) -> "DataFrame":
        return self._wrap(L.LogicalProject(list(exprs), self._plan, names))

    def with_column(self, name: str, expr: E.Expression) -> "DataFrame":
        """Every column but `name`, then `expr` as `name` (last)."""
        keep = [n for n in self.schema.names if n != name]
        return self._wrap(L.LogicalProject(
            [E.ColumnRef(n) for n in keep] + [expr], self._plan,
            keep + [name]))

    def filter(self, condition) -> "DataFrame":
        return self._wrap(L.LogicalFilter(condition, self._plan))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, keys)

    def rollup(self, *keys) -> GroupingSets:
        """GROUP BY ROLLUP(k1, .., kn): the n+1 prefix grouping sets
        (k1..kn), (k1..kn-1), .., () — subtotal rows per level."""
        names = [k if isinstance(k, str) else k.name for k in keys]
        sets = [tuple(names[:i]) for i in range(len(names), -1, -1)]
        return GroupingSets(self, names, sets)

    def cube(self, *keys) -> GroupingSets:
        """GROUP BY CUBE(k1, .., kn): all 2^n grouping sets, emitted in
        ascending grouping_id order."""
        names = [k if isinstance(k, str) else k.name for k in keys]
        n = len(names)
        sets = [tuple(names[i] for i in range(n)
                      if not (m >> (n - 1 - i)) & 1)
                for m in range(1 << n)]
        return GroupingSets(self, names, sets)

    def grouping_sets(self, sets, keys=None) -> GroupingSets:
        """GROUP BY GROUPING SETS(...): an explicit set list; `keys` fixes
        the output key order (default: first-appearance order)."""
        if keys is None:
            keys, seen = [], set()
            for s in sets:
                for k in s:
                    k = k if isinstance(k, str) else k.name
                    if k not in seen:
                        seen.add(k)
                        keys.append(k)
        return GroupingSets(self, list(keys), [tuple(s) for s in sets])

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL (columns by position, the left side's names)."""
        return self._wrap(L.LogicalUnion(self._plan, other._plan))

    def window(self, window_exprs, partition_by=(), order_by=()
               ) -> "DataFrame":
        """Append window function columns: window_exprs = (spec, name)
        pairs (plan/window.py specs)."""
        return self._wrap(L.LogicalWindow(list(window_exprs),
                                          list(partition_by),
                                          list(order_by), self._plan))

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        """mapInPandas: fn(iterator of pandas.DataFrame) -> iterator of
        pandas.DataFrame, run in a forked python worker (reference
        GpuMapInPandasExec).  `schema` is the result StructType (or a
        pyarrow Schema, where pyarrow imports)."""
        return self._wrap(L.LogicalMapInPandas(fn, result_struct(schema),
                                               self._plan))

    def with_pandas_udf(self, name: str, fn, input_cols, return_type
                        ) -> "DataFrame":
        """Append a scalar pandas UDF column: fn(pandas.Series...) ->
        pandas.Series (reference GpuArrowEvalPythonExec)."""
        return self._wrap(L.LogicalArrowEvalPython(
            [(fn, list(input_cols), name, return_type)], self._plan))

    def with_window_pandas_udf(self, name: str, fn, input_cols,
                               return_type, partition_by=(),
                               order_by=()) -> "DataFrame":
        """Append a pandas window-UDF column over unbounded partition
        frames: fn(partition Series...) -> Series of the partition's
        length, or one scalar to broadcast (reference
        GpuWindowInPandasExec)."""
        return self._wrap(L.LogicalWindowInPandas(
            list(partition_by), list(order_by),
            [(fn, list(input_cols), name, return_type)], self._plan))

    def agg(self, *aggs: Tuple[AggregateFunction, str]) -> "DataFrame":
        return GroupedData(self, ()).agg(*aggs)

    def sort(self, *orders) -> "DataFrame":
        return self._wrap(L.LogicalSort(list(orders), self._plan))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None) -> "DataFrame":
        if on is not None:
            keys = [on] if isinstance(on, str) else list(on)
            left_on = right_on = keys
        return self._wrap(L.LogicalJoin(how, self._plan, other._plan,
                                        left_on or [], right_on or []))

    def limit(self, n: int) -> "DataFrame":
        return self._wrap(L.LogicalLimit(n, self._plan))

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """Bernoulli sample: each row kept with probability `fraction`,
        by a hash of (seed, the row's position): the same rows for a
        seed as the reference keeps, on either device."""
        return self._wrap(L.LogicalSample(fraction, seed, self._plan))

    # -- actions -----------------------------------------------------------
    @property
    def schema(self) -> t.StructType:
        return self._plan.schema

    def physical(self) -> PhysicalQuery:
        return apply_overrides(self._plan, self._session.conf,
                               self._session.device)

    def collect(self) -> HostBatch:
        q = self.physical()
        return q.collect(ExecContext(q.conf, q.device))

    def to_pydict(self) -> dict:
        return self.collect().to_pydict()

    def count(self) -> int:
        """The number of rows (a global COUNT(*))."""
        from .plan.aggregates import Count
        res = self.agg((Count(None), "count")).collect()
        return int(res.columns[0].data[0])

    def explain(self) -> str:
        """Where each operator runs, in the reference's words (`*Exec
        <Filter> will run on TPU`, `!Exec <Project> cannot run on TPU
        because ...`), then the physical plan (the port's operators; the
        reference's names its JAX execs instead)."""
        q = self.physical()
        return q.explain() + "\n\nPhysical plan:\n" + q.physical_tree()

    def _wrap(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self._session)


# -- convenience constructors (pyspark.sql.functions analogue) -------------

def col(name: str) -> E.ColumnRef:
    return E.ColumnRef(name)


def lit(value, dtype: Optional[t.DataType] = None) -> E.Literal:
    return E.Literal(value, dtype)
