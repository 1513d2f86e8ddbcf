"""User-facing session + DataFrame API.

Counterpart of spark_rapids_tpu/session.py for what the ported TPC-H
queries use (`how="cross"` joins included):

    s = TpuSession()                     # device "cuda"
    df = s.from_host(batch).filter(E.GreaterThan(col("x"), lit(1))) \\
         .group_by("k").agg((Sum(col("x")), "sx")).sort("k")
    df.collect()                         # HostBatch (numpy columns)

`TpuSession(conf=None, device=None)`: None means "cuda", and the
constructor raises when no CUDA device is present — nothing carries on
on the CPU by itself.  `device="cpu"` runs the same plan on CPU tensors,
where every kernel wrapper takes its plain PyTorch version (the tests
do this).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import types as t
from .columnar.device import resolve_device
from .columnar.host import HostBatch, from_arrow
from .config import TpuConf
from .exec.plan import ExecContext
from .plan import expressions as E
from .plan import logical as L
from .plan.aggregates import AggregateFunction
from .plan.overrides import PhysicalQuery, apply_overrides


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


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence):
        self._df = df
        self._keys = list(keys)

    def agg(self, *aggs: Tuple[AggregateFunction, str]) -> "DataFrame":
        return DataFrame(
            L.LogicalAggregate(self._keys, list(aggs), self._df._plan),
            self._df._session)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: TpuSession):
        self._plan = plan
        self._session = session

    # -- transformations ---------------------------------------------------
    def select(self, *exprs, names: Optional[Sequence[str]] = None
               ) -> "DataFrame":
        return self._wrap(L.LogicalProject(list(exprs), self._plan, names))

    def filter(self, condition) -> "DataFrame":
        return self._wrap(L.LogicalFilter(condition, self._plan))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, keys)

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

    def _wrap(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self._session)


# -- convenience constructors (pyspark.sql.functions analogue) -------------

def col(name: str) -> E.ColumnRef:
    return E.ColumnRef(name)


def lit(value, dtype: Optional[t.DataType] = None) -> E.Literal:
    return E.Literal(value, dtype)
