"""Physical plan nodes producing streams of device batches.

Counterpart of spark_rapids_tpu/exec/plan.py: each exec pulls an
iterator of batches from its child and pushes transformed batches
downstream (the reference's `GpuExec.internalDoExecuteColumnar` shape).
Expressions arrive already bound to the child's schema.

The nodes TPC-H q1, q3 and q6 run: the host scan, project, filter
(fused into an aggregate's or a join's masks when one sits above it,
else compacting), hash aggregate, sort, limit and top-N.  The joins
(hash and cross) are in exec/join.py and exec/adaptive.py.

Plan statistics ride the nodes as in the reference: `column_range`
(exact integer bounds, which let group keys pack) and `keys_unique`
(distinct key tuples, which let a join take the probe-aligned path)
and `static_row_count` (a global aggregate's one row, which lets a cross
join broadcast it).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn,
                               empty_device_batch, fetch_result_batch,
                               resolve_device, to_device)
from ..columnar.host import HostBatch, HostColumn, concat_host
from ..config import DEFAULT_CONF, TpuConf
from ..ops.batch_ops import concat_batches, shrink_to_capacity
from ..plan import expressions as E
from ..plan.aggregates import AggregateFunction
from .aggregate import HashAggregate
from .evaluator import compute_predicate, evaluate_projection


@dataclasses.dataclass
class ExecContext:
    """Per-query execution state threaded through the plan.  `device`
    None means "cuda" and raises without a card (`resolve_device`)."""
    conf: TpuConf = DEFAULT_CONF
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)


def _key_ref_name(e: E.Expression) -> Optional[str]:
    inner = e.children[0] if isinstance(e, E.Alias) else e
    return inner.name if isinstance(inner, E.ColumnRef) else None


def key_ref_names(exprs) -> Optional[List[str]]:
    """Column names when every expression is a plain (possibly aliased)
    column reference, else None."""
    names = [_key_ref_name(e) for e in exprs]
    return None if None in names else names


def peel_filters(node: "PlanNode"):
    """(batch source, conditions outermost-last) of the FilterExec chain
    under an aggregate or a join, which fuse the predicates into their
    masks instead of compacting."""
    conds: List[E.Expression] = []
    while isinstance(node, FilterExec):
        conds.append(node.condition)
        node = node.child
    conds.reverse()
    return node, conds


class PlanNode:
    """Base physical operator. Children first, Spark-style."""

    def __init__(self, *children: "PlanNode"):
        self.children = list(children)

    @property
    def child(self) -> "PlanNode":
        return self.children[0]

    @property
    def output_schema(self) -> t.StructType:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def column_range(self, name: str) -> Optional[Tuple[int, int]]:
        """Exact (min, max) of a column's integer lane when known from
        scan statistics, else None (lets bounded integer keys pack)."""
        return None

    def keys_unique(self, names: Sequence[str]) -> bool:
        """True if no two live rows can carry equal NON-NULL values in the
        named column tuple (a unique build side makes a join's output
        probe-aligned).  Conservative default: unknown -> False."""
        return False

    def static_row_count(self) -> Optional[int]:
        """Exact output row count when statically known (a global
        aggregate emits exactly one row), else None: a cross join
        against a scalar subquery then needs no host sync."""
        return None

    def collect(self, ctx: Optional[ExecContext] = None) -> HostBatch:
        """Run the plan and bring the results' live rows to the host."""
        ctx = ctx or ExecContext()
        hbs = []
        for db in self.execute(ctx):
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            hb = fetch_result_batch(db, conf=ctx.conf)
            if hb.num_rows:
                hbs.append(hb)
        if not hbs:
            schema = self.output_schema
            return HostBatch([HostColumn(
                np.zeros(0, t.physical_np_dtype(f.data_type)), None,
                f.data_type, np.array([], str)
                if isinstance(f.data_type, t.StringType) else None)
                for f in schema.fields], schema.names)
        return concat_host(hbs)


class HostScanExec(PlanNode):
    """Leaf: uploads host batches of at most `batch_rows` rows to the
    device (HostColumnarToGpu role)."""

    def __init__(self, table: HostBatch, batch_rows: int):
        super().__init__()
        self.table = table
        self.batch_rows = batch_rows

    @property
    def output_schema(self) -> t.StructType:
        return self.table.schema

    def column_range(self, name):
        return self.table.column_range(name) \
            if name in self.table.names else None

    def keys_unique(self, names):
        if not names or any(n not in self.table.names for n in names):
            return False
        return self.table.keys_unique(names)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        n = self.table.num_rows
        for off in range(0, max(n, 1), self.batch_rows):
            hb = self.table.slice(off, min(self.batch_rows, n - off))
            yield to_device(hb, ctx.conf, device=ctx.device)


class ProjectExec(PlanNode):
    def __init__(self, exprs: Sequence[E.Expression], names: Sequence[str],
                 child: PlanNode):
        super().__init__(child)
        self.exprs = [e.bind(child.output_schema) for e in exprs]
        self.names = list(names)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType([t.StructField(n, e.dtype)
                             for n, e in zip(self.names, self.exprs)])

    def column_range(self, name):
        if name not in self.names:
            return None
        ref = _key_ref_name(self.exprs[self.names.index(name)])
        return None if ref is None else self.child.column_range(ref)

    def keys_unique(self, names):
        # renames and pass-throughs map to the child's columns
        if any(n not in self.names for n in names):
            return False
        mapped = key_ref_names([self.exprs[self.names.index(n)]
                                for n in names])
        return mapped is not None and self.child.keys_unique(mapped)

    def static_row_count(self):
        return self.child.static_row_count()   # projection keeps rows

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for db in self.child.execute(ctx):
            yield evaluate_projection(self.exprs, self.names, db, ctx.conf)


class FilterExec(PlanNode):
    """GpuFilterExec: the predicate as a keep mask, then a stable mask
    compaction (ops/filter.compact_batch).  An aggregate or a join right
    above peels it into its own masks instead, and nothing compacts."""

    def __init__(self, condition: E.Expression, child: PlanNode):
        super().__init__(child)
        self.condition = condition.bind(child.output_schema)

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def column_range(self, name):
        return self.child.column_range(name)   # subset of values

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # subset of rows

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.filter import compact_batch
        for db in self.child.execute(ctx):
            keep = compute_predicate(self.condition, db, ctx.conf)
            # lazy row count: downstream device ops run sync-free
            yield compact_batch(db, keep, ctx.conf)


class HashAggregateExec(PlanNode):
    """GpuHashAggregateExec: streaming partial aggregation per batch,
    concat+merge regroup, final projection."""

    def __init__(self, key_exprs: Sequence[E.Expression],
                 key_names: Sequence[str],
                 aggs: Sequence[Tuple[AggregateFunction, str]],
                 child: PlanNode):
        super().__init__(child)
        schema = child.output_schema
        self.key_exprs = [e.bind(schema) for e in key_exprs]
        self.key_names = list(key_names)
        self.aggs = [(fn.bind(schema), name) for fn, name in aggs]

    @property
    def output_schema(self) -> t.StructType:
        fields = [t.StructField(n, e.dtype)
                  for n, e in zip(self.key_names, self.key_exprs)]
        fields += [t.StructField(n, fn.dtype) for fn, n in self.aggs]
        return t.StructType(fields)

    def column_range(self, name):
        if name in self.key_names:
            ref = _key_ref_name(self.key_exprs[self.key_names.index(name)])
            return None if ref is None else self.child.column_range(ref)
        return None

    def keys_unique(self, names):
        # the group-key tuple is unique by construction, and so is any
        # superset of it; a global aggregate has exactly one row
        return not self.key_exprs or set(self.key_names) <= set(names)

    def static_row_count(self) -> Optional[int]:
        return 1 if not self.key_exprs else None

    def _key_ranges(self):
        out = []
        for e in self.key_exprs:
            ref = _key_ref_name(e)
            out.append(None if ref is None else self.child.column_range(ref))
        return out

    def _aggregate(self, ctx: ExecContext) -> HashAggregate:
        return HashAggregate(self.key_exprs, self.key_names, self.aggs,
                             ctx.conf, key_ranges=self._key_ranges())

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        agg = self._aggregate(ctx)
        # upstream filters become the group-by's live mask: filter,
        # projections and update aggregation run with no compaction
        source, conds = peel_filters(self.child)
        partials: List[DeviceBatch] = []
        for db in source.execute(ctx):
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            partials.append(agg.partial_fused(db, conds))
            # bound the pending set: merge when the partials would
            # overflow one target batch (tryMergeAggregatedBatches)
            if len(partials) > 1 and sum(p.capacity for p in partials) > \
                    ctx.conf.batch_size_rows:
                partials = [agg.merge(partials)]
        if not partials:
            if self.key_exprs:
                return  # grouped agg over empty input -> no rows
            # global agg over empty input still emits one row (COUNT=0)
            partials = [agg.partial(empty_device_batch(
                source.output_schema, ctx.conf, ctx.device))]
        merged = agg.merge(partials) if len(partials) > 1 else partials[0]
        yield agg.final(merged)

    def collect(self, ctx: Optional[ExecContext] = None) -> HostBatch:
        """Global (no-key) aggregations merge the per-batch buffer
        scalars on the device and finish with one 1-row final
        projection; grouped ones collect like any plan."""
        if self.key_exprs:
            return super().collect(ctx)
        ctx = ctx or ExecContext()
        agg = self._aggregate(ctx)
        source, conds = peel_filters(self.child)
        raw = [agg.partial_fused(db, conds, raw=True)
               for db in source.execute(ctx)
               if not (isinstance(db.num_rows, int) and db.num_rows == 0)]
        if not raw:
            raw = [agg.partial_fused(empty_device_batch(
                source.output_schema, ctx.conf, ctx.device), conds,
                raw=True)]
        final = agg.final(agg._reduce_outs_to_batch(agg.merge_raw(raw)))
        return fetch_result_batch(final, 1, ctx.conf)


class SortExec(PlanNode):
    """GpuSortExec: sorts by SortOrder keys.  A multi-batch input
    concatenates first (the reference's out-of-core sorter ports with
    the OOC slice)."""

    def __init__(self, keys, child: PlanNode):
        from ..ops.sort import SortKey
        super().__init__(child)
        self.keys = [k if isinstance(k, SortKey) else SortKey(*k)
                     for k in keys]

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def column_range(self, name):
        return self.child.column_range(name)

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # permutation of rows

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.sort import sort_batch
        batches = list(self.child.execute(ctx))
        if not batches:
            return
        yield sort_batch(concat_batches(batches, ctx.conf), self.keys,
                         ctx.conf)


def _truncate(db: DeviceBatch, rows) -> DeviceBatch:
    """The first `rows` rows (a host int or a 0-d device tensor) live,
    the rest padding."""
    from ..ops.kernels import live_mask
    live = live_mask(db.capacity, rows, db.device)
    cols = [DeviceColumn(c.data, c.validity & live, c.dtype, c.dictionary)
            for c in db.columns]
    return DeviceBatch(cols, rows, list(db.names))


class LimitExec(PlanNode):
    """GpuLocalLimitExec and GpuGlobalLimitExec in one: the port runs one
    partition, so the global cut is the local one.  Never pulls a batch
    it does not need; a lazy count costs one scalar sync, and the cut
    batch shrinks to the limit's bucket so a tiny LIMIT never fetches a
    full capacity."""

    def __init__(self, limit: int, child: PlanNode):
        super().__init__(child)
        self.limit = limit

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def column_range(self, name):
        return self.child.column_range(name)

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # prefix of rows

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        remaining = self.limit
        for db in self.child.execute(ctx):
            if remaining <= 0:
                return
            n = int(db.num_rows)
            if n == 0:
                continue
            if n < remaining:
                remaining -= n
                yield db
            else:
                yield shrink_to_capacity(_truncate(db, remaining),
                                         remaining, ctx.conf)
                return


class TopNExec(PlanNode):
    """GpuTopN: sort + limit without materializing the full sorted
    output — each batch keeps its top-N prefix, pending rows re-sort
    with the next batch and are cut again.  The sorts are stable, so
    ties keep their input order (an aggregate's ascending group order)."""

    def __init__(self, limit: int, keys, child: PlanNode):
        from ..ops.sort import SortKey
        super().__init__(child)
        self.limit = limit
        self.keys = [k if isinstance(k, SortKey) else SortKey(*k)
                     for k in keys]

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def column_range(self, name):
        return self.child.column_range(name)

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # prefix of a permutation

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.sort import sort_batch
        pending: Optional[DeviceBatch] = None
        for db in self.child.execute(ctx):
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            batch = db if pending is None \
                else concat_batches([pending, db], ctx.conf)
            s = sort_batch(batch, self.keys, ctx.conf)
            # lazy cut + static capacity shrink: live rows <= limit by
            # construction, so the bucket slice needs no count sync
            n = s.num_rows
            n = torch.clamp(n, max=self.limit) \
                if isinstance(n, torch.Tensor) else min(n, self.limit)
            pending = shrink_to_capacity(_truncate(s, n), self.limit,
                                         ctx.conf)
        if pending is not None:
            yield pending
