"""Physical plan nodes producing streams of device batches.

Counterpart of spark_rapids_tpu/exec/plan.py: each exec pulls an
iterator of batches from its child and pushes transformed batches
downstream (the reference's `GpuExec.internalDoExecuteColumnar` shape).
Expressions arrive already bound to the child's schema.

The nodes the TPC-H and TPC-DS queries run: the host scan, project,
filter (fused into an aggregate's or a join's masks when one sits above
it, else compacting), hash aggregate, sort, limit, top-N, union and
expand; and the range generator, the Bernoulli sample and the batch
coalescer.  The joins (hash and cross) are in exec/join.py and
exec/adaptive.py, the window in exec/window.py.

A union streams its children's batches as they come, each with its own
string dictionaries (three sales channels scan three dictionaries of one
column); whatever combines batches unifies them: the aggregate's merge,
the sort, top-N, the window and a join's build (ops/batch_ops
`concat_batches`), and a join's probe, whose string keys remap into the
build's dictionary.

Plan statistics ride the nodes as in the reference: `column_range`
(exact integer bounds, which let group keys pack) and `keys_unique`
(distinct key tuples, which let a join take the probe-aligned path)
and `static_row_count` (a global aggregate's one row, which lets a cross
join broadcast it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
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
from ..plan.aggregates import AggregateFunction, Min
from ..plan.misc import reset_ordinals
from ..runtime.retry import retry_io
from ..runtime.capture import capturing, host_constant, recording
from .aggregate import HashAggregate
from .evaluator import compute_predicate, evaluate_projection, project_batch


class QueryDeadlineExceeded(RuntimeError):
    """The query ran past its deadline (`ExecContext.deadline`) and a
    cancellation checkpoint cancelled it.  Classified 'query': every
    reservation its budget held is released as the scopes unwind."""


class InjectedDeadlineExceeded(QueryDeadlineExceeded):
    """Chaos-harness form (`deadline:timeout:...`, runtime/faults.py): a
    synthetic deadline expiry at the Nth checkpoint."""


class QueryCancelled(QueryDeadlineExceeded):
    """Cooperative cancellation (the `ExecContext.cancel` event set)."""


#: the context of the query running on this thread (`query_scope`), for
#: work that has no ExecContext in reach (the kernel elections)
_TLS_CTX = threading.local()


@contextlib.contextmanager
def query_scope(ctx: "ExecContext"):
    """Register `ctx` as this thread's running query for the scope."""
    prev = getattr(_TLS_CTX, "ctx", None)
    _TLS_CTX.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS_CTX.ctx = prev


def active_context() -> Optional["ExecContext"]:
    """The ExecContext of the query running on this thread, or None."""
    return getattr(_TLS_CTX, "ctx", None)


#: id(leaf) -> the batches a whole-plan capture runs the leaf over, on
#: this thread (exec/compiled.py; a background capture of another
#: segment runs the same tree on another thread)
_TLS_TRACE = threading.local()


def set_trace_batches(batches: Optional[dict]) -> None:
    """Install (or clear, with None) this thread's leaf batches."""
    _TLS_TRACE.batches = batches


def trace_batches(node: "PlanNode"):
    """The batches a capture on this thread runs `node` over, or None."""
    m = getattr(_TLS_TRACE, "batches", None)
    return None if m is None else m.get(id(node))


@dataclasses.dataclass
class ExecContext:
    """Per-query execution state threaded through the plan.  `device`
    None means "cuda" and raises without a card (`resolve_device`).

    `metrics` holds the query's counters (`bump`): the out-of-core
    tier's elections, partitions and passes (exec/ooc.py), the
    fallbacks `join_subpartition_fallbacks` and
    `agg_repartition_fallbacks`, the query rungs'
    `query_ooc_escalations` and `query_oom_replays`, the kernel sheds
    `kernel_fallback.<kernel>.oom`, `semaphore_wait_ms` and, after an
    allocator OOM, `query_budget_rebased_bytes`.
    `ooc_force` is set by the query-level OOM ladder
    (plan/overrides.py, exec/ooc.escalate): every eligible join and
    aggregation then runs out of core.  `deadline` (an absolute
    time.monotonic(), 0 for none) and `cancel` (a threading.Event) are
    read at each `checkpoint`."""
    conf: TpuConf = DEFAULT_CONF
    device: Optional[torch.device] = None
    metrics: dict = dataclasses.field(default_factory=dict)
    ooc_force: bool = False
    _budget: object = None
    #: a shared subtree's output for its readers (`HashAggregateExec`
    #: with `shared_readers` > 1): id(node) -> [spillables, readers left]
    shared: dict = dataclasses.field(default_factory=dict)
    deadline: float = 0.0
    cancel: object = None
    #: the query's pandas execs with a worker alive, which share one
    #: python-worker permit (exec/python_exec._query_permit)
    python_permit_depth: int = 0
    #: the queries run on this context that hold its device permit: a
    #: query nested in another (a cache's first materialization) shares
    #: the permit of the one it runs in (runtime/semaphore.query_permit)
    device_permit_depth: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def checkpoint(self, bracket: str = "") -> None:
        """Cooperative cancellation checkpoint (each result batch, each
        out-of-core pass): fires the `deadline` chaos site, then raises
        QueryCancelled / QueryDeadlineExceeded when the cancel event is
        set or the deadline has passed."""
        from ..runtime.faults import get_injector
        inj = get_injector(self.conf)
        if inj.enabled:
            inj.fire("deadline", bracket=bracket or "?")
        if self.cancel is not None and self.cancel.is_set():
            self.bump("deadline_checkpoints_cancelled")
            raise QueryCancelled(
                f"query cancelled at the {bracket or '?'} checkpoint")
        if self.deadline and time.monotonic() > self.deadline:
            self.bump("deadline_checkpoints_cancelled")
            raise QueryDeadlineExceeded(
                f"query deadline exceeded at the {bracket or '?'} "
                "checkpoint")

    @property
    def budget(self):
        """The query's device-memory budget (runtime/memory.py), built on
        first use from the conf and the device."""
        if self._budget is None:
            from ..runtime.memory import MemoryBudget
            self._budget = MemoryBudget(self.conf, self.device)
        return self._budget

    def bump(self, name: str, n: int = 1):
        self.metrics[name] = self.metrics.get(name, 0) + n


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

    def describe(self) -> str:
        """One line of `tree_string`: the operator's name."""
        return type(self).__name__

    def tree_string(self, depth: int = 0) -> str:
        """The physical tree, one operator a line, children indented."""
        return "\n".join(["  " * depth + self.describe()] +
                         [c.tree_string(depth + 1) for c in self.children])

    def collect(self, ctx: Optional[ExecContext] = None) -> HostBatch:
        """Run the plan and bring the results' live rows to the host."""
        ctx = ctx or ExecContext()
        hbs = []
        for db in self.execute(ctx):
            ctx.checkpoint("batch")
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            hb = retry_io(ctx.conf, "d2h",
                          lambda: fetch_result_batch(db, conf=ctx.conf))
            if hb.num_rows:
                hbs.append(hb)
        if not hbs:
            return empty_host_batch(self.output_schema)
        return concat_host(hbs)


def empty_host_batch(schema: t.StructType) -> HostBatch:
    """A zero-row result of `schema`."""
    return HostBatch([HostColumn(
        np.zeros(0, t.physical_np_dtype(f.data_type)), None, f.data_type,
        np.array([], str) if isinstance(f.data_type, t.StringType)
        else None) for f in schema.fields], schema.names)


class HostScanExec(PlanNode):
    """Leaf: uploads host batches of at most `batch_rows` rows to the
    device (HostColumnarToGpu role).  The columns named in
    `encoded_cols` (plan/overrides negotiate_encoded, under
    `sql.encoded.narrow.lanes`) upload FOR-narrowed where a batch's live
    values fit a narrower signed dtype (columnar/device.narrowed_lane)."""

    def __init__(self, table: HostBatch, batch_rows: int):
        super().__init__()
        self.table = table
        self.batch_rows = batch_rows
        self.encoded_cols = None
        #: the shared scan upload a compiled plan read (exec/compiled.py)
        self._device_cache = None

    @property
    def _source_table(self) -> HostBatch:
        """The source table's identity (a pruned scan's `table` is a
        select of it)."""
        return self.table.source

    def host_batches(self):
        """(offset, rows, host batch) of each batch the scan uploads."""
        n = self.table.num_rows
        for off in range(0, max(n, 1), self.batch_rows):
            rows = min(self.batch_rows, n - off)
            yield off, rows, self.table.slice(off, rows)

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
        from ..columnar.device import narrowed_lane
        traced = trace_batches(self)
        if traced is not None:
            yield from traced
            return
        enc = [(i, name) for i, name in enumerate(self.table.names)
               if self.encoded_cols is not None and
               name in self.encoded_cols]
        for off, rows, hb in self.host_batches():
            narrowed = {i: lane for i, lane in (
                (i, narrowed_lane(self.table, name, off, rows))
                for i, name in enc) if lane is not None}
            yield retry_io(ctx.conf, "h2d",
                           lambda: to_device(hb, ctx.conf, device=ctx.device,
                                             narrowed=narrowed))


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
        reset_ordinals(self.exprs)
        for db in self.child.execute(ctx):
            yield project_batch(self.exprs, self.names, db, ctx.conf)


class FilterExec(PlanNode):
    """GpuFilterExec: the predicate as a keep mask, then a stable mask
    compaction (ops/filter.compact_batch).  An aggregate or a join right
    above peels it into its own masks instead, and nothing compacts.  A
    thin input (columnar/lanes.py) materializes the deferred columns the
    predicate reads, and the mask becomes its selection vector: the
    lanes stay live to the pipeline's sink."""

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
            if db.thin is not None:
                from ..columnar.lanes import materialize_refs
                db = materialize_refs(db, [self.condition], ctx.conf)
            keep = compute_predicate(self.condition, db, ctx.conf)
            if db.thin is not None:
                yield DeviceBatch(list(db.columns),
                                  keep.sum(dtype=torch.int32),
                                  list(db.names), keep, db.thin,
                                  db.origin_file)
                continue
            # lazy row count: downstream device ops run sync-free
            yield compact_batch(db, keep, ctx.conf)


class HashAggregateExec(PlanNode):
    """GpuHashAggregateExec: streaming partial aggregation per batch,
    concat+merge regroup, final projection.

    An aggregate that several parents read (plan/overrides
    `dedupe_agg_twins` sets `shared_readers`) runs once per query: the
    first reader runs it and holds its output batches in the ExecContext
    as spillables of runtime/memory.py, every reader reads them, and the
    last one to finish releases them."""

    #: parents that read this node (plan/overrides.dedupe_agg_twins)
    shared_readers = 1

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
        # MIN and MAX (a Min) select existing values: a plain column's
        # range bounds them (q2 joins on its MIN(ps_supplycost))
        for fn, out_name in self.aggs:
            if out_name == name and isinstance(fn, Min):
                ref = _key_ref_name(fn.child)
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

    def describe(self) -> str:
        if self.shared_readers > 1:
            return f"HashAggregateExec[shared by {self.shared_readers}]"
        return "HashAggregateExec"

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        if self.shared_readers < 2:
            yield from self._execute(ctx)
            return
        from ..runtime.memory import Spillable
        entry = ctx.shared.get(id(self))
        if entry is None:
            held = [Spillable(db, ctx.budget) for db in self._execute(ctx)]
            entry = ctx.shared[id(self)] = [held, self.shared_readers]
            ctx.bump("shared_subtree_runs")
        try:
            for sp in entry[0]:
                yield sp.get()
        finally:
            entry[1] -= 1
            if entry[1] == 0:
                for sp in entry[0]:
                    sp.close()
                del ctx.shared[id(self)]

    def _execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..config import AGG_FALLBACK_PARTITIONS
        from . import ooc as O
        from .ooc_agg import OutOfCoreAggregator
        agg = self._aggregate(ctx)
        # upstream filters become the group-by's live mask: filter,
        # projections and update aggregation run with no compaction
        source, conds = peel_filters(self.child)
        policy = O.ooc_policy(ctx)
        partials: List[DeviceBatch] = []
        partial_bytes = 0
        oocagg: Optional[OutOfCoreAggregator] = None

        def start_ooc(mode: str) -> OutOfCoreAggregator:
            k = max(ctx.conf.get(AGG_FALLBACK_PARTITIONS),
                    O.partition_count(partial_bytes, policy))
            ctx.bump("agg_repartition_fallbacks")
            O.record_election(ctx, "agg", mode)
            return OutOfCoreAggregator(agg, len(self.key_names), ctx,
                                       policy, k)

        for db in source.execute(ctx):
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            # a sink of thin join output: the deferred columns the keys,
            # inputs and fused filters read materialize here; a selection
            # vector is the group-by's live mask (`row_mask`)
            db = agg.materialize_inputs(db, conds)
            p = agg.partial_fused(db, conds)
            if oocagg is not None:
                oocagg.add(p)
                continue
            partials.append(p)
            partial_bytes += O.batch_bytes(p)
            # the byte gate, or a forced context: the partials' working
            # set exceeds the resident window, so spill-partition by key
            # now (key-disjoint buckets make the union exact)
            if self.key_exprs and \
                    (policy.force or policy.bytes_trip(partial_bytes)):
                oocagg = start_ooc("forced" if policy.force else "bytes")
                for q in partials:
                    oocagg.add(q)
                partials = []
                continue
            # bound the pending set: merge when the partials would
            # overflow one target batch (tryMergeAggregatedBatches).  A
            # capture merges only partials that a static bound (the key
            # domain) keeps below one target batch, as the eager shrink
            # does; others merge once at the end, since a merged partial
            # keeps its static capacity and re-merging would double it
            target = ctx.conf.batch_size_rows
            if len(partials) > 1 and \
                    sum(p.capacity for p in partials) > target and \
                    (not capturing() or
                     all(p.capacity < target for p in partials)):
                merged = agg.merge(partials)
                if self.key_exprs and \
                        isinstance(merged.num_rows, int) and \
                        merged.num_rows > ctx.conf.batch_size_rows:
                    # the high-cardinality fallback: merging no longer
                    # reduces below one target batch, so hash-split the
                    # groups into independently merged buckets
                    oocagg = start_ooc("rows")
                    oocagg.add(merged)
                    partials = []
                else:
                    partials = [merged]
                    partial_bytes = O.batch_bytes(merged)
        if oocagg is not None:
            # results() owns the cleanup sweep, so a LIMIT above this
            # aggregation leaks no spill files
            yield from oocagg.results()
            return
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
        scalars on the device and finish on the host from the fetched
        buffers (the reference's `final_host`); grouped ones collect like
        any plan."""
        if self.key_exprs:
            return super().collect(ctx)
        ctx = ctx or ExecContext()
        agg = self._aggregate(ctx)
        source, conds = peel_filters(self.child)
        raw = [agg.partial_fused(agg.materialize_inputs(db, conds), conds,
                                 raw=True)
               for db in source.execute(ctx)
               if not (isinstance(db.num_rows, int) and db.num_rows == 0)]
        if not raw:
            raw = [agg.partial_fused(empty_device_batch(
                source.output_schema, ctx.conf, ctx.device), conds,
                raw=True)]
        merged = agg.merge_raw(raw)
        # the one result batch: the root's per-batch fault sites
        # (runtime/failure.install_fault_injection), the checkpoint and
        # the fetch's retry, as PlanNode.collect gives every other root
        tick = getattr(self, "_fault_tick", None)
        if tick is not None:
            tick()
        ctx.checkpoint("batch")
        return retry_io(ctx.conf, "d2h", lambda: agg.final_host(*merged))


_U32 = 0xFFFFFFFF


def _agg_partition_ids(pb: DeviceBatch, nkeys: int, num_buckets: int,
                       salt: int = 0) -> torch.Tensor:
    """int32 bucket id per row from the leading `nkeys` columns,
    bit-equal to the reference's (spark_rapids_tpu/exec/plan.py).

    Equal keys map to equal buckets across batches and sides: a string
    key hashes the crc32 of its dictionary VALUE (per-batch codes are
    not stable), a DOUBLE key a value-derived lane (never its storage
    bits), any other key its int64 value folded to 32 bits.  `salt`
    decorrelates a recursive re-scatter, which the same hash would map
    onto itself.  The reference folds in wrapping uint32; PyTorch has no
    uint32 arithmetic on CUDA, so the fold runs in int64 masked to 32
    bits after every multiply and xor (a wrapping int64 product keeps
    the low 32 bits; `>>` of an int64 is arithmetic in both packages,
    and of a masked lane a logical shift)."""
    dev = pb.device
    salt_c = (salt * 0x9E3779B9) & _U32
    h = torch.full((pb.capacity,), 17, dtype=torch.int64, device=dev)
    for c in pb.columns[:nkeys]:
        d = c.data
        if c.dictionary is not None:
            tab = _dict_crc_table(c.dictionary, dev)
            lane = tab[torch.clamp(d.to(torch.int64), 0, tab.shape[0] - 1)]
        elif isinstance(c.dtype, (t.DoubleType, t.FloatType)):
            f = d.to(torch.float64)
            isnan = torch.isnan(f)
            isinf = torch.isinf(f)
            safe = torch.where(isnan | isinf, torch.zeros_like(f), f)
            ip = torch.floor(safe)
            fr = ((safe - ip) * float(1 << 30)).to(torch.int64)
            ii = torch.clamp(ip, -2.0 ** 62, 2.0 ** 62).to(torch.int64)
            lane = ((((ii ^ (ii >> 32)) & _U32) * 31) & _U32) ^ fr
            lane = torch.where(isnan, torch.full_like(lane, 0xA5A5A5A5),
                               lane)
            lane = torch.where(isinf & (f > 0),
                               torch.full_like(lane, 0x77777777), lane)
            lane = torch.where(isinf & (f < 0),
                               torch.full_like(lane, 0x33333333), lane)
        else:
            x = d.to(torch.int64)
            lane = (x ^ (x >> 32)) & _U32
        lane = torch.where(c.validity, lane,
                           torch.full_like(lane, 0x9E3779B9))
        # XOR-salt each lane: an additive salt would only rotate bucket
        # labels, leaving a re-scatter's groupings unchanged
        h = (h * 2654435761 + (lane ^ salt_c)) & _U32
    # avalanche, so the low bits (the modulo) see every input bit
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    return (h % num_buckets).to(torch.int32)


_CRC_TABLE_CACHE: dict = {}


def _dict_crc_table(dictionary: np.ndarray, device: torch.device
                    ) -> torch.Tensor:
    """crc32 of each dictionary value (UTF-8) as an int64 tensor, padded
    to a power of two as the reference's table is; cached by dictionary
    identity and device (every batch of a scan shares its dictionary)."""
    import zlib
    key = (id(dictionary), str(device))
    hit = _CRC_TABLE_CACHE.get(key)
    if hit is not None and hit[0] is dictionary:
        return hit[1]
    ent = [zlib.crc32(str(v).encode("utf-8")) for v in dictionary] or [0]
    ent += [0] * ((1 << (len(ent) - 1).bit_length()) - len(ent))
    tab = host_constant(np.asarray(ent, np.int64), device)
    if recording():
        return tab                # filled only by the graph's replays
    if len(_CRC_TABLE_CACHE) > 512:
        _CRC_TABLE_CACHE.clear()
    # pin the dictionary so its id stays valid while cached
    _CRC_TABLE_CACHE[key] = (dictionary, tab)
    return tab


class SortExec(PlanNode):
    """GpuSortExec: sorts by SortOrder keys.  A single batch sorts
    directly; from the second batch on the input goes through the
    out-of-core sorter (exec/ooc_sort.py): spillable sorted runs under a
    budget, one concatenated sort without one."""

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
        from .ooc_sort import OutOfCoreSorter
        it = self.child.execute(ctx)
        first = next(it, None)
        if first is None:
            return
        second = next(it, None)
        if second is None:
            yield sort_batch(first, self.keys, ctx.conf)
            return
        sorter = OutOfCoreSorter(self.keys, ctx)
        for db in itertools.chain((first, second), it):
            sorter.add(db)
        yield from sorter.results()


def _truncate(db: DeviceBatch, rows) -> DeviceBatch:
    """The first `rows` rows (a host int or a 0-d device tensor) live,
    the rest padding."""
    from ..ops.kernels import live_mask
    live = live_mask(db.capacity, rows, db.device)
    cols = [DeviceColumn(c.data, c.validity & live, c.dtype, c.dictionary,
                         None, c.hi, c.offsets, c.elem_valid)
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
        from ..ops.batch_ops import ensure_prefix
        remaining = self.limit
        for db in self.child.execute(ctx):
            if remaining <= 0:
                return
            db = ensure_prefix(db, ctx.conf)     # a limit cuts a prefix
            db.assert_prefix()
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


class UnionExec(PlanNode):
    """GpuUnionExec: the children's streams one after the other
    (schema-aligned by position; the first child's names)."""

    def __init__(self, *children: PlanNode):
        super().__init__(*children)

    @property
    def output_schema(self) -> t.StructType:
        return self.children[0].output_schema

    def column_range(self, name):
        # the children's columns at the same position
        names = self.output_schema.names
        if name not in names:
            return None
        i = names.index(name)
        rngs = [c.column_range(c.output_schema.names[i])
                for c in self.children]
        if any(r is None for r in rngs):
            return None
        return (min(r[0] for r in rngs), max(r[1] for r in rngs))

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.batch_ops import ensure_prefix
        names = list(self.output_schema.names)
        for c in self.children:
            for db in c.execute(ctx):
                db = ensure_prefix(db, ctx.conf)
                yield DeviceBatch(db.columns, db.num_rows, names)


class ExpandExec(PlanNode):
    """GpuExpandExec: every input batch once through each projection
    (the rollup / cube / grouping-sets lowering)."""

    def __init__(self, projections: Sequence[Sequence[E.Expression]],
                 names: Sequence[str], child: PlanNode):
        super().__init__(child)
        self.projections = [[e.bind(child.output_schema) for e in p]
                            for p in projections]
        self.names = list(names)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType([t.StructField(n, e.dtype) for n, e in
                             zip(self.names, self.projections[0])])

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.batch_ops import ensure_prefix
        for db in self.child.execute(ctx):
            # a sink of thin join output: one resolve for every projection
            db = ensure_prefix(db, ctx.conf)
            for proj in self.projections:
                yield evaluate_projection(proj, self.names, db, ctx.conf)


class RangeExec(PlanNode):
    """GpuRangeExec: the LONG ids start, start + step, ... (below end, or
    above it for a negative step) made on the device, in batches of at
    most `batch_rows` (default `sql.batchSizeRows`) rows."""

    def __init__(self, start: int, end: int, step: int = 1,
                 name: str = "id", batch_rows: Optional[int] = None):
        super().__init__()
        assert step != 0
        self.start, self.end, self.step = start, end, step
        self.col_name = name
        self.batch_rows = batch_rows

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType([t.StructField(self.col_name, t.LONG, False)])

    def keys_unique(self, names):
        return list(names) == [self.col_name]   # the ids never repeat

    def describe(self):
        return f"RangeExec[{self.start}, {self.end}, {self.step}]"

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..columnar.device import bucket_capacity
        from ..ops.kernels import live_mask
        total = max(0, -(-(self.end - self.start) // self.step))
        chunk = self.batch_rows or ctx.conf.batch_size_rows
        for emitted in range(0, total, chunk):
            n = min(chunk, total - emitted)
            cap = bucket_capacity(n, ctx.conf)
            base = self.start + emitted * self.step
            data = torch.arange(cap, dtype=torch.int64,
                                device=ctx.device) * self.step + base
            yield DeviceBatch([DeviceColumn(
                data, live_mask(cap, n, ctx.device), t.LONG)], n,
                [self.col_name])


def sample_hash_u32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """The reference's murmur3 finalizer over a row's global position
    (taken mod 2^32) mixed with the seed, bit for bit.  The reference
    computes in uint32; PyTorch has no uint32 arithmetic on CUDA, so
    this runs in int64 masked to 32 bits after every multiply, and every
    right shift reads a masked (non-negative) lane, where int64 `>>` is
    the logical shift."""
    h = (idx & _U32) ^ ((seed * 0x9E3779B9) & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def sample_threshold(fraction: float) -> int:
    """The uint32 keep threshold of a Bernoulli fraction (a fraction of
    1 or more keeps every row and never compares)."""
    return min(int(round(fraction * 2.0 ** 32)), 2 ** 32 - 1)


class SampleExec(PlanNode):
    """GpuSampleExec: Bernoulli sampling without replacement.  A row is
    kept when the hash of its global live position is below the
    fraction's threshold: no generator state, so the kept rows depend
    only on the seed, never on how the input is batched, and equal the
    reference's device path and CPU fallback.  The kept rows compact
    (ops/filter.compact_batch: the compaction_order kernel)."""

    def __init__(self, fraction: float, seed: int, child: PlanNode):
        super().__init__(child)
        self.fraction = float(fraction)
        self.seed = int(seed)

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # subset of rows

    def column_range(self, name):
        return self.child.column_range(name)   # subset of values

    def describe(self):
        return f"SampleExec[{self.fraction}, seed={self.seed}]"

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.filter import compact_batch
        from ..ops.kernels import live_mask
        threshold = sample_threshold(self.fraction)
        offset = 0                    # a host int, or a 0-d device tensor
        for db in self.child.execute(ctx):
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            if self.fraction < 1.0:
                pos = torch.arange(db.capacity, dtype=torch.int64,
                                   device=db.device) + offset
                keep = live_mask(db.capacity, db.num_rows, db.device) & \
                    (sample_hash_u32(pos, self.seed) < threshold)
                out = compact_batch(db, keep, ctx.conf)
            else:
                out = db
            offset = offset + (db.num_rows.to(torch.int64)
                               if isinstance(db.num_rows, torch.Tensor)
                               else db.num_rows)
            yield out


class CoalesceBatchesExec(PlanNode):
    """GpuCoalesceBatches: concatenates batches until the next would pass
    `target_rows` rows (default `sql.batchSizeRows`), or all of them with
    `require_single`.  Each batch's row count comes to the host (a sync
    a batch).  No conversion inserts it; it is built by hand."""

    def __init__(self, child: PlanNode, target_rows: Optional[int] = None,
                 require_single: bool = False):
        super().__init__(child)
        self.target_rows = target_rows
        self.require_single = require_single

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # same rows, repacked

    def static_row_count(self):
        return self.child.static_row_count()

    def column_range(self, name):
        return self.child.column_range(name)

    def describe(self):
        goal = "RequireSingleBatch" if self.require_single \
            else f"target={self.target_rows or 'conf'}"
        return f"CoalesceBatchesExec[{goal}]"

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        target = self.target_rows or ctx.conf.batch_size_rows
        pending: List[DeviceBatch] = []
        rows = 0
        for db in self.child.execute(ctx):
            n = int(db.num_rows)
            if n == 0:
                continue
            if not self.require_single and rows and rows + n > target:
                yield concat_batches(pending, ctx.conf)
                pending, rows = [], 0
            pending.append(db)
            rows += n
        if pending:
            yield concat_batches(pending, ctx.conf)
