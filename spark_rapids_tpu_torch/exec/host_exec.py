"""CPU physical operators (the per-operator fallback path) and the
transitions between them and the device.

Counterpart of spark_rapids_tpu/exec/host_exec.py.  The reference keeps
the operators that its tagging cannot place on the device running on
the CPU, bridged by GpuRowToColumnarExec / GpuColumnarToRowExec
(GpuTransitionOverrides.scala:50).  The reference's CPU engine is
pyarrow; the port's is numpy over `columnar/host.HostBatch`, so it runs
on the card's machine, which has no pyarrow.  Host operators stream
HostBatches and evaluate expressions through `Expression.eval_cpu` and
aggregates through `AggregateFunction.cpu_agg` (ops/host.py holds the
numpy kernels).  String columns stay dictionary-coded: a CPU operator's
string result is re-encoded into a sorted, duplicate-free dictionary,
so `HostToDeviceExec` uploads it as a scan does.

Transitions:
  * HostToDeviceExec — a device PlanNode over a HostNode child (the
    HostColumnarToGpu role): slices oversized host batches to
    `sql.batchSizeRows` rows and uploads each through
    `columnar/device.to_device`, the scan's upload path.
  * DeviceToHostExec — a HostNode over a device PlanNode child (the
    GpuColumnarToRowExec role): fetches each result batch's live rows
    (`fetch_result_batch`).

Each node's host time, and each transition's bytes and time, accumulate
in `ExecContext.metrics` (`host_profile`).  A failing operator raises:
nothing here reroutes work between the engines at run time.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from ..columnar.device import DeviceBatch, fetch_result_batch, to_device
from ..columnar.host import HostBatch, HostColumn, concat_host
from ..ops import host as H
from ..plan import expressions as E
from ..plan.aggregates import AggregateFunction
from .plan import (ExecContext, PlanNode, key_ref_names, sample_hash_u32,
                   sample_threshold)

#: ExecContext.metrics keys of the transitions
H2D_BYTES, H2D_NS, D2H_BYTES, D2H_NS = ("h2d_bytes", "h2d_ns", "d2h_bytes",
                                        "d2h_ns")


def sort_indices_per_key(keys: Sequence[Tuple[HostColumn, bool, bool]]
                         ) -> np.ndarray:
    """Stable row order by several keys, each with its own direction and
    null placement (Spark's SortOrder): keys are (column, ascending,
    nulls_first).  Each key is a null-rank lane ahead of its value lane
    (ops/host.order_lane: codes for strings, Spark's float order), a
    descending key its dense rank negated, and `np.lexsort` orders the
    rows over all the lanes."""
    lanes = []
    for col, asc, nf in keys:
        if col.validity is not None:
            null = (~col.validity).astype(np.int64)
            lanes.append(-null if nf else null)
        lane = H.order_lane(col)
        if not asc:
            _u, rank = np.unique(lane, return_inverse=True)
            lane = -rank.reshape(-1).astype(np.int64)
        lanes.append(lane)
    if not lanes:
        return np.arange(0, dtype=np.int64)
    return H.lexsort_rows(lanes)


def empty_batch(schema: t.StructType) -> HostBatch:
    return HostBatch([HostColumn(
        np.zeros(0, t.physical_np_dtype(f.data_type)), None, f.data_type,
        np.array([], str) if isinstance(f.data_type, t.StringType) else None)
        for f in schema.fields], schema.names)


def concat_batches(batches: Sequence[HostBatch],
                   schema: t.StructType) -> HostBatch:
    """Row concatenation of the non-empty batches (`concat_host`), an
    empty batch of `schema` when there is none."""
    batches = [b for b in batches if b.num_rows]
    if not batches:
        return empty_batch(schema)
    if len(batches) == 1:
        return batches[0]
    return concat_host(batches)


def take_rows(hb: HostBatch, idx: np.ndarray) -> HostBatch:
    return HostBatch([H.take(c, idx) for c in hb.columns], hb.names)


def _cond_mask(cond: E.Expression, hb: HostBatch) -> np.ndarray:
    """Rows where a predicate is true (null is false)."""
    c = cond.eval_cpu(hb)
    return c.data.astype(bool) & H.valid_of(c.validity, hb.num_rows)


def host_profile(ctx: ExecContext) -> dict:
    """{operator description: host seconds, its children's excluded},
    plus the transitions' bytes and seconds, of the queries run with
    `ctx`."""
    out = dict(ctx.metrics.get("host_ops", {}))
    for k in (H2D_BYTES, D2H_BYTES):
        out[k] = ctx.metrics.get(k, 0)
    for k in (H2D_NS, D2H_NS):
        out[k.replace("_ns", "_s")] = ctx.metrics.get(k, 0) / 1e9
    return out


class HostNode:
    """Base CPU operator: streams HostBatches.  `execute` times the
    node's own work (its children's excluded) into ctx.metrics
    ["host_ops"]; subclasses implement `_execute`."""

    def __init__(self, *children):
        self.children = list(children)

    @property
    def child(self):
        return self.children[0]

    @property
    def output_schema(self) -> t.StructType:
        raise NotImplementedError

    def _execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        raise NotImplementedError

    def column_range(self, name: str) -> Optional[Tuple[int, int]]:
        """Exact integer bounds of a column from scan statistics, as
        PlanNode.column_range (a device parent reads them through
        HostToDeviceExec)."""
        return None

    def keys_unique(self, names: Sequence[str]) -> bool:
        return False

    def execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        it = self._execute(ctx)
        ops = ctx.metrics.setdefault("host_ops", {})
        key = f"{self.describe()}#{id(self)}"
        stack = ctx.metrics.setdefault("host_stack", [])
        while True:
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                hb = next(it)
            except StopIteration:
                self._charge(ops, key, stack, t0)
                return
            except BaseException:
                self._charge(ops, key, stack, t0)
                raise
            self._charge(ops, key, stack, t0)
            yield hb

    @staticmethod
    def _charge(ops, key, stack, t0):
        spent = time.perf_counter() - t0
        inner = stack.pop()
        ops[key] = ops.get(key, 0.0) + spent - inner
        if stack:
            stack[-1] += spent          # the parent excludes this time

    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name()

    def tree_string(self, depth: int = 0) -> str:
        return "\n".join(["  " * depth + self.describe()] +
                         [c.tree_string(depth + 1) for c in self.children])

    def collect(self, ctx: Optional[ExecContext] = None) -> HostBatch:
        ctx = ctx or ExecContext()
        return concat_batches(list(self.execute(ctx)), self.output_schema)

    def _table(self, ctx: ExecContext, i: int = 0) -> HostBatch:
        """Child `i`'s whole output as one batch."""
        c = self.children[i]
        return concat_batches(list(c.execute(ctx)), c.output_schema)


# ---------------------------------------------------------------------------
# Transitions
# ---------------------------------------------------------------------------

def _host_nbytes(hb: HostBatch) -> int:
    return sum(c.data.nbytes + (0 if c.validity is None
                                else c.validity.nbytes) for c in hb.columns)


class HostToDeviceExec(PlanNode):
    """Upload a host stream to the device (the HostColumnarToGpu role),
    in slices of at most `sql.batchSizeRows` rows."""

    def __init__(self, host_child: HostNode):
        super().__init__()
        self.host_child = host_child

    @property
    def output_schema(self) -> t.StructType:
        return self.host_child.output_schema

    def column_range(self, name):
        return self.host_child.column_range(name)

    def keys_unique(self, names):
        return self.host_child.keys_unique(names)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        target = ctx.conf.batch_size_rows
        for hb in self.host_child.execute(ctx):
            n = hb.num_rows
            for off in range(0, max(n, 1), target):
                sl = hb.slice(off, min(target, n - off)) if n > target \
                    else hb
                t0 = time.perf_counter()
                db = to_device(sl, ctx.conf, device=ctx.device)
                ctx.bump(H2D_NS, int((time.perf_counter() - t0) * 1e9))
                ctx.bump(H2D_BYTES, _host_nbytes(sl))
                ctx.bump("h2d_rows", sl.num_rows)
                yield db

    def tree_string(self, depth: int = 0) -> str:
        return "\n".join(["  " * depth + "HostToDeviceExec",
                          self.host_child.tree_string(depth + 1)])


class DeviceToHostExec(HostNode):
    """Fetch a device stream to the host (the GpuColumnarToRowExec
    role): each batch's live rows.  Its time includes waiting for the
    device operators below it, whose kernels run asynchronously."""

    def __init__(self, device_child: PlanNode):
        super().__init__()
        self.device_child = device_child

    @property
    def output_schema(self) -> t.StructType:
        return self.device_child.output_schema

    def column_range(self, name):
        return self.device_child.column_range(name)

    def keys_unique(self, names):
        return self.device_child.keys_unique(names)

    def _execute(self, ctx):
        for db in self.device_child.execute(ctx):
            if isinstance(db.num_rows, int) and db.num_rows == 0:
                continue
            t0 = time.perf_counter()
            hb = fetch_result_batch(db, conf=ctx.conf)
            ctx.bump(D2H_NS, int((time.perf_counter() - t0) * 1e9))
            ctx.bump(D2H_BYTES, _host_nbytes(hb))
            ctx.bump("d2h_rows", hb.num_rows)
            if hb.num_rows:
                yield hb

    def tree_string(self, depth: int = 0) -> str:
        return "\n".join(["  " * depth + "DeviceToHostExec",
                          self.device_child.tree_string(depth + 1)])


# ---------------------------------------------------------------------------
# CPU operators
# ---------------------------------------------------------------------------

class HostSourceExec(HostNode):
    """Leaf over an in-memory HostBatch, in batches of `batch_rows`."""

    def __init__(self, table: HostBatch, batch_rows: Optional[int] = None):
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
        return bool(names) and all(n in self.table.names for n in names) \
            and self.table.keys_unique(names)

    def _execute(self, ctx):
        n = self.table.num_rows
        step = self.batch_rows or max(n, 1)
        if n <= step:
            yield self.table
            return
        for off in range(0, n, step):
            yield self.table.slice(off, min(step, n - off))

    def describe(self):
        return f"HostSourceExec[{self.table.num_rows} rows]"


def _eval_named(exprs: Sequence[E.Expression], names: Sequence[str],
                hb: HostBatch) -> HostBatch:
    return HostBatch([e.eval_cpu(hb) for e in exprs], names)


class CpuProjectExec(HostNode):
    def __init__(self, exprs: Sequence[E.Expression], names: Sequence[str],
                 child: HostNode):
        super().__init__(child)
        self.exprs = [e.bind(child.output_schema) for e in exprs]
        self.names = list(names)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType([t.StructField(n, e.dtype, e.nullable)
                             for n, e in zip(self.names, self.exprs)])

    def _refs(self, names):
        """The child's columns that `names` pass through, else None."""
        if any(n not in self.names for n in names):
            return None
        return key_ref_names([self.exprs[self.names.index(n)]
                              for n in names])

    def column_range(self, name):
        ref = self._refs([name])
        return None if ref is None else self.child.column_range(ref[0])

    def keys_unique(self, names):
        refs = self._refs(names)
        return refs is not None and self.child.keys_unique(refs)

    def _execute(self, ctx):
        for hb in self.child.execute(ctx):
            yield _eval_named(self.exprs, self.names, hb)

    def describe(self):
        return f"CpuProjectExec[{', '.join(self.names)}]"


class CpuFilterExec(HostNode):
    def __init__(self, condition: E.Expression, child: HostNode):
        super().__init__(child)
        self.condition = condition.bind(child.output_schema)

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def column_range(self, name):
        return self.child.column_range(name)   # a subset of values

    def keys_unique(self, names):
        return self.child.keys_unique(names)   # a subset of rows

    def _execute(self, ctx):
        for hb in self.child.execute(ctx):
            keep = _cond_mask(self.condition, hb)
            yield hb if keep.all() else take_rows(hb, np.flatnonzero(keep))

    def describe(self):
        return f"CpuFilterExec[{self.condition!r}]"


class CpuSampleExec(HostNode):
    """Bernoulli sample on the host stream, by the device path's hash of
    each row's global position (exec/plan.sample_hash_u32, plain integer
    math on numpy lanes here): the same rows for a seed on either
    engine, and the reference's."""

    def __init__(self, fraction: float, seed: int, child: HostNode):
        super().__init__(child)
        self.fraction = float(fraction)
        self.seed = int(seed)

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def _execute(self, ctx):
        threshold = sample_threshold(self.fraction)
        offset = 0
        for hb in self.child.execute(ctx):
            n = hb.num_rows
            if n == 0:
                continue
            if self.fraction >= 1.0:
                offset += n
                yield hb
                continue
            pos = offset + np.arange(n, dtype=np.int64)
            offset += n
            keep = sample_hash_u32(pos, self.seed) < threshold
            yield take_rows(hb, np.flatnonzero(keep))

    def describe(self):
        return f"CpuSampleExec[{self.fraction}, seed={self.seed}]"


class CpuAggregateExec(HostNode):
    """Group-by on numpy: the rows' group ids by their key tuple (groups
    in order of first appearance, a null key a value of its own, NaN one
    value, -0.0 equal to 0.0), then each function's `cpu_agg`.  COUNT
    (DISTINCT) beside other aggregates runs here, as in the reference.
    A global aggregate (no keys) gives one row, also over no input."""

    def __init__(self, keys: Sequence[E.Expression], key_names: Sequence[str],
                 aggs: Sequence[Tuple[AggregateFunction, str]],
                 child: HostNode):
        super().__init__(child)
        schema = child.output_schema
        self.keys = [k.bind(schema) for k in keys]
        self.key_names = list(key_names)
        self.aggs = [(fn.bind(schema), n) for fn, n in aggs]

    @property
    def output_schema(self) -> t.StructType:
        fields = [t.StructField(n, k.dtype)
                  for n, k in zip(self.key_names, self.keys)]
        fields += [t.StructField(n, fn.dtype) for fn, n in self.aggs]
        return t.StructType(fields)

    def _execute(self, ctx):
        hb = self._table(ctx)
        keys = [k.eval_cpu(hb) for k in self.keys]
        gid, ngroups, first = H.group_ids(keys, hb.num_rows)
        if keys and hb.num_rows == 0:
            yield empty_batch(self.output_schema)
            return
        groups = H.Groups(gid, ngroups)
        cols = [H.take(k, first) for k in keys]
        cols += [fn.cpu_agg(hb, groups) for fn, _n in self.aggs]
        yield HostBatch(cols, self.output_schema.names)

    def describe(self):
        return (f"CpuAggregateExec[keys={self.key_names}, "
                f"aggs={[n for _, n in self.aggs]}]")


class CpuSortExec(HostNode):
    def __init__(self, orders, child: HostNode):
        """orders: (expression, ascending, nulls_first) tuples; a name
        stands for its column."""
        super().__init__(child)
        self.orders = []
        for o in orders:
            e, asc, nf = _sort_order(o)
            self.orders.append((e.bind(child.output_schema), asc, nf))

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def _execute(self, ctx):
        hb = self._table(ctx)
        idx = sort_indices_per_key([(e.eval_cpu(hb), asc, nf)
                                    for e, asc, nf in self.orders])
        yield take_rows(hb, idx)

    def describe(self):
        return f"CpuSortExec[{len(self.orders)} keys]"


def _sort_order(o):
    """(expression, ascending, nulls_first) of a LogicalSort order."""
    e, asc, nf = o
    return (E.ColumnRef(e) if isinstance(e, str) else e), asc, nf


class CpuLimitExec(HostNode):
    def __init__(self, limit: int, child: HostNode):
        super().__init__(child)
        self.limit = limit

    @property
    def output_schema(self) -> t.StructType:
        return self.child.output_schema

    def _execute(self, ctx):
        remaining = self.limit
        for hb in self.child.execute(ctx):
            if remaining <= 0:
                return
            if hb.num_rows <= remaining:
                remaining -= hb.num_rows
                yield hb
            else:
                yield hb.slice(0, remaining)
                return

    def describe(self):
        return f"CpuLimitExec[{self.limit}]"


def _join_key_ids(lcols: List[HostColumn], rcols: List[HostColumn]):
    """(left key id, right key id) over one id space; -1 where a key
    column is null (a null key matches nothing)."""
    nl = len(lcols[0])
    lanes = []
    for a, b in zip(lcols, rcols):
        if isinstance(a.dtype, t.StringType) or \
                isinstance(b.dtype, t.StringType):
            _u, (ac, bc) = E._unified_codes([a, b])
            lanes.append(np.concatenate([ac, bc]).astype(np.int64))
            continue
        if isinstance(a.dtype, t.DecimalType) or \
                isinstance(b.dtype, t.DecimalType):
            sa = getattr(a.dtype, "scale", 0)
            sb = getattr(b.dtype, "scale", 0)
            s = max(sa, sb)
            a = H.column(H.rescale(a.data.astype(np.int64), sa, s)[0],
                         a.validity, t.LONG)
            b = H.column(H.rescale(b.data.astype(np.int64), sb, s)[0],
                         b.validity, t.LONG)
        elif a.data.dtype.kind == "f" or b.data.dtype.kind == "f":
            a = H.column(a.data.astype(np.float64), a.validity, t.DOUBLE)
            b = H.column(b.data.astype(np.float64), b.validity, t.DOUBLE)
        lanes.append(np.concatenate([H.order_lane(a), H.order_lane(b)]))
    ids, count = H.factorize(lanes)
    valid = np.ones(len(ids), bool)
    for a, b in zip(lcols, rcols):
        valid &= np.concatenate([H.valid_of(a.validity, len(a)),
                                 H.valid_of(b.validity, len(b))])
    ids = np.where(valid, ids, -1)
    return ids[:nl], ids[nl:], count


def join_pairs(join_type: str, lid: np.ndarray, rid: np.ndarray,
               count: int):
    """(left rows, right rows) of an equi-join's output, -1 for the null
    side of an outer row: left-major, right rows ascending within a key,
    then (right and full outer) the unmatched right rows in order.  Keys
    are ids below `count` (-1: null), so each key's run of right rows
    comes from a bincount instead of a search."""
    live = rid >= 0
    order = np.argsort(np.where(live, rid, count), kind="stable")
    rcnt = np.bincount(rid[live], minlength=count)
    rstart = np.cumsum(rcnt) - rcnt
    key = np.maximum(lid, 0)
    lo = rstart[key] if count else np.zeros(len(lid), np.int64)
    cnt = np.where(lid >= 0, rcnt[key] if count else 0, 0)
    if join_type in ("left_semi", "left_anti"):
        keep = cnt > 0 if join_type == "left_semi" else cnt == 0
        return np.flatnonzero(keep), None
    outer_left = join_type in ("left_outer", "full_outer")
    per = np.where(cnt == 0, 1, cnt) if outer_left else cnt
    li = np.repeat(np.arange(len(lid), dtype=np.int64), per)
    start = np.repeat(lo, per)
    first = np.repeat(np.cumsum(per) - per, per)
    pos = start + (np.arange(len(li), dtype=np.int64) - first)
    matched = np.repeat(cnt > 0, per)
    ri = np.where(matched, order[np.minimum(pos, max(len(order) - 1, 0))]
                  if len(order) else -1, -1)
    if join_type in ("right_outer", "full_outer"):
        hit = np.zeros(len(rid), bool)
        hit[ri[ri >= 0]] = True
        extra = np.flatnonzero(~hit)
        li = np.concatenate([li, np.full(len(extra), -1, np.int64)])
        ri = np.concatenate([ri, extra])
    return li, ri


class CpuJoinExec(HostNode):
    """Equi-joins of every type and the cross join, on numpy: both sides
    materialize, their keys factorize into one id space (Spark's key
    equality: -0.0 = 0.0, NaN = NaN; a null key matches nothing), and
    the pairs come from a stable sort of the right ids."""

    def __init__(self, join_type: str, left_keys, right_keys,
                 left: HostNode, right: HostNode):
        from .join import JOIN_TYPES
        super().__init__(left, right)
        if join_type not in JOIN_TYPES + ("cross",):
            raise NotImplementedError(f"unsupported join type {join_type}")
        self.join_type = join_type
        self.left_keys = [k.bind(left.output_schema) for k in left_keys]
        self.right_keys = [k.bind(right.output_schema) for k in right_keys]

    @property
    def output_schema(self) -> t.StructType:
        lf = list(self.children[0].output_schema.fields)
        if self.join_type in ("left_semi", "left_anti"):
            return t.StructType(lf)
        return t.StructType(lf + list(self.children[1].output_schema.fields))

    def _execute(self, ctx):
        lt = self._table(ctx, 0)
        rt = self._table(ctx, 1)
        if self.join_type == "cross":
            li = np.repeat(np.arange(lt.num_rows, dtype=np.int64),
                           rt.num_rows)
            ri = np.tile(np.arange(rt.num_rows, dtype=np.int64),
                         lt.num_rows)
        else:
            lid, rid, count = _join_key_ids(
                [k.eval_cpu(lt) for k in self.left_keys],
                [k.eval_cpu(rt) for k in self.right_keys])
            li, ri = join_pairs(self.join_type, lid, rid, count)
        out = take_rows(lt, li)
        if ri is not None:
            right = take_rows(rt, ri)
            out = HostBatch(out.columns + right.columns,
                            out.names + right.names)
        yield out

    def describe(self):
        return f"CpuJoinExec[{self.join_type}]"


class CpuUnionExec(HostNode):
    """UNION ALL: the children's batches in order, by position, under the
    first child's names."""

    @property
    def output_schema(self) -> t.StructType:
        return self.children[0].output_schema

    def _execute(self, ctx):
        names = self.output_schema.names
        for c in self.children:
            for hb in c.execute(ctx):
                yield HostBatch(hb.columns, names)


class CpuRangeExec(HostNode):
    def __init__(self, start, end, step=1, name="id",
                 batch_rows: Optional[int] = None):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.col_name = name
        self.batch_rows = batch_rows

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType([t.StructField(self.col_name, t.LONG, False)])

    def _execute(self, ctx):
        total = max(0, -(-(self.end - self.start) // self.step))
        chunk = self.batch_rows or ctx.conf.batch_size_rows
        for off in range(0, total, chunk):
            n = min(chunk, total - off)
            vals = self.start + (off + np.arange(n, dtype=np.int64)) * \
                self.step
            yield HostBatch([HostColumn(vals, None, t.LONG)],
                            [self.col_name])

    def describe(self):
        return f"CpuRangeExec[{self.start}, {self.end}, {self.step}]"


class CpuExpandExec(HostNode):
    def __init__(self, projections, names, child: HostNode):
        super().__init__(child)
        self.projections = [[e.bind(child.output_schema) for e in p]
                            for p in projections]
        self.names = list(names)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType([t.StructField(n, e.dtype) for n, e in
                             zip(self.names, self.projections[0])])

    def _execute(self, ctx):
        for hb in self.child.execute(ctx):
            for proj in self.projections:
                yield _eval_named(proj, self.names, hb)
