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
Both move their batches under `runtime/retry.retry_io` (the "h2d" and
"d2h" chaos sites).

Each node's host time, and each transition's bytes and time, accumulate
in `ExecContext.metrics` (`host_profile`).  A failing operator raises:
nothing here reroutes work between the engines at run time.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from ..columnar.device import DeviceBatch, fetch_result_batch, to_device
from ..columnar.host import (HostBatch, HostColumn, concat_host,
                             decimal_value, host_nbytes)
from ..ops import host as H
from ..plan import expressions as E
from ..plan.aggregates import AggregateFunction
from ..plan.misc import reset_ordinals
from ..runtime.retry import retry_io
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
        lanes_k = H.order_lanes(col)
        # a two-lane DECIMAL key: its dense rank over both lanes
        lane = lanes_k[0] if len(lanes_k) == 1 else H.factorize(lanes_k)[0]
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
        # one stack a thread: a pandas exec's feeder thread runs its
        # child while the exec itself waits on its worker
        stack = ctx.metrics.setdefault("host_stack", {}).setdefault(
            threading.get_ident(), [])
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
    return sum(host_nbytes(c) for c in hb.columns)


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
                db = retry_io(ctx.conf, "h2d",
                              lambda: to_device(sl, ctx.conf,
                                                device=ctx.device))
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
            # the fetch reads a row prefix (fetch_result_batch resolves a
            # selection vector or deferred columns, and asserts it)
            hb = retry_io(ctx.conf, "d2h",
                          lambda: fetch_result_batch(db, conf=ctx.conf))
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
        reset_ordinals(self.exprs)
        for hb in self.child.execute(ctx):
            yield _eval_named(self.exprs, self.names, hb)

    def project(self, hb: HostBatch) -> HostBatch:
        """The projection over one batch of the child's output."""
        reset_ordinals(self.exprs)
        return _eval_named(self.exprs, self.names, hb)

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
            ua, ok_a = H.rescale(a.data.astype(np.int64), sa, s)
            ub, ok_b = H.rescale(b.data.astype(np.int64), sb, s)
            if a.hi is None and b.hi is None and ok_a.all() and ok_b.all():
                a = H.column(ua, a.validity, t.LONG)
                b = H.column(ub, b.validity, t.LONG)
            else:
                # a key past int64: its exact value in two lanes
                wide = t.DecimalType(38, s)
                a = H.wide_column(a.unscaled() * 10 ** (s - sa), a.validity,
                                  wide)
                b = H.wide_column(b.unscaled() * 10 ** (s - sb), b.validity,
                                  wide)
                ids_a, ids_b = _pair_order_ids(a, b)
                lanes.append(np.concatenate([ids_a, ids_b]))
                continue
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


def _pair_order_ids(a: HostColumn, b: HostColumn):
    """Dense ids of two columns' values over one id space, in value
    order (`ops/host.order_lanes`, several lanes for a high word)."""
    def two(c):
        return [c.hi_lane(), c.data.astype(np.int64) ^ np.int64(-2 ** 63)]
    ids, _n = H.factorize([np.concatenate([x, y])
                           for x, y in zip(two(a), two(b))])
    return ids[:len(a)], ids[len(a):]


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


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

_RANKING = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
            "ntile")


def _run_ids(lanes: List[np.ndarray], n: int) -> np.ndarray:
    """Per-row run start flags of sorted rows over key lanes."""
    b = np.zeros(n, bool)
    if n:
        b[0] = True
    for lane in lanes:
        b[1:] |= lane[1:] != lane[:-1]
    return b


def _edges(flags: np.ndarray, n: int):
    """(first row, last row) of each row's run, runs starting at
    `flags`."""
    ids = np.cumsum(flags) - 1
    starts = np.flatnonzero(flags)
    ends = np.append(starts[1:], n) - 1
    return starts[ids], ends[ids]


def _key_lanes(col: HostColumn) -> List[np.ndarray]:
    """Lanes equal exactly where Spark's key equality holds (nulls equal
    each other, apart from every value)."""
    null = (~H.valid_of(col.validity, len(col))).astype(np.int64)
    return [null] + H.order_lanes(col)


class CpuWindowExec(HostNode):
    """Window functions on numpy over the partition-sorted table (the
    reference's CpuWindowExec, which computes through pandas: the card's
    machine has none).  Rows sort by (partition keys, order keys) as
    `sort_indices_per_key` orders them; partitions and peer groups are
    runs of equal keys (nulls equal, NaN equal, -0.0 = 0.0).  Every
    function and frame of plan/window.py runs: ranking, lead/lag with a
    default, ROWS and RANGE frames (unbounded, current row, row offsets,
    value offsets over one order key) for count, sum, avg, min, max,
    first_value and last_value.  Sums and averages of integral and
    floating inputs are prefix-sum differences, as the reference's are; a
    frame's NaN and infinities are counted apart, so a non-finite value
    reaches only the frames that hold it.  A DECIMAL sum or average is
    exact (Python ints), where the reference computes it through
    float64; MIN and MAX order floats as Java does (NaN greatest)."""

    def __init__(self, window_exprs, partition_keys, order_keys,
                 child: HostNode):
        from ..plan.window import check_window_analysis
        super().__init__(child)
        check_window_analysis(window_exprs, order_keys)
        schema = child.output_schema
        self.window_exprs = [(spec.bind(schema), name)
                             for spec, name in window_exprs]
        self.partition_keys = [e.bind(schema) for e in partition_keys]
        self.order_keys = [(e.bind(schema), asc, nf)
                           for e, asc, nf in order_keys]

    @property
    def output_schema(self) -> t.StructType:
        fields = list(self.child.output_schema.fields)
        for spec, name in self.window_exprs:
            fields.append(t.StructField(name, spec.dtype))
        return t.StructType(fields)

    def _execute(self, ctx):
        from ..plan.window import default_frame
        hb = self._table(ctx)
        n = hb.num_rows
        pcols = [e.eval_cpu(hb) for e in self.partition_keys]
        ocols = [e.eval_cpu(hb) for e, _a, _nf in self.order_keys]
        keys = [(c, True, True) for c in pcols] + \
            [(c, asc, nf) for c, (_e, asc, nf) in zip(ocols,
                                                       self.order_keys)]
        idx = sort_indices_per_key(keys) if keys and n \
            else np.arange(n, dtype=np.int64)
        sb = take_rows(hb, idx)
        pcols = [H.take(c, idx) for c in pcols]
        ocols = [H.take(c, idx) for c in ocols]
        plane = [x for c in pcols for x in _key_lanes(c)]
        olane = [x for c in ocols for x in _key_lanes(c)]
        part_b = _run_ids(plane, n)
        peer_b = part_b | _run_ids(olane, n)
        w = _Frames(n, part_b, peer_b, ocols, self.order_keys)
        out = list(sb.columns)
        for spec, _name in self.window_exprs:
            frame = spec.frame
            if frame is None and spec.kind not in _RANKING + ("lead", "lag"):
                frame = default_frame(bool(self.order_keys))
            src = None if spec.child is None else spec.child.eval_cpu(sb)
            out.append(w.run(spec, frame, src))
        yield HostBatch(out, self.output_schema.names)

    def describe(self):
        return f"CpuWindowExec[{[n for _, n in self.window_exprs]}]"


class _Frames:
    """The partition and peer structure of the sorted rows, and each
    window function over it."""

    def __init__(self, n, part_b, peer_b, ocols, order_keys):
        self.n = n
        self.idx = np.arange(n, dtype=np.int64)
        self.part_b = part_b
        self.peer_b = peer_b
        self.part_start, self.part_end = _edges(part_b, n)
        self.peer_start, self.peer_end = _edges(peer_b, n)
        self.part_rows = self.part_end - self.part_start + 1
        self.rn0 = self.idx - self.part_start
        self.ocols = ocols
        self.order_keys = order_keys

    # -- frames ------------------------------------------------------------
    def bounds(self, frame):
        """(lo, hi) row of each row's frame (empty where hi < lo)."""
        if frame.is_value_offset:
            return self._range_bounds(frame)
        if frame.kind == "range":
            lo = self.part_start if frame.lower is None else self.peer_start
            hi = self.part_end if frame.upper is None else self.peer_end
            return lo, hi
        lo = self.part_start if frame.lower is None else \
            np.maximum(self.part_start, self.idx + frame.lower)
        hi = self.part_end if frame.upper is None else \
            np.minimum(self.part_end, self.idx + frame.upper)
        return lo, hi

    def _range_bounds(self, frame):
        """Value-offset RANGE bounds over the one order key, per
        partition by binary search (exact Python ints for integral,
        DATE and TIMESTAMP keys; DECIMAL keys by value; floats as
        float64); null order rows are a frame of their own."""
        from ..plan.window import WindowAnalysisError
        if len(self.order_keys) != 1:
            raise WindowAnalysisError(
                "a value-offset RANGE frame requires exactly one window "
                "ORDER BY expression")
        col = self.ocols[0]
        dt = col.dtype
        asc = self.order_keys[0][1]
        if not (t.is_numeric(dt) or isinstance(dt, (t.DateType,
                                                    t.TimestampType))):
            raise WindowAnalysisError(
                f"value-offset RANGE frame over {dt.simple_string} order "
                "key")
        if t.is_floating(dt):
            vals = col.data.astype(np.float64)
        elif isinstance(dt, t.DecimalType):
            vals = np.array([decimal_value(u, dt.scale)
                             for u in col.unscaled().tolist()] + [0],
                            object)[:-1]
        else:
            vals = col.data.astype(np.int64).astype(object)
        vals = vals if asc else -vals
        valid = H.valid_of(col.validity, self.n)
        lo = np.empty(self.n, np.int64)
        hi = np.empty(self.n, np.int64)
        starts = np.flatnonzero(self.part_b)
        for s, e in zip(starts, np.append(starts[1:], self.n)):
            vidx = np.flatnonzero(valid[s:e])
            if not len(vidx):
                lo[s:e], hi[s:e] = s, e - 1
                continue
            vs, ve = int(vidx[0]), int(vidx[-1])
            sub = vals[s + vs:s + ve + 1]
            m = len(sub)
            lo_ = np.zeros(m, np.int64) if frame.lower is None else \
                np.searchsorted(sub, sub + frame.lower, "left")
            hi_ = np.full(m, m - 1, np.int64) if frame.upper is None else \
                np.searchsorted(sub, sub + frame.upper, "right") - 1
            lo[s + vs:s + ve + 1] = s + vs + lo_
            hi[s + vs:s + ve + 1] = s + vs + hi_
            if vs > 0:
                lo[s:s + vs], hi[s:s + vs] = s, s + vs - 1
            if s + ve + 1 < e:
                lo[s + ve + 1:e], hi[s + ve + 1:e] = s + ve + 1, e - 1
        return lo, hi

    # -- functions ---------------------------------------------------------
    def run(self, spec, frame, src: Optional[HostColumn]) -> HostColumn:
        k, n = spec.kind, self.n
        if k in _RANKING:
            return self._ranking(spec)
        if k in ("lead", "lag"):
            return self._offset(spec, src)
        lo, hi = self.bounds(frame)
        nonempty = hi >= lo
        if k in ("first_value", "last_value"):
            pick = np.where(nonempty, lo if k == "first_value" else hi, -1)
            return H.take(src, pick)
        valid = np.ones(n, bool) if src is None else \
            H.valid_of(src.validity, n)
        cnt = self._frame_sum(valid.astype(np.int64), lo, hi, nonempty)
        if k == "agg_count":
            return H.column(cnt, None, t.LONG)
        if k in ("agg_sum", "agg_avg"):
            return self._sum_avg(spec, src, valid, lo, hi, nonempty, cnt)
        return self._minmax(spec, frame, src, valid, lo, hi, nonempty, cnt)

    def _ranking(self, spec) -> HostColumn:
        k = spec.kind
        if k == "row_number":
            out = self.rn0 + 1
        elif k == "rank":
            out = self.peer_start - self.part_start + 1
        elif k == "dense_rank":
            pg = np.cumsum(self.peer_b) - 1
            out = pg - pg[self.part_start] + 1
        elif k == "percent_rank":
            denom = np.maximum(self.part_rows - 1, 1)
            out = np.where(self.part_rows == 1, 0.0,
                           (self.peer_start - self.part_start) / denom)
        elif k == "cume_dist":
            out = (self.peer_end - self.part_start + 1) / self.part_rows
        else:                                           # ntile
            nt, rows, rn0 = spec.n, self.part_rows, self.rn0
            kk, rem = rows // nt, rows % nt
            cut = rem * (kk + 1)
            bucket = np.where(rn0 < cut, rn0 // np.maximum(kk + 1, 1),
                              rem + (rn0 - cut) // np.maximum(kk, 1))
            out = np.where(rows < nt, rn0, bucket) + 1
        return H.column(out, None, spec.dtype)

    def _offset(self, spec, src: HostColumn) -> HostColumn:
        shift = spec.offset * (1 if spec.kind == "lead" else -1)
        pos = self.idx + shift
        inside = (pos >= self.part_start) & (pos <= self.part_end)
        if spec.default is None:
            return H.take(src, np.where(inside, pos, -1))
        one = HostBatch([HostColumn(np.zeros(1, np.int32), None, t.INT)],
                        ["_"])
        dflt = E.Literal(spec.default, src.dtype).eval_cpu(one)
        from ..columnar.host import concat_columns
        both = concat_columns([src, dflt])
        return H.take(both, np.where(inside, pos, self.n))

    def _frame_sum(self, lane, lo, hi, nonempty):
        """Per-row sum of `lane` over [lo, hi]: a prefix-sum difference
        (the reference's form; object lanes stay exact)."""
        n = self.n
        if not n:
            return lane[:0]
        zero = lane.dtype.type(0) if lane.dtype != object else 0
        with np.errstate(over="ignore", invalid="ignore"):
            ps = np.cumsum(lane)
            loc = np.clip(lo - 1, 0, n - 1)
            base = np.where(lo > 0, ps[loc], zero)
            out = ps[np.clip(hi, 0, n - 1)] - base
        return np.where(nonempty, out, zero)

    def _sum_avg(self, spec, src, valid, lo, hi, nonempty, cnt):
        dt = src.dtype
        ok = cnt > 0
        if isinstance(dt, t.DecimalType):
            vals = np.where(valid, src.unscaled(), 0)
            s = self._frame_sum(vals, lo, hi, nonempty)
            if spec.kind == "agg_sum":
                return H.wide_column(s, ok, spec.dtype)
            shift = 10 ** (spec.dtype.scale - dt.scale)
            q = [H._div_half_up(int(a) * shift, int(c)) if c > 0 else 0
                 for a, c in zip(s.tolist(), cnt.tolist())]
            return H.wide_column(np.array(q + [0], object)[:-1], ok,
                                 spec.dtype)
        if t.is_floating(dt):
            x = src.data.astype(np.float64)
            finite = valid & np.isfinite(x)
            s = self._frame_sum(np.where(finite, x, 0.0), lo, hi, nonempty)
            nan = self._frame_sum((valid & np.isnan(x)).astype(np.int64),
                                  lo, hi, nonempty)
            pinf = self._frame_sum((valid & (x == np.inf)).astype(np.int64),
                                   lo, hi, nonempty)
            ninf = self._frame_sum((valid & (x == -np.inf))
                                   .astype(np.int64), lo, hi, nonempty)
            s = np.where(pinf > 0, np.inf, s)
            s = np.where(ninf > 0, -np.inf, s)
            s = np.where((nan > 0) | ((pinf > 0) & (ninf > 0)), np.nan, s)
        else:
            s = self._frame_sum(np.where(valid, src.data.astype(np.int64),
                                         0), lo, hi, nonempty)
        if spec.kind == "agg_sum":
            return H.column(s, ok, spec.dtype)
        with np.errstate(all="ignore"):
            return H.column(s / np.maximum(cnt, 1), ok, t.DOUBLE)

    def _minmax(self, spec, frame, src, valid, lo, hi, nonempty, cnt):
        """MIN / MAX in an order lane (Java's float order, NaN greatest;
        string codes of the sorted dictionary; exact ints for a DECIMAL
        with a high word), decoded back to the value."""
        n = self.n
        is_min = spec.kind == "agg_min"
        dt = src.dtype
        is_float = src.data.dtype.kind == "f"
        if src.hi is not None:
            lane = src.unscaled()
            big = 1 << 130
            ident = big if is_min else -big
        elif is_float:
            lane = H.float_order(src.data, signed_zero=True)
            ident = np.int64(2 ** 63 - 1) if is_min else np.int64(-2 ** 63)
        else:
            lane = src.data.astype(np.int64)
            ident = np.int64(2 ** 63 - 1) if is_min else np.int64(-2 ** 63)
        masked = np.where(valid, lane, ident)
        op = np.minimum if is_min else np.maximum
        starts = np.flatnonzero(self.part_b)
        if frame.is_unbounded_both and n:
            red = op.reduceat(masked, starts)[np.cumsum(self.part_b) - 1]
        elif frame.lower is None and frame.upper == 0 and n:
            red = np.empty_like(masked)
            for s, e in zip(starts, np.append(starts[1:], n)):
                red[s:e] = op.accumulate(masked[s:e])
            if frame.kind == "range":          # the current row's peers
                red = red[np.clip(hi, 0, n - 1)]
        else:
            red = np.array([op.reduce(masked[a:b + 1]) if b >= a else ident
                            for a, b in zip(lo.tolist(), hi.tolist())]
                           + [ident], masked.dtype)[:-1]
        ok = (cnt > 0) & nonempty
        if src.hi is not None:
            return H.wide_column(np.where(ok, red, 0), ok, dt)
        if is_float:
            red = H.float_from_order(np.where(ok, red, 0)).astype(
                src.data.dtype)
        return H.column(np.where(ok, red, 0), ok, dt, src.dictionary)




class CpuGenerateExec(HostNode):
    """explode / posexplode (+ outer) on the CPU engine: each row repeated
    an element, the [pos,] col columns appended (the reference's
    CpuGenerateExec: a non-outer explode drops a row whose array is null
    or empty, an outer one keeps it once with null generated columns).
    The array column stays in the output."""

    def __init__(self, generator, output_names, child: HostNode):
        super().__init__(child)
        self.generator = generator.bind(child.output_schema)
        self._gen_fields = self.generator.output_fields()
        self.output_names = list(output_names) or \
            [f.name for f in self._gen_fields]

    @property
    def output_schema(self) -> t.StructType:
        fields = list(self.child.output_schema.fields)
        for f, n in zip(self._gen_fields, self.output_names):
            fields.append(t.StructField(n, f.data_type, f.nullable))
        return t.StructType(fields)

    def _execute(self, ctx):
        from ..plan.json_fns import JsonTupleGen
        gen = self.generator
        if isinstance(gen, JsonTupleGen):
            yield from self._json_tuple(ctx)
            return
        for hb in self.child.execute(ctx):
            arr = gen.child.eval_cpu(hb)
            n = len(arr)
            lens = np.diff(arr.offsets).astype(np.int64)
            lens = np.where(H.valid_of(arr.validity, n), lens, 0)
            reps = np.where(lens > 0, lens, 1 if gen.outer else 0)
            rows = np.repeat(np.arange(n, dtype=np.int64), reps)
            starts = np.cumsum(reps) - reps
            pos = np.arange(len(rows), dtype=np.int64) - starts[rows]
            has = lens[rows] > 0                # an element, not an outer row
            elem = np.where(has, arr.offsets[:-1][rows] + pos, -1)
            cols = list(take_rows(hb, rows).columns)
            if gen.pos:
                cols.append(H.column(pos.astype(np.int32),
                                     None if has.all() else has, t.INT))
            cols.append(H.take(arr.elements(), elem))
            yield HostBatch(cols, self.output_schema.names)

    def _json_tuple(self, ctx):
        """json_tuple as a generator: one output row an input row, the k
        fields appended as STRING columns (the reference's GpuJsonTuple
        role)."""
        gen = self.generator
        for hb in self.child.execute(ctx):
            vals = gen.child.eval_cpu(hb).to_pylist()
            cols = list(hb.columns)
            for out in gen.rows(vals):
                cols.append(H.strings_from_entries(
                    np.arange(len(out)), out, None))
            yield HostBatch(cols, self.output_schema.names)

    def describe(self):
        return f"CpuGenerateExec[{self.generator!r}]"
