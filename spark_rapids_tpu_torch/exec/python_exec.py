"""The pandas exec family over forked python workers and a numpy wire.

Counterpart of spark_rapids_tpu/exec/python_exec.py (the reference's
org/.../execution/python/: GpuArrowEvalPythonExec, GpuMapInPandasExec,
GpuFlatMapGroupsInPandasExec, GpuAggregateInPandasExec,
GpuWindowInPandasExec, GpuFlatMapCoGroupsInPandasExec).  The reference
moves device batches to the host and through a separate Python worker
process, throttled by PythonWorkerSemaphore, then back.  Here the worker
is a forked OS process (`mp.get_context("fork")`: user functions need no
pickling, closures ride the copied address space, as in pyspark) that
exchanges frames over a `Pipe`.

**The wire** carries numpy lanes, never Arrow: a frame is one pickle
(protocol 5) of the batches' HostColumns whose lane buffers (data,
validity, a string column's codes and dictionary, a decimal's high
word) travel out of band, each as one raw message received into a
buffer of its size.  An empty message ends a stream; `ERR:` and the
worker's repr of its error is a failure (`PythonWorkerError`, as is a
worker that dies).  The worker builds pandas frames itself, importing
pandas lazily: the engine never imports pandas or pyarrow, and the
worker never runs torch or touches the device (it is forked from a
process that may hold a CUDA context, and leaves through
multiprocessing's `os._exit`, so no atexit hook of the engine runs in
it; `gc.freeze()` keeps the collector away from the parent's objects).

**The frames a user function sees** have the dtypes pyarrow's
`to_pandas` gives the reference's: an integer column with a null is
float64 with NaN (without one it keeps its width), a BOOLEAN with a
null is object, FLOAT stays float32, STRING is pandas' string dtype,
DATE and DECIMAL are object columns of `datetime.date` and `Decimal`,
TIMESTAMP is datetime64[us, UTC].  **The way back** follows
`pa.RecordBatch.from_pandas(df, schema=...)`: columns by name (a missing
one raises), a NaN in a float column is null, values coerced to the
declared type (a float truncated to an integral type raises).

**Grouping** happens in the engine with numpy, by Spark's keys: NaN is
one group and null another, -0.0 equals 0.0.  Groups come in the
reference's order (keys ascending, NaN above every number, null last);
the reference groups with pandas after `to_pandas`, which merges a NaN
key with a null one (ROADMAP Queue 3 item 16): the port follows Spark.
AggregateInPandasExec's key columns, and the passthrough columns of the
scalar and window UDFs, come from the engine's own rows, as Spark joins
them back in the JVM: only the UDFs' input columns cross the wire.

Every exec here is a host operator by placement (plan/overrides.py): a
device child reaches it through DeviceToHostExec, a device parent
through HostToDeviceExec.  `spark.rapids.tpu.python.concurrentPythonWorkers`
bounds the queries whose workers are alive at once (`_worker_permit`);
the pandas execs of one query share its permit (`_query_permit`), where
the reference takes one a worker and deadlocks a chain of them whose
outer execs hold every permit (ROADMAP Queue 3 item 19); ExecContext
metrics count `python_workers_started` and the wire's bytes each way
(`python_wire_out_bytes`, `python_wire_in_bytes`).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import multiprocessing as mp
import pickle
import struct
import threading
import warnings
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np

from .. import types as t
from ..columnar.host import (INT_BITS, HostBatch, HostColumn,
                             column_from_values, string_column)
from ..ops import host as H
from .host_exec import HostNode, concat_batches, take_rows
from .plan import ExecContext

_SEM_LOCK = threading.Lock()
_WORKER_SEM: Optional[threading.Semaphore] = None

#: joins and terminations of a worker (seconds)
FEEDER_WAIT_S, JOIN_WAIT_S = 5, 10


def _worker_permit(conf):
    """PythonWorkerSemaphore role: bound concurrent UDF workers."""
    global _WORKER_SEM
    from ..config import PYTHON_WORKER_CONCURRENCY
    with _SEM_LOCK:
        if _WORKER_SEM is None:
            _WORKER_SEM = threading.Semaphore(
                int(conf.get(PYTHON_WORKER_CONCURRENCY)))
    return _WORKER_SEM


@contextlib.contextmanager
def _query_permit(ctx: ExecContext):
    """One permit a query, as the reference's PythonWorkerSemaphore is
    taken once a task: a pandas exec whose feeder thread runs a child
    pandas exec shares the permit its own query holds, so a chain of
    them never waits on itself.  The last of the query's workers to end
    gives the permit back."""
    sem = _worker_permit(ctx.conf)
    with _SEM_LOCK:
        first = ctx.python_permit_depth == 0
        ctx.python_permit_depth += 1
    try:
        if first:
            sem.acquire()
        yield
    finally:
        with _SEM_LOCK:
            ctx.python_permit_depth -= 1
            last = ctx.python_permit_depth == 0
        if last:
            sem.release()


class PythonWorkerError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

def _payload(hb: HostBatch):
    return (list(hb.names), list(hb.columns))


def send_frame(conn, item) -> int:
    """Send one frame (any tuple of HostBatches, None entries and small
    Python values; None alone ends the stream).  -> bytes sent."""
    if item is None:
        conn.send_bytes(b"")
        return 0
    bufs: List[pickle.PickleBuffer] = []
    meta = pickle.dumps(item, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    sizes = [r.nbytes for r in raws]
    conn.send_bytes(b"F" + struct.pack(f"<I{len(sizes)}Q", len(sizes),
                                       *sizes) + meta)
    for r in raws:
        conn.send_bytes(r)
    return len(meta) + sum(sizes)


def recv_frame(conn):
    """One frame (None at the end of the stream); raises
    PythonWorkerError on an error frame, EOFError when the other end
    is gone.  -> (frame, bytes received)."""
    head = conn.recv_bytes()
    if not head:
        return None, 0
    if head.startswith(b"ERR:"):
        raise PythonWorkerError(head[4:].decode(errors="replace"))
    (n,) = struct.unpack_from("<I", head, 1)
    sizes = struct.unpack_from(f"<{n}Q", head, 5)
    bufs = []
    for size in sizes:
        buf = bytearray(size)
        if size:
            conn.recv_bytes_into(buf)
        else:
            conn.recv_bytes()
        bufs.append(buf)
    meta = memoryview(head)[5 + 8 * n:]
    return pickle.loads(meta, buffers=bufs), len(meta) + sum(sizes)


def _batch(payload) -> HostBatch:
    names, cols = payload
    return HostBatch(cols, names)


def _worker_main(conn, other, body):
    """The forked worker: frames in, `body` over them, frames out."""
    other.close()
    gc.freeze()                   # never collect the parent's objects

    def frames():
        while True:
            item, _n = recv_frame(conn)
            if item is None:
                return
            yield tuple(None if p is None else _batch(p) for p in item[0]), \
                item[1]

    try:
        for hb in body(frames()):
            send_frame(conn, (_payload(hb),))
        send_frame(conn, None)
    except BaseException as e:                # noqa: BLE001
        try:
            conn.send_bytes(b"ERR:" + repr(e).encode())
        except Exception:                      # noqa: BLE001
            pass
    finally:
        conn.close()


def worker_stream(ctx: ExecContext, frames: Iterable, body: Callable
                  ) -> Iterator[HostBatch]:
    """Run `body` in a forked worker.  `frames` (consumed by a feeder
    thread, so a child plan keeps running while the worker computes)
    yields (tuple of HostBatches or None, extra): each is one frame;
    `body(received)` runs in the worker over the same pairs and yields
    HostBatches, which come back here in order."""
    mp_ctx = mp.get_context("fork")
    parent, child_conn = mp_ctx.Pipe()
    with _query_permit(ctx):
        proc = mp_ctx.Process(target=_worker_main,
                              args=(child_conn, parent, body), daemon=True)
        with warnings.catch_warnings():
            # a deliberate fork of a threaded process: the worker runs
            # only numpy and pandas, never the engine's threads' locks
            warnings.filterwarnings("ignore", message=".*multi-threaded.*",
                                    category=DeprecationWarning)
            proc.start()
        child_conn.close()
        ctx.bump("python_workers_started")
        feeder_done = threading.Event()

        def feed():
            try:
                for batches, extra in frames:
                    ctx.bump("python_wire_out_bytes", send_frame(parent, (
                        tuple(None if b is None else _payload(b)
                              for b in batches), extra)))
                send_frame(parent, None)
            except (BrokenPipeError, OSError):
                pass
            finally:
                feeder_done.set()

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            while True:
                item, n = recv_frame(parent)
                if item is None:
                    break
                ctx.bump("python_wire_in_bytes", n)
                yield _batch(item[0])
        except (EOFError, ConnectionError):
            proc.join(timeout=JOIN_WAIT_S)
            raise PythonWorkerError(
                f"python worker died (exit={proc.exitcode})") from None
        finally:
            feeder_done.wait(timeout=FEEDER_WAIT_S)
            parent.close()
            proc.join(timeout=JOIN_WAIT_S)
            if proc.is_alive():
                proc.terminate()


# ---------------------------------------------------------------------------
# pandas frames in the worker (pandas imported there only)
# ---------------------------------------------------------------------------

def _str_dtype():
    import pandas as pd
    try:
        return pd.StringDtype(na_value=np.nan)     # pandas 3's "str"
    except TypeError:
        return object


def _series(c: HostColumn):
    """One column as the pandas Series pyarrow's `to_pandas` makes."""
    import pandas as pd
    dt = c.dtype
    valid = c.validity
    nulls = valid is not None and not valid.all()
    if isinstance(dt, (t.IntegralType, t.FloatType, t.DoubleType)):
        data = c.data
        if nulls:
            data = data.astype(np.float64 if isinstance(
                dt, (t.IntegralType, t.DoubleType)) else np.float32)
            data[~valid] = np.nan
        return pd.Series(data, copy=False)
    if isinstance(dt, t.BooleanType):
        if not nulls:
            return pd.Series(c.data.astype(bool, copy=False), copy=False)
        return pd.Series(np.array(c.to_pylist() + [None], object)[:-1],
                         dtype=object)
    if isinstance(dt, t.StringType):
        # the dictionary's entries once, gathered by code (-1: null)
        entries = pd.array(c.dictionary.astype(object), dtype=_str_dtype())
        codes = c.data.astype(np.intp)
        if nulls:
            codes = np.where(valid, codes, -1)
        return pd.Series(entries.take(codes, allow_fill=True))
    if isinstance(dt, t.TimestampType):
        ts = c.data.astype("datetime64[us]")
        if nulls:
            ts[~valid] = np.datetime64("NaT")
        return pd.Series(ts).dt.tz_localize("UTC")
    vals = c.to_pylist()
    if isinstance(dt, t.ArrayType):
        vals = [None if v is None else np.asarray(v) for v in vals]
    return pd.Series(np.array(vals + [None], object)[:-1], dtype=object)


def to_frame(hb: HostBatch):
    import pandas as pd
    return pd.DataFrame({n: _series(c) for n, c in
                         zip(hb.names, hb.columns)})


def _numeric_column(vals: np.ndarray, null: np.ndarray, dt: t.DataType,
                    name: str) -> HostColumn:
    """A numpy numeric lane as `dt`, as pyarrow's from_pandas casts it."""
    validity = None if not null.any() else ~null
    live = vals[~null] if validity is not None else vals
    if isinstance(dt, t.IntegralType):
        if vals.dtype.kind == "f":
            bad = ~np.isfinite(live) | (live != np.trunc(live))
            if bad.any():
                raise ValueError(f"Float value {live[bad][0]} was truncated "
                                 f"converting to {dt.simple_string} "
                                 f"(column {name})")
        bits = INT_BITS[type(dt)]
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        if len(live) and vals.dtype.kind != "b" and (
                live.min() < lo or live.max() > hi):
            v = live[(live < lo) | (live > hi)][0]
            raise ValueError(f"Integer value {v} not in range: {lo} to {hi} "
                             f"(column {name})")
        data = np.where(null, 0, vals).astype(t.physical_np_dtype(dt))
    elif isinstance(dt, (t.FloatType, t.DoubleType)):
        data = np.where(null, 0, vals).astype(t.physical_np_dtype(dt))
    elif isinstance(dt, t.BooleanType):
        data = np.where(null, False, vals != 0)
    elif isinstance(dt, t.DecimalType) and vals.dtype.kind in "iu":
        return column_from_values(
            [None if n else int(v) for v, n in zip(vals.tolist(),
                                                   null.tolist())], dt)
    else:
        raise TypeError(f"Expected a {dt.simple_string} dtype, got "
                        f"{vals.dtype} (column {name})")
    return HostColumn(data, validity, dt)


def _is_na(v) -> bool:
    return v is None or (isinstance(v, float) and v != v) or \
        type(v).__name__ in ("NAType", "NaTType")


def series_column(s, dt: t.DataType, name: str = "") -> HostColumn:
    """A pandas Series as a column of `dt` (from_pandas' coercions)."""
    import pandas as pd
    if isinstance(s.dtype, np.dtype) and s.dtype.kind in "iufb":
        vals = s.to_numpy()
        null = np.isnan(vals) if vals.dtype.kind == "f" \
            else np.zeros(len(vals), bool)
        return _numeric_column(vals, null, dt, name)
    if isinstance(s.dtype, pd.DatetimeTZDtype) or (
            isinstance(s.dtype, np.dtype) and s.dtype.kind == "M"):
        if isinstance(s.dtype, pd.DatetimeTZDtype):
            s = s.dt.tz_convert("UTC").dt.tz_localize(None)
        us = s.to_numpy("datetime64[us]")
        null = np.isnat(us)
        lane = us.view(np.int64)
        if isinstance(dt, t.DateType):
            lane = np.floor_divide(lane, 86_400_000_000)
        elif not isinstance(dt, t.TimestampType):
            raise TypeError(f"Unsupported cast from timestamp to "
                            f"{dt.simple_string} (column {name})")
        data = np.where(null, 0, lane).astype(t.physical_np_dtype(dt))
        return HostColumn(data, ~null if null.any() else None, dt)
    if isinstance(dt, t.StringType) and isinstance(s.dtype, pd.StringDtype):
        codes, uniq = pd.factorize(s, use_na_sentinel=True)
        null = codes < 0
        return string_column(np.where(null, None, np.asarray(
            uniq, object)[np.maximum(codes, 0)]) if len(codes) else
            np.array([], object))
    vals = [None if _is_na(v) else v for v in s.tolist()]
    return column_from_values(vals, dt)


def from_frame(df, schema: t.StructType) -> HostBatch:
    """A result DataFrame as a batch of `schema`, columns by name."""
    cols = []
    for f in schema.fields:
        if f.name not in df.columns:
            raise KeyError(f"name {f.name!r} present in the specified "
                           "schema is not found in the columns or index")
        cols.append(series_column(df[f.name], f.data_type, f.name))
    return HostBatch(cols, schema.names)


def _spans(starts, n: int):
    edges = list(starts) + [n]
    return list(zip(edges[:-1], edges[1:]))


# ---------------------------------------------------------------------------
# Grouping by Spark's keys (numpy, in the engine)
# ---------------------------------------------------------------------------

def group_order(hb: HostBatch, names: Sequence[str]):
    """(row order, group starts) of `hb`'s rows grouped by the key
    columns `names`: equal keys by Spark's equality (NaN = NaN, -0.0 =
    0.0, null apart from every value), the groups in key order (each key
    ascending, NaN above every number, null last), rows in input order
    within a group."""
    n = hb.num_rows
    if not names:
        return np.arange(n, dtype=np.int64), np.zeros(1 if n else 0,
                                                      np.int64)
    lanes = []
    for name in names:
        c = hb.column_by_name(name)
        lanes.append((~c.valid_mask()).astype(np.int64))
        lanes += H.order_lanes(c)
    ids, count = H.factorize(lanes)
    order = np.argsort(ids, kind="stable")
    return order, np.searchsorted(ids[order], np.arange(count))


def _group_frames(hb: HostBatch, starts, target: int):
    """Consecutive whole groups of the grouped batch `hb`, about `target`
    rows a frame: (frame batch, group starts within it, [first row of
    each group in hb])."""
    spans = _spans(starts, hb.num_rows)
    i = 0
    while i < len(spans):
        lo = spans[i][0]
        j = i + 1
        while j < len(spans) and spans[j][1] - lo <= target:
            j += 1
        hi = spans[j - 1][1]
        local = [a - lo for a, _b in spans[i:j]]
        yield hb.slice(lo, hi - lo), local, [a for a, _b in spans[i:j]]
        i = j


def _key_value(v):
    """A group key's Python value in the reference's pairing order:
    numbers first, then NaN, then null; -0.0 as 0.0."""
    if v is None:
        return (2, 0)
    if isinstance(v, float):
        if v != v:
            return (1, 0)
        return (0, v + 0.0)
    return (0, v)


# ---------------------------------------------------------------------------
# The execs
# ---------------------------------------------------------------------------

class MapInPandasExec(HostNode):
    """df.mapInPandas over a forked worker: fn receives an iterator of
    pandas DataFrames (one a child batch) and yields DataFrames."""

    def __init__(self, fn: Callable, schema: t.StructType, child: HostNode):
        super().__init__(child)
        self.fn = fn
        self._schema = schema

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    def _execute(self, ctx):
        fn, schema = self.fn, self._schema

        def body(frames):
            for df in fn(to_frame(b[0]) for b, _x in frames):
                yield from_frame(df, schema)

        frames = (((hb,), None) for hb in self.child.execute(ctx)
                  if hb.num_rows)
        yield from worker_stream(ctx, frames, body)

    def describe(self):
        return f"MapInPandasExec[{getattr(self.fn, '__name__', 'fn')}]"


def _udf_schema(udfs) -> t.StructType:
    return t.StructType([t.StructField(name, dt, True)
                         for _f, _c, name, dt in udfs])


def _inputs(udfs) -> List[str]:
    """The input column names of (fn, in_cols, name, dtype) UDFs, once
    each, in first-use order."""
    out: List[str] = []
    for _f, cols, _n, _t in udfs:
        out += [c for c in cols if c not in out]
    return out


class ArrowEvalPythonExec(HostNode):
    """Scalar pandas UDFs appended as projection outputs.

    udfs: [(fn, input column names, output name, output type)] — each fn
    maps pandas.Series... -> pandas.Series of the output type (the
    GpuArrowEvalPythonExec scalar-UDF contract).  Only the inputs cross
    the wire; the child's columns stay in the engine."""

    def __init__(self, udfs: Sequence[Tuple[Callable, Sequence[str], str,
                                            t.DataType]],
                 child: HostNode):
        super().__init__(child)
        self.udfs = list(udfs)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType(list(self.child.output_schema.fields) +
                            list(_udf_schema(self.udfs).fields))

    def _execute(self, ctx):
        udfs, schema = self.udfs, _udf_schema(self.udfs)
        inputs = _inputs(udfs)
        pending = collections.deque()

        def body(frames):
            import pandas as pd
            for b, _x in frames:
                df = to_frame(b[0])
                yield from_frame(pd.DataFrame(
                    {name: pd.Series(fn(*[df[c] for c in cols]))
                     for fn, cols, name, _dt in udfs}), schema)

        def frames():
            for hb in self.child.execute(ctx):
                if hb.num_rows:
                    pending.append(hb)
                    yield (hb.select(inputs),), None

        for out in worker_stream(ctx, frames(), body):
            hb = pending.popleft()
            yield HostBatch(hb.columns + out.columns, hb.names + out.names)

    def describe(self):
        names = [n for _f, _c, n, _t in self.udfs]
        return f"ArrowEvalPythonExec[{', '.join(names)}]"


class _GroupedPandasExec(HostNode):
    """Shared scaffold of the grouped execs: materialize the child, group
    it by Spark's keys in the engine, and send whole groups, several a
    frame, to the worker."""

    def _grouped(self, ctx, names, order_names=()):
        """(the child's rows in group order, group starts), None when
        the child is empty.  `order_names` sort each group stably, as
        pandas' sort_values does (a NaN or null key last)."""
        hb = self._table(ctx)
        if hb.num_rows == 0:
            return None
        order, starts = group_order(hb, names)
        if order_names:
            flags = np.zeros(hb.num_rows, np.int64)
            flags[starts[1:]] = 1
            lanes = [np.cumsum(flags)]          # the group, by position
            for name in order_names:
                c = hb.column_by_name(name)
                na = ~c.valid_mask()
                if c.data.dtype.kind == "f":
                    na = na | np.isnan(c.data)
                lane = np.where(na, 0, H.order_lane(c))
                lanes += [na[order].astype(np.int64), lane[order]]
            order = order[H.lexsort_rows(lanes)]
        return take_rows(hb, order), starts

    def _frames(self, ctx, grouped, columns):
        target = ctx.conf.batch_size_rows
        hb, starts = grouped
        for part, local, firsts in _group_frames(hb, starts, target):
            yield part.select(columns), local, firsts


class FlatMapGroupsInPandasExec(_GroupedPandasExec):
    """groupBy(keys).applyInPandas(fn, schema) — fn maps each group's
    pandas.DataFrame to a result DataFrame (reference
    GpuFlatMapGroupsInPandasExec)."""

    def __init__(self, key_names: Sequence[str], fn: Callable,
                 schema: t.StructType, child: HostNode):
        super().__init__(child)
        self.key_names = list(key_names)
        self.fn = fn
        self._schema = schema

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    def _execute(self, ctx):
        grouped = self._grouped(ctx, self.key_names)
        if grouped is None:
            return
        fn, schema = self.fn, self._schema

        def body(frames):
            for b, local in frames:
                outs = [from_frame(fn(to_frame(b[0].slice(lo, hi - lo))),
                                   schema)
                        for lo, hi in _spans(local, b[0].num_rows)]
                yield concat_batches(outs, schema)

        names = list(self.child.output_schema.names)
        frames = (((part,), local) for part, local, _f in
                  self._frames(ctx, grouped, names))
        for out in worker_stream(ctx, frames, body):
            if out.num_rows:
                yield out

    def describe(self):
        return (f"FlatMapGroupsInPandasExec[{self.key_names}, "
                f"{getattr(self.fn, '__name__', 'fn')}]")


class AggregateInPandasExec(_GroupedPandasExec):
    """groupBy(keys).agg(pandas UDAF): each agg fn maps the group's
    input Series to ONE scalar; output = key columns + one column per
    agg, one row per group (reference GpuAggregateInPandasExec).  The
    key columns are each group's first row in the engine.

    aggs: [(fn, input column names, output name, output type)]."""

    def __init__(self, key_names: Sequence[str],
                 aggs: Sequence[Tuple[Callable, Sequence[str], str,
                                      t.DataType]],
                 child: HostNode):
        super().__init__(child)
        self.key_names = list(key_names)
        self.aggs = list(aggs)

    @property
    def output_schema(self) -> t.StructType:
        schema = self.child.output_schema
        fields = [schema.fields[schema.field_index(n)]
                  for n in self.key_names]
        return t.StructType(fields + list(_udf_schema(self.aggs).fields))

    def _execute(self, ctx):
        grouped = self._grouped(ctx, self.key_names)
        if grouped is None:
            return
        aggs, schema = self.aggs, _udf_schema(self.aggs)
        keys = grouped[0].select(self.key_names)
        pending = collections.deque()

        def body(frames):
            import pandas as pd
            for b, local in frames:
                rows = {name: [] for _f, _c, name, _t in aggs}
                for lo, hi in _spans(local, b[0].num_rows):
                    df = to_frame(b[0].slice(lo, hi - lo))
                    for fn, cols, name, _dt in aggs:
                        rows[name].append(fn(*[df[c] for c in cols]))
                yield from_frame(pd.DataFrame(rows), schema)

        def frames():
            for part, local, firsts in self._frames(
                    ctx, grouped, _inputs(aggs)):
                pending.append(firsts)
                yield (part,), local

        for out in worker_stream(ctx, frames(), body):
            k = take_rows(keys, np.asarray(pending.popleft(), np.int64))
            yield HostBatch(k.columns + out.columns, k.names + out.names)

    def describe(self):
        return (f"AggregateInPandasExec[{self.key_names}, "
                f"{[n for _f, _c, n, _t in self.aggs]}]")


class WindowInPandasExec(_GroupedPandasExec):
    """Pandas window UDFs over unbounded partition frames: each fn maps
    the partition's input Series to either a Series of the partition's
    length or one scalar (broadcast) — the two shapes the reference's
    GpuWindowInPandasExec supports for UNBOUNDED PRECEDING/FOLLOWING.

    windows: [(fn, input column names, output name, output type)];
    output = child columns + one per window fn, rows ordered by
    (partition keys, order keys)."""

    def __init__(self, partition_names: Sequence[str],
                 order_names: Sequence[str],
                 windows: Sequence[Tuple[Callable, Sequence[str], str,
                                         t.DataType]],
                 child: HostNode):
        super().__init__(child)
        self.partition_names = list(partition_names)
        self.order_names = list(order_names)
        self.windows = list(windows)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType(list(self.child.output_schema.fields) +
                            list(_udf_schema(self.windows).fields))

    def _execute(self, ctx):
        grouped = self._grouped(ctx, self.partition_names, self.order_names)
        if grouped is None:
            return
        windows, schema = self.windows, _udf_schema(self.windows)
        rows = grouped[0]
        pending = collections.deque()

        def body(frames):
            import pandas as pd
            for b, local in frames:
                outs = []
                for lo, hi in _spans(local, b[0].num_rows):
                    df = to_frame(b[0].slice(lo, hi - lo))
                    cols = {}
                    for fn, in_cols, name, _dt in windows:
                        out = fn(*[df[c] for c in in_cols])
                        if not isinstance(out, pd.Series):
                            out = pd.Series([out] * len(df))
                        cols[name] = out.reset_index(drop=True)
                    outs.append(from_frame(pd.DataFrame(cols), schema))
                yield concat_batches(outs, schema)

        def frames():
            for part, local, firsts in self._frames(
                    ctx, grouped, _inputs(windows)):
                pending.append((firsts[0], part.num_rows))
                yield (part,), local

        for out in worker_stream(ctx, frames(), body):
            lo, n = pending.popleft()
            hb = rows.slice(lo, n)
            yield HostBatch(hb.columns + out.columns, hb.names + out.names)

    def describe(self):
        return (f"WindowInPandasExec[{self.partition_names}, "
                f"{[n for _f, _c, n, _t in self.windows]}]")


class FlatMapCoGroupsInPandasExec(HostNode):
    """cogroup(left, right).applyInPandas(fn, schema) — the reference's
    GpuFlatMapCoGroupsInPandasExec over the worker: both sides
    materialize and group by Spark's keys, the groups pair by key as a
    full outer join over the two key sets (in key order; a key on one
    side only pairs with an empty frame), and each pair is one frame."""

    def __init__(self, left_keys: Sequence[str],
                 right_keys: Sequence[str], fn: Callable,
                 schema: t.StructType, left: HostNode, right: HostNode):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self._schema = schema

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    @staticmethod
    def _keyed(hb: HostBatch, names):
        """{key tuple: the group's rows} of one side."""
        if hb.num_rows == 0:
            return {}
        order, starts = group_order(hb, names)
        hb = take_rows(hb, order)
        keys = hb.select(names)
        out = {}
        for lo, hi in _spans(starts, hb.num_rows):
            kt = tuple(_key_value(v[0]) for v in
                       keys.slice(lo, 1).to_pydict().values())
            out[kt] = hb.slice(lo, hi - lo)
        return out

    def _execute(self, ctx):
        left, right = self._table(ctx, 0), self._table(ctx, 1)
        lg = self._keyed(left, self.left_keys)
        rg = self._keyed(right, self.right_keys)
        keys = sorted(set(lg) | set(rg))
        if not keys:
            return
        l_empty, r_empty = left.slice(0, 0), right.slice(0, 0)
        fn, schema = self.fn, self._schema

        def body(frames):
            for (lb, rb), _x in frames:
                yield from_frame(fn(to_frame(lb), to_frame(rb)), schema)

        frames = (((lg.get(k, l_empty), rg.get(k, r_empty)), None)
                  for k in keys)
        for out in worker_stream(ctx, frames, body):
            if out.num_rows:
                yield out

    def describe(self):
        return (f"FlatMapCoGroupsInPandasExec[{self.left_keys}|"
                f"{self.right_keys}, "
                f"{getattr(self.fn, '__name__', 'fn')}]")

