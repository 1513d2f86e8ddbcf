"""Whole-plan capture: one CUDA graph per query.

Counterpart of spark_rapids_tpu/exec/compiled.py.  The reference traces
the whole physical plan once and hands XLA one program; a warm query is
one dispatch and one fetch whatever the plan's depth.  On the H100 the
program is a CUDA graph: the eager engine issues one launch at a time
from Python, batch by batch, and the card idles between them; a graph
replays every launch of the plan from one call.

How it works:
  * Leaf `HostScanExec`s read the shared scan upload (one device copy a
    hot source table, which warm queries reuse; `_shared_scan_upload`).
  * `CompiledPlan` runs `root.execute` over the leaf lanes once as a
    warm-up on a side stream, then again under `torch.cuda.graph`, both
    under runtime/capture.capture_scope: operators take their sync-free
    forms (device row counts, static capacities), and a plan that reads
    a device value on the host raises `HostDecision` and falls back to
    the eager engine (`collect_with_fallback`), as the reference's
    tracer errors do.  Every other exception propagates.
  * A replay writes the lifted literal values into their 0-d slots
    (plan/expressions set_literal_bindings), copies leaf lanes that are
    not the graph's own into its static inputs, replays, re-adds the
    host metrics recorded at capture (and the kernel launches recorded
    there as `graph_launches.<kernel>` metrics: the wrappers' LAUNCHES
    count only launches they make), and re-wraps the static outputs by
    the output specs recorded there.  It holds the graph until the
    outputs are fetched: the next replay overwrites them.
  * On the CPU (the tests) there is no graph: the capture is one run
    under the detector, and a replay re-executes the captured plan with
    the literals bound, so the CPU makes the card's capture decisions.
  * Two plans that differ only in lifted literals share one graph
    (`plan_structure_key` erases their values; the identity anchors keep
    a structurally equal plan over other tables off it).
  * `SplitCompiledPlan` cuts a plan at the seams where live rows
    collapse (the input of its topmost aggregate and the aggregate): one
    graph a segment, keyed by its input bucket, with the seam's count
    read on the host between graphs (`seamSplitMinRows`).  The compile
    service (runtime/compile_service.py) captures the next segment's
    predicted buckets in the background.

Left out, with the ROADMAP item that ports them: the mesh SPMD path
(`_shard_batch`, `session_mesh`, item 9); the cost surface and the
profile-segments plane (`_compiled_cost`, `analysis_hbm_bytes`,
`_record_segment`, `make_jaxpr`, item 10).  The reference's persistent
XLA cache has no counterpart (config.RESOLVED `compile.cacheDir`): a
CUDA graph does not outlive its process; the kernels' nvcc builds in
`_build/` persist.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar.device import (DeviceBatch, DeviceColumn, NarrowColumn,
                               bucket_capacity, column_to_device,
                               narrowed_lane)
from ..columnar.host import HostBatch
from ..config import TpuConf
from ..runtime.capture import (HostDecision, capture_scope, graph_staging,
                               map_capture_error, recording_scope)
from .plan import (ExecContext, HostScanExec, PlanNode, query_scope,
                   set_trace_batches, trace_batches)

_DISPATCH_FLOOR: Dict[str, float] = {}
_DISPATCH_FLOOR_LOCK = threading.Lock()


def dispatch_floor_ms(device: torch.device) -> float:
    """The floor of one whole-plan dispatch on `device`, in ms: on the
    card one replay of a trivial captured graph plus a synchronize, on
    the CPU one trivial op; best of five, cached per device."""
    key = str(device)
    v = _DISPATCH_FLOOR.get(key)
    if v is not None:
        return v
    with _DISPATCH_FLOOR_LOCK:
        v = _DISPATCH_FLOOR.get(key)
        if v is not None:
            return v
        x = torch.zeros(8, dtype=torch.int32, device=device)
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                x + 1
            torch.cuda.current_stream(device).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                y = x + 1
            step = g.replay
        else:
            g = y = None

            def step():
                x + 1
        step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - t0)
        if g is not None:
            del y
            g.reset()
        v = _DISPATCH_FLOOR[key] = best * 1e3
    return v


# ---------------------------------------------------------------------------
# Leaves: flattening batches into lanes and back
# ---------------------------------------------------------------------------

def _find_scans(root: PlanNode) -> List[PlanNode]:
    """Leaves whose batches become graph inputs: host scans (the shared
    upload) and the split seams' device-resident leaves."""
    out, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, (HostScanExec, DeviceResidentScanExec)):
            out.append(n)
        for c in n.children:
            walk(c)
    walk(root)
    return out


def _flatten_batch(db: DeviceBatch):
    """-> (tensors, spec): the batch's lanes in a fixed order, and what
    rebuilds it from them (`_rebuild_batch`).  A selection vector rides
    along (dropping it would turn its liveness into a prefix's); a thin
    batch must be materialized first."""
    assert db.thin is None, "a thin batch crosses a graph boundary"
    tensors, cols = [], []
    for c in db.columns:
        tensors += [c.stored, c.validity]
        if c.hi is not None:
            tensors.append(c.hi)
        if c.offsets is not None:          # a ragged column's lanes
            tensors += [c.offsets, c.elem_valid]
        cols.append((isinstance(c, NarrowColumn), c.dtype, c.dictionary,
                     c.value_range, c.hi is not None,
                     getattr(c, "enc", None), c.offsets is not None))
    static_rows = db.num_rows if isinstance(db.num_rows, int) else None
    if static_rows is None:
        tensors.append(db.num_rows)
    has_sel = db.sel is not None
    if has_sel:
        tensors.append(db.sel)
    return tensors, (tuple(cols), tuple(db.names), static_rows, has_sel)


def _rebuild_batch(tensors, spec, i: int) -> Tuple[DeviceBatch, int]:
    """A fresh batch over tensors[i:] by its spec; -> (batch, next i).
    Fresh column objects: nothing a run caches on a column (a narrow
    lane's widened copy) survives into the next run."""
    cols_spec, names, static_rows, has_sel = spec
    cols = []
    for narrow, dtype, dictionary, rng, has_hi, enc, ragged in cols_spec:
        stored, valid = tensors[i], tensors[i + 1]
        i += 2
        hi = offsets = elem_valid = None
        if has_hi:
            hi = tensors[i]
            i += 1
        if ragged:
            offsets, elem_valid = tensors[i], tensors[i + 1]
            i += 2
        cols.append(NarrowColumn(stored, valid, dtype, dictionary, rng, enc)
                    if narrow else
                    DeviceColumn(stored, valid, dtype, dictionary, rng, hi,
                                 offsets, elem_valid))
    num_rows = static_rows
    if static_rows is None:
        num_rows = tensors[i]
        i += 1
    sel = None
    if has_sel:
        sel = tensors[i]
        i += 1
    return DeviceBatch(cols, num_rows, list(names), sel), i


# ---------------------------------------------------------------------------
# The shared scan upload
# ---------------------------------------------------------------------------

#: key -> [weakref(source table), {column key: DeviceColumn}, bytes];
#: insertion order is the LRU order (a hit re-inserts)
_SCAN_UPLOAD_CACHE: Dict[tuple, list] = {}
_SCAN_UPLOAD_LOCK = threading.Lock()
#: table entries the byte cap evicted (the reference's
#: tpu_scan_upload_evictions_total)
SCAN_UPLOAD_EVICTIONS = {"count": 0}


def _shared_scan_upload(node: HostScanExec, conf: TpuConf,
                        device: torch.device) -> List[DeviceBatch]:
    """A scan's batches from one device copy PER SOURCE TABLE (not per
    plan): every plan over the same table shares its uploaded columns,
    a column uploaded once whichever scans prune to it (the reference's
    buffer-cache role for hot inputs).  Weakref-keyed, so device memory
    goes with the table; LRU byte-capped by `sql.scan.uploadCacheBytes`
    (0 uploads afresh every time).  The key holds the encoding
    discriminant, and a column's key whether it uploads FOR-narrowed:
    plans negotiated differently never share a copy."""
    from ..config import SCAN_UPLOAD_CACHE_BYTES
    from ..ops.encodings import encoding_discriminant
    cap_bytes = conf.get(SCAN_UPLOAD_CACHE_BYTES)
    enc = node.encoded_cols
    src = node._source_table
    key = (id(src), str(device), node.batch_rows,
           encoding_discriminant(conf))
    cols = None
    if cap_bytes:
        with _SCAN_UPLOAD_LOCK:
            hit = _SCAN_UPLOAD_CACHE.pop(key, None)
            if hit is not None and hit[0]() is src:
                _SCAN_UPLOAD_CACHE[key] = hit        # re-insert: now MRU
                cols = hit[1]
    fresh = cols is None
    if fresh:
        cols = {}
    added = 0
    out = []
    for off, rows, hb in node.host_batches():
        cap = bucket_capacity(max(rows, 1), conf)
        batch_cols = []
        for i, name in enumerate(hb.names):
            narrow = enc is not None and name in enc
            ck = (name, off, rows, cap, narrow)
            c = cols.get(ck)
            if c is None:
                lane = narrowed_lane(node.table, name, off, rows) \
                    if narrow else None
                c = cols[ck] = column_to_device(hb.columns[i], cap, device,
                                                lane)
                added += c.nbytes()
            batch_cols.append(c)
        out.append(DeviceBatch(batch_cols, hb.num_rows, list(hb.names)))
    if not cap_bytes:
        return out
    with _SCAN_UPLOAD_LOCK:
        if fresh:
            try:
                ref = weakref.ref(src, lambda _r, k=key:
                                  _SCAN_UPLOAD_CACHE.pop(k, None))
            except TypeError:
                return out
            _SCAN_UPLOAD_CACHE[key] = [ref, cols, added]
        elif key in _SCAN_UPLOAD_CACHE:
            _SCAN_UPLOAD_CACHE[key][2] += added
        total = sum(e[2] for e in _SCAN_UPLOAD_CACHE.values())
        while total > cap_bytes and len(_SCAN_UPLOAD_CACHE) > 1:
            k = next(iter(_SCAN_UPLOAD_CACHE))
            if k == key:                       # never evict this one
                break
            total -= _SCAN_UPLOAD_CACHE.pop(k)[2]
            SCAN_UPLOAD_EVICTIONS["count"] += 1
    return out


def clear_caches() -> None:
    """Drop the scan uploads and the cached graphs (tests, and a card
    that needs its memory back)."""
    with _SCAN_UPLOAD_LOCK:
        _SCAN_UPLOAD_CACHE.clear()
    with _PLAN_CACHE_LOCK:
        entries = list(_PLAN_CACHE.values())
        _PLAN_CACHE.clear()
        _NO_CAPTURE.clear()
    for prog, _anchors in entries:
        prog.release()


# ---------------------------------------------------------------------------
# Constant-lifted canonical plan keys and the process-wide graph cache
# ---------------------------------------------------------------------------
# Two queries that differ only in literals (dashboard traffic, reruns,
# parameterized filters) capture the same graph once the literal values
# are read from slots.  `plan_structure_key` canonicalizes the physical
# plan: node structure, canonical expression fingerprints (lifted values
# erased), node extras and the session conf; `_PLAN_CACHE` maps it, with
# the input signature, to the captured program.  Identity anchors (the
# source tables, the input dictionaries) guard the host data the graph
# baked in: a hit needs the SAME objects.

def _canon_fp(e) -> str:
    fp = e.__dict__.get("_canon_fp_cache")
    if fp is None:
        fp = e.__dict__["_canon_fp_cache"] = e.canonical_fingerprint()
    return fp


def _collect_lits(e, lift_ok: bool, out: list) -> None:
    """Preorder liftable literals, mirroring canonical_fingerprint: the
    slot order is the contract between the key and the slots."""
    from ..plan.expressions import Literal
    if isinstance(e, Literal):
        if lift_ok and e.lift_type_ok():
            out.append(e)
        return
    for c in e.children:
        _collect_lits(c, type(e).lifts_literal_children, out)


def _node_exprs(node) -> Optional[list]:
    """The bound expression trees a node evaluates as they stand
    (projections, predicates, aggregate and join keys), in a fixed
    order: the trees whose canonical fingerprints may erase lifted
    values.  Aggregate inputs are not here: the aggregation evaluates
    derived wrappings of them, so their literals stay keyed by value
    (`_node_extras`).  None for a node class the key does not cover
    (its plans keep per-holder caching only).  The plan-level CSE of
    aggregate subtrees (plan/overrides.py `_subtree_fp`) walks with the
    same two functions."""
    from .adaptive import AdaptiveShuffledJoinExec
    from .distinct import DistinctAggregateExec
    from .join import CrossJoinExec, HashJoinExec
    from .plan import (CoalesceBatchesExec, ExpandExec, FilterExec,
                       HashAggregateExec, LimitExec, ProjectExec, RangeExec,
                       SampleExec, SortExec, TopNExec, UnionExec)
    if isinstance(node, ProjectExec):
        return list(node.exprs)
    if isinstance(node, FilterExec):
        return [node.condition]
    if isinstance(node, (HashAggregateExec, DistinctAggregateExec)):
        return list(node.key_exprs)
    if isinstance(node, HashJoinExec):
        return (list(node.left_keys) + list(node.right_keys)
                + list(node.probe_conds) + list(node.build_conds))
    if isinstance(node, AdaptiveShuffledJoinExec):
        return list(node.left_keys) + list(node.right_keys)
    if isinstance(node, ExpandExec):
        return [e for p in node.projections for e in p]
    if isinstance(node, (HostScanExec, DeviceResidentScanExec, SortExec,
                         TopNExec, LimitExec, UnionExec, CoalesceBatchesExec,
                         RangeExec, SampleExec, CrossJoinExec)):
        return []
    return None


def _node_extras(node) -> tuple:
    """Non-expression structure that changes the captured graph."""
    from ..plan.expressions import Expression
    from .plan import (CoalesceBatchesExec, LimitExec, RangeExec,
                       SampleExec, SortExec, TopNExec)
    extras: list = []
    if isinstance(node, (SortExec, TopNExec)):
        extras.append(tuple(node.keys))
    if isinstance(node, (LimitExec, TopNExec)):
        extras.append(node.limit)
    if isinstance(node, CoalesceBatchesExec):
        extras.append((node.target_rows, node.require_single))
    if isinstance(node, RangeExec):
        extras.append((node.start, node.end, node.step, node.col_name,
                       node.batch_rows))
    if isinstance(node, SampleExec):
        extras.append((node.fraction, node.seed))
    if isinstance(node, HostScanExec):
        extras.append((node.batch_rows, tuple(node.table.names),
                       None if node.encoded_cols is None
                       else tuple(sorted(node.encoded_cols))))
    jt = getattr(node, "join_type", None)
    if jt is not None:
        extras.append(("join", jt, getattr(node, "lazy_sel", None),
                       getattr(node, "thin_payload", None)))
    names = getattr(node, "names", None) or getattr(node, "key_names", None)
    if names is not None:
        extras.append(tuple(names))
    extras.append(getattr(node, "shared_readers", 1))
    agg_sig = []
    for fn, name in getattr(node, "aggs", ()) or ():
        params = tuple(sorted(
            (k, repr(v)) for k, v in fn.__dict__.items()
            if k != "_shims" and not isinstance(v, Expression)))
        kids = tuple(c.fingerprint()
                     for c in (getattr(fn, "child", None),
                               getattr(fn, "child2", None))
                     if c is not None)
        agg_sig.append((type(fn).__name__, name, params, kids))
    if agg_sig:
        extras.append(tuple(agg_sig))
    return tuple(extras)


def collect_plan_literals(root: PlanNode) -> Optional[List[object]]:
    """Every liftable Literal of a physical plan in canonical preorder,
    or None when a node class is outside the key (such plans skip the
    process-wide cache)."""
    out: list = []
    seen = set()

    def walk(node):
        if id(node) in seen:
            return True
        seen.add(id(node))
        exprs = _node_exprs(node)
        if exprs is None:
            return False
        for e in exprs:
            _collect_lits(e, True, out)
        return all(walk(c) for c in node.children)

    return out if walk(root) else None


def plan_structure_key(root: PlanNode, conf: TpuConf) -> Optional[tuple]:
    """Canonical structural key of a device plan (lifted literal values
    erased), or None for uncovered plans.  The resolved kernel tier and
    encoding policy are in it beside the raw conf."""
    from ..ops.encodings import encoding_discriminant
    from ..ops.hopper import kernel_tier
    parts: list = []
    seen: dict = {}

    def walk(node):
        if id(node) in seen:
            # a shared subtree: the revisit is marked by position
            parts.append(("shared", seen[id(node)]))
            return True
        seen[id(node)] = len(seen)
        exprs = _node_exprs(node)
        if exprs is None:
            return False
        parts.append((type(node).__name__,
                      tuple(_canon_fp(e) for e in exprs),
                      _node_extras(node), len(node.children)))
        return all(walk(c) for c in node.children)

    if not walk(root):
        return None
    conf_sig = tuple(sorted((k, str(v)) for k, v in conf._raw.items()))
    return (tuple(parts), conf_sig, kernel_tier(conf),
            encoding_discriminant(conf))


def _plan_anchors(pairs) -> Optional[list]:
    """Weak references to the host objects the graph specializes on: the
    scans' source tables and every input dictionary."""
    objs = []
    for node, dbs in pairs:
        if isinstance(node, HostScanExec):
            objs.append(node._source_table)
        for db in dbs:
            for c in db.columns:
                if c.dictionary is not None:
                    objs.append(c.dictionary)
    try:
        return [weakref.ref(o) for o in objs]
    except TypeError:
        return None


def _anchors_match(anchors, pairs) -> bool:
    cur = _plan_anchors(pairs)
    if cur is None or len(cur) != len(anchors):
        return False
    return all(a() is c() and a() is not None for a, c in zip(anchors, cur))


#: canonical key -> (_Program, anchors); insertion order is the LRU order
_PLAN_CACHE: Dict[tuple, tuple] = {}
_PLAN_CACHE_LOCK = threading.Lock()


def _plan_cache_get(key, pairs):
    with _PLAN_CACHE_LOCK:
        entry = _PLAN_CACHE.pop(key, None)
        if entry is not None:
            _PLAN_CACHE[key] = entry             # MRU
    if entry is None or not _anchors_match(entry[1], pairs):
        return None
    return entry[0]


def _plan_cache_put(key, prog: "_Program", anchors, conf: TpuConf) -> None:
    """Insert, and release the graphs (and their pools) of the entries
    past `compile.planCacheEntries`."""
    from ..config import PLAN_CACHE_ENTRIES
    bound = conf.get(PLAN_CACHE_ENTRIES)
    evicted = []
    with _PLAN_CACHE_LOCK:
        old = _PLAN_CACHE.pop(key, None)
        if old is not None and old[0] is not prog:
            evicted.append(old[0])
        _PLAN_CACHE[key] = (prog, anchors)
        while len(_PLAN_CACHE) > bound:
            evicted.append(_PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))[0])
    for p in evicted:
        p.release()


# ---------------------------------------------------------------------------
# One captured program
# ---------------------------------------------------------------------------

class _QuietInjector:
    """The active chaos injector while a plan is captured: disabled, so
    no test fault is baked into a graph (the conf-less kernel election
    would otherwise reach the query's injector)."""
    enabled = False
    log: tuple = ()

    def has_site(self, site: str) -> bool:
        return False

    def fire(self, site: str, **info) -> None:
        return None


_QUIET = _QuietInjector()


def _trace_context(ctx: ExecContext) -> ExecContext:
    """The context a capture runs under: an unlimited budget (the graph
    owns its memory: spilling a captured batch is meaningless), no
    runtime bloom filter (its sizing reads host row counts), no injected
    retry OOM or test fault, and private metrics (copied back as numbers
    and re-added on every replay)."""
    from ..config import (HBM_BUDGET_BYTES, RUNTIME_FILTER_ENABLED,
                          TEST_FAULTS, TEST_INJECT_RETRY_OOM)
    raw = dict(ctx.conf._raw)
    raw[HBM_BUDGET_BYTES.key] = 1 << 62
    raw[RUNTIME_FILTER_ENABLED.key] = False
    raw[TEST_INJECT_RETRY_OOM.key] = 0
    raw[TEST_FAULTS.key] = ""
    return ExecContext(TpuConf(raw), ctx.device)


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.dtype == b.dtype and a.stride() == b.stride())


class _Program:
    """A captured whole plan: its static inputs, literal slots, graph (on
    the card) or re-run (on the CPU), static outputs and output specs,
    and what the capture recorded: the host metrics, the kernel launch
    counts, the pinned host constants and the look-back scratch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.inputs: List[torch.Tensor] = []
        self.in_sig: tuple = ()
        self.slots: List[torch.Tensor] = []
        self.graph = None
        self.run = None
        self.outputs: List[torch.Tensor] = []
        self.out_specs: list = []
        self.host_metrics: Dict[str, object] = {}
        self.launches: Dict[str, int] = {}
        self.stage: dict = {}
        self.scratch = None
        self.pool_bytes = 0
        self.capture_ms = 0.0
        self.stages: Dict[str, float] = {}
        self.lock = threading.Lock()

    def bind(self, flat_in: List[torch.Tensor], values: list) -> None:
        """Leaf lanes into the static inputs (device to device, skipped
        where they are the graph's own), literal values into the
        slots."""
        for static, cur in zip(self.inputs, flat_in):
            if not _same_tensor(static, cur):
                static.copy_(cur)
        for slot, v in zip(self.slots, values):
            slot.fill_(v)

    def replay(self) -> List[DeviceBatch]:
        """One replay (the caller holds `lock`): the output batches."""
        if self.graph is not None:
            self.graph.replay()
            flat, specs = self.outputs, self.out_specs
        else:
            # the CPU's program: the captured plan again, on its capture
            # path, with the slots bound
            with capture_scope(self.device, detect=False):
                flat, specs = self.run()
        outs, i = [], 0
        for spec in specs:
            db, i = _rebuild_batch(flat, spec, i)
            outs.append(db)
        return outs

    def release(self) -> None:
        """Free the graph, its pool and its static buffers (whoever still
        holds this program captures again)."""
        with self.lock:
            if self.graph is not None:
                self.outputs = []
                self.graph.reset()
                self.graph = None
            self.run = None
            self.scratch = None
            self.stage = {}
            self.inputs = []
            self.slots = []


def _root_stream(root: PlanNode, ctx: ExecContext):
    """The root's own batch stream: the per-batch fault sites a query
    installs on its root fire at each fetch instead, never inside a
    capture."""
    return type(root).execute(root, ctx)


class CompiledPlan:
    """A device plan captured whole, bound to its leaf scans."""

    def __init__(self, root: PlanNode, conf: TpuConf,
                 leaf_overrides: Optional[Dict[int, list]] = None):
        from ..config import COMPILE_CONST_LIFT
        self.root = root
        self.conf = conf
        # a background capture runs over placeholder leaf batches (id(leaf)
        # -> batches) without touching the shared plan tree
        self._leaf_overrides = dict(leaf_overrides or {})
        self._lift = bool(conf.get(COMPILE_CONST_LIFT))
        self._literals = (collect_plan_literals(root) or []) \
            if self._lift else []
        self._prog: Optional[_Program] = None
        self._cache_key = None
        self._fresh = False
        self._held: Optional[_Program] = None

    # -- leaves -----------------------------------------------------------
    def _leaf_batches(self, ctx: ExecContext):
        pairs = []
        for node in _find_scans(self.root):
            override = self._leaf_overrides.get(id(node))
            if override is not None:
                pairs.append((node, override))
            elif isinstance(node, DeviceResidentScanExec):
                pairs.append((node, node.batches))
            else:
                if node._device_cache is None:
                    from ..runtime.retry import retry_io
                    node._device_cache = retry_io(
                        ctx.conf, "h2d", lambda: _shared_scan_upload(
                            node, ctx.conf, ctx.device))
                pairs.append((node, node._device_cache))
        return pairs

    @staticmethod
    def _flatten_inputs(pairs):
        flat, in_specs = [], []
        for node, dbs in pairs:
            specs = []
            for db in dbs:
                arrays, spec = _flatten_batch(db)
                flat += arrays
                specs.append(spec)
            in_specs.append((node, specs))
        return flat, in_specs

    def _lit_values(self) -> list:
        return [lit._physical_value() for lit in self._literals]

    def _build_cache_key(self, flat_in, in_specs) -> Optional[tuple]:
        """The process-wide key, or None outside the cacheable envelope
        (lifting off, an uncovered node class)."""
        if not self._lift:
            return None
        skey = plan_structure_key(self.root, self.conf)
        if skey is None:
            return None
        spec_sig = tuple((type(n).__name__, tuple(
            (tuple((nw, dt.simple_string, d is not None, rng, hi, enc, rg)
                   for nw, dt, d, rng, hi, enc, rg in cols), names, rows,
             sel)
            for cols, names, rows, sel in specs)) for n, specs in in_specs)
        input_sig = tuple((tuple(a.shape), str(a.dtype), str(a.device))
                          for a in flat_in)
        return (skey, spec_sig, input_sig)

    def _try_plan_cache(self, ctx, pairs, flat_in, in_specs) -> bool:
        """Adopt a graph captured from a canonically equal plan over the
        SAME host objects; the lifted values arrive through the slots."""
        self._cache_key = self._build_cache_key(flat_in, in_specs)
        if self._cache_key is None:
            return False
        prog = _plan_cache_get(self._cache_key, pairs)
        if prog is None or (prog.graph is None and prog.run is None):
            return False
        self._prog = prog
        ctx.bump("compile_cache_hits")
        ctx.bump("whole_plan_structure_hits")
        self._fresh = True
        return True

    # -- capture -------------------------------------------------------------
    def capture(self, ctx: ExecContext, flat_in=None, in_specs=None,
                pairs=None) -> None:
        """Capture the plan: fires the `compile` chaos site, then the
        warm-up and the graph (on the card) or the detector run (on the
        CPU).  Raises HostDecision for a plan that needs a host
        decision."""
        from ..runtime.faults import get_injector
        if flat_in is None:
            pairs = self._leaf_batches(ctx)
            flat_in, in_specs = self._flatten_inputs(pairs)
        # chaos site: an injected `oom` exercises the eager fallback,
        # `fatal` the crash capture (collect_with_fallback owns both);
        # background captures fire it on the service thread
        get_injector(ctx.conf).fire("compile")
        t0 = time.perf_counter()
        prog = _Program(ctx.device)
        prog.inputs = list(flat_in)
        prog.slots = [torch.empty((), dtype=_slot_dtype(lit),
                                  device=ctx.device)
                      for lit in self._literals]
        prog.bind(flat_in, self._lit_values())
        trace_ctx = _trace_context(ctx)
        specs_only = [(n, list(s)) for n, s in in_specs]
        lit_ids = [id(lit) for lit in self._literals]

        def run():
            return _run_captured(self.root, trace_ctx, prog, specs_only,
                                 lit_ids)

        if ctx.device.type == "cuda":
            _capture_graph(prog, run, ctx.device)
        else:
            with capture_scope(ctx.device):
                prog.outputs, prog.out_specs = run()
            prog.run = _pinned_tree(self.root, run)
        prog.host_metrics = {k: v for k, v in trace_ctx.metrics.items()
                             if isinstance(v, (int, float))}
        prog.capture_ms = (time.perf_counter() - t0) * 1e3
        ctx.metrics["compile_ms"] = ctx.metrics.get("compile_ms", 0.0) + \
            prog.capture_ms
        ctx.bump("compile_cache_misses")
        self._prog = prog
        self._fresh = True
        self._leaf_overrides = {}
        if self._cache_key is None:
            self._cache_key = self._build_cache_key(flat_in, in_specs)
        if self._cache_key is not None and pairs is not None:
            anchors = _plan_anchors(pairs)
            if anchors is not None:
                _plan_cache_put(self._cache_key, prog, anchors, self.conf)

    def ensure_compiled(self, ctx: ExecContext) -> None:
        """Capture (or adopt a cached graph) without running it."""
        if self._prog is not None:
            return
        pairs = self._leaf_batches(ctx)
        flat_in, in_specs = self._flatten_inputs(pairs)
        if not self._try_plan_cache(ctx, pairs, flat_in, in_specs):
            self.capture(ctx, flat_in, in_specs, pairs)

    @property
    def program(self) -> Optional[_Program]:
        return self._prog

    # -- replay ------------------------------------------------------------
    def execute(self, ctx: ExecContext) -> List[DeviceBatch]:
        """Replay the plan; its output batches.  The graph stays held
        (its static outputs are live) until `release`."""
        pairs = self._leaf_batches(ctx)
        flat_in, in_specs = self._flatten_inputs(pairs)
        if self._prog is None:
            if not self._try_plan_cache(ctx, pairs, flat_in, in_specs):
                self.capture(ctx, flat_in, in_specs, pairs)
        elif not self._fresh:
            ctx.bump("compile_cache_hits")
        self._fresh = False
        prog = self._prog
        if prog.graph is None and prog.run is None:
            # evicted from the cache since: capture again
            self._prog = None
            self.capture(ctx, flat_in, in_specs, pairs)
            prog = self._prog
        prog.lock.acquire()
        self._held = prog
        try:
            t0 = time.perf_counter()
            prog.bind(flat_in, self._lit_values())
            outs = prog.replay()
            m = ctx.metrics
            m.update(prog.host_metrics)
            for k, n in prog.launches.items():
                m[f"graph_launches.{k}"] = \
                    m.get(f"graph_launches.{k}", 0) + n
            m["exec_device_ms"] = m.get("exec_device_ms", 0.0) + \
                (time.perf_counter() - t0) * 1e3
            m["exec_dispatches"] = m.get("exec_dispatches", 0) + 1
        except BaseException:
            self.release()
            raise
        return outs

    def release(self) -> None:
        """Give the held graph back (its outputs may be overwritten)."""
        prog, self._held = self._held, None
        if prog is not None:
            prog.lock.release()

    def collect(self, ctx: ExecContext) -> HostBatch:
        from ..columnar.device import fetch_result_batch
        from ..runtime.retry import retry_io
        from .plan import empty_host_batch
        ctx.checkpoint("program")
        outs = self.execute(ctx)
        try:
            tick = getattr(self.root, "_fault_tick", None)
            hbs = []
            for db in outs:
                if tick is not None:
                    tick()
                ctx.checkpoint("fetch")
                hb = retry_io(ctx.conf, "d2h",
                              lambda: fetch_result_batch(db, conf=ctx.conf))
                if hb.num_rows:
                    hbs.append(hb)
        finally:
            self.release()
        if not hbs:
            return empty_host_batch(self.root.output_schema)
        from ..columnar.host import concat_host
        return concat_host(hbs) if len(hbs) > 1 else hbs[0]


def _pinned_tree(root: PlanNode, run):
    """`run` over the tree as it stood at capture: a split plan swaps its
    seam leaves in only while it collects, and the CPU's program re-runs
    the tree (a graph on the card has it baked in)."""
    shape, seen, stack = [], set(), [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        shape.append((n, list(n.children)))
        stack.extend(n.children)

    def pinned():
        now = [(n, n.children) for n, _ in shape]
        for n, kids in shape:
            n.children = list(kids)
        try:
            return run()
        finally:
            for n, kids in now:
                n.children = kids
    return pinned


def _slot_dtype(lit) -> torch.dtype:
    from ..ops.kernels import compute_dtype
    return compute_dtype(lit.dtype)


def _run_captured(root: PlanNode, trace_ctx: ExecContext, prog: _Program,
                  in_specs, lit_ids) -> Tuple[list, list]:
    """One run of the plan over the program's static inputs and slots:
    -> (flat output tensors, output specs).  Deferred columns materialize
    at the graph boundary, a pipeline sink."""
    from ..columnar.lanes import materialize_batch
    from ..plan.expressions import set_literal_bindings
    from ..runtime import faults
    leaves, i = {}, 0
    for node, specs in in_specs:
        dbs = []
        for spec in specs:
            db, i = _rebuild_batch(prog.inputs, spec, i)
            dbs.append(db)
        leaves[id(node)] = dbs
    prev_inj = faults.get_active_injector()
    set_trace_batches(leaves)
    set_literal_bindings({lid: s for lid, s in zip(lit_ids, prog.slots)})
    faults.set_active(_QUIET)
    try:
        with query_scope(trace_ctx):
            outs = list(_root_stream(root, trace_ctx))
        flat, specs = [], []
        for db in outs:
            if db.thin is not None:
                db = materialize_batch(db, trace_ctx.conf)
            arrays, spec = _flatten_batch(db)
            flat += arrays
            specs.append(spec)
    finally:
        faults.set_active(prev_inj)
        set_literal_bindings(None)
        set_trace_batches(None)
    return flat, specs


def _capture_graph(prog: _Program, run, device: torch.device) -> None:
    """Warm up on a side stream, then capture `run` into a CUDA graph
    there, one capture at a time.  Both run under the detector; the
    capture's errors are this thread's alone (`thread_local`), so a query
    on another thread keeps its syncs.  A stream-capture refusal or a
    detected host read maps to HostDecision, anything else propagates.
    The capture's own kernel launches are recorded, not run: LAUNCHES
    keeps the warm-up's, and each replay adds the recorded ones to its
    context's `graph_launches.<kernel>` metrics."""
    from ..ops.hopper import LAUNCHES, capture_scratch
    from ..runtime.capture import CAPTURE_LOCK
    side = torch.cuda.Stream(device)
    with CAPTURE_LOCK:
        t0 = time.perf_counter()
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side), graph_staging(prog.stage), \
                    capture_scope(device):
                run()
        except RuntimeError as e:
            decision = map_capture_error(e)
            if decision is None:
                raise
            raise decision from e
        torch.cuda.current_stream(device).wait_stream(side)
        t1 = time.perf_counter()
        before = dict(LAUNCHES)
        g = torch.cuda.CUDAGraph()
        try:
            with graph_staging(prog.stage), \
                    capture_scratch(device) as scratch, \
                    capture_scope(device), recording_scope():
                with torch.cuda.graph(g, stream=side,
                                      capture_error_mode="thread_local"):
                    prog.outputs, prog.out_specs = run()
        except Exception as e:        # noqa: BLE001 - mapped or re-raised
            g.reset()
            decision = map_capture_error(e)
            if decision is None:
                raise
            raise decision from e
        finally:
            prog.launches = {k: LAUNCHES[k] - before.get(k, 0)
                             for k in LAUNCHES
                             if LAUNCHES[k] != before.get(k, 0)}
            LAUNCHES.update(before)
    prog.stages = {"warmup_ms": (t1 - t0) * 1e3,
                   "record_ms": (time.perf_counter() - t1) * 1e3}
    prog.graph = g
    prog.scratch = scratch
    prog.pool_bytes = _pool_bytes(g)


def _pool_bytes(g) -> int:
    """Device bytes the segments of a graph's private pool hold."""
    pool = tuple(g.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id") or ()) == pool)


# ---------------------------------------------------------------------------
# Split plans
# ---------------------------------------------------------------------------

class DeviceResidentScanExec(PlanNode):
    """Leaf standing in for an already computed subplan's device output
    (a split seam).  Delegates plan statistics to the node it replaces,
    so downstream fast paths (unique-build joins, packed keys) survive
    the split."""

    def __init__(self, source: PlanNode):
        super().__init__()
        self._source = source
        self.batches: List[DeviceBatch] = []

    @property
    def output_schema(self):
        return self._source.output_schema

    def keys_unique(self, names):
        return self._source.keys_unique(names)

    def column_range(self, name):
        return self._source.column_range(name)

    def static_row_count(self):
        if len(self.batches) == 1 and \
                isinstance(self.batches[0].num_rows, int):
            return self.batches[0].num_rows
        return self._source.static_row_count()

    def execute(self, ctx: ExecContext):
        traced = trace_batches(self)
        yield from (traced if traced is not None else self.batches)

    def describe(self):
        return f"DeviceResidentScan[{self._source.describe()}]"


def _max_leaf_capacity(root: PlanNode, conf: TpuConf) -> int:
    """The largest leaf bucket under `root`."""
    best = 0
    for node in _find_scans(root):
        if isinstance(node, DeviceResidentScanExec):
            best = max([best] + [db.capacity for db in node.batches])
            continue
        for _off, rows, _hb in node.host_batches():
            best = max(best, bucket_capacity(max(rows, 1), conf))
    return best


def _find_split_seams(root: PlanNode, conf: TpuConf) -> List[PlanNode]:
    """Innermost-first seams where live rows collapse but static
    capacities do not: (1) the input of the topmost aggregate, after its
    fused filters, when it is real work (not a bare scan, and not a join
    whose output stays lazy), and (2) the aggregate itself.  Each costs
    one host count read, so a plan splits only where its leaves' buckets
    reach `sql.compile.seamSplitMinRows` (the reference's
    profile-segments override ports with item 10).  The port adds (3):
    down the probe sides of the joins under the aggregate, the largest
    build input that is itself real work (a hash join's right input; an
    adaptive join's side with unique keys, which it builds on): the
    eager engine concatenates a build side tightly by its host counts, a
    capture by whole capacities, and past `join.maxBuildRows` of
    capacity the hash table would give way to the sorted tier, another
    path than the eager engine's.  One such seam at most: the segments
    form a chain, and build inputs off one probe spine are not nested."""
    from ..config import SEAM_SPLIT_MIN_ROWS
    from .plan import FilterExec, HashAggregateExec

    def peel(n):
        while isinstance(n, FilterExec):
            n = n.child
        return n

    def leaf(n):
        return isinstance(n, (HostScanExec, DeviceResidentScanExec))

    def find_agg(n):
        for c in n.children:
            if isinstance(c, HashAggregateExec):
                return c
            found = find_agg(c)
            if found is not None:
                return found
        return None

    agg = None if isinstance(root, HashAggregateExec) else find_agg(root)
    min_rows = conf.get(SEAM_SPLIT_MIN_ROWS)
    if agg is None or _max_leaf_capacity(agg, conf) < min_rows:
        return []
    source = peel(agg.child)
    builds: List[PlanNode] = []
    node = source
    while True:
        build = _build_input(node)
        if build is None:
            break
        if not leaf(peel(build)) and \
                _max_leaf_capacity(build, conf) >= min_rows:
            builds.append(peel(build))
        node = peel(node.left if build is node.right else node.right)
    seams: List[PlanNode] = [max(
        builds, key=lambda n: _max_leaf_capacity(n, conf))] if builds else []
    # a join that emits a selection vector or thin batches (late
    # materialization) feeds its aggregate lazily: a seam there would
    # compact and gather what it keeps deferred, so it is no seam
    lazy = getattr(source, "lazy_sel", False) or \
        getattr(source, "thin_payload", None) is not None
    if not leaf(source) and not lazy:
        seams.append(source)
    seams.append(agg)
    return seams


def _build_input(node: PlanNode) -> Optional[PlanNode]:
    """The input a join builds its table from, where the plan says which:
    a hash join's right input; an adaptive join's only side whose keys
    are unique (it builds there unless that side is 8 x the other's
    bytes); else None."""
    from .adaptive import AdaptiveShuffledJoinExec
    from .join import HashJoinExec, side_unique
    if isinstance(node, HashJoinExec):
        return node.right
    if isinstance(node, AdaptiveShuffledJoinExec):
        lu = side_unique(node.left_keys, node.left)
        ru = side_unique(node.right_keys, node.right)
        if lu != ru:
            return node.left if lu else node.right
    return None


def _slice_batch(db: DeviceBatch, cap: int, n) -> DeviceBatch:
    """A live-prefix batch narrowed to a smaller bucket, copied: the seam
    releases the segment's graph, whose next replay overwrites it."""
    cols = [c.prefix(cap, copy=True) for c in db.columns]
    return DeviceBatch(cols, n, list(db.names))


def _parent_links(root: PlanNode, old: PlanNode):
    """EVERY (parent, index) link to `old` under `root`: a shared
    aggregate (plan/overrides dedupe_agg_twins) has several parents, and
    all of them must read the seam leaf."""
    links, seen, stack = [], set(), [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        for i, c in enumerate(n.children):
            if c is old:
                links.append((n, i))
            stack.append(c)
    if not links:
        raise ValueError("split node not found under root")
    return links


class _SplitUnsupported(Exception):
    """A seam output the split cannot re-bucket: the plan captures whole
    instead."""


class SplitCompiledPlan:
    """Segmented capture: the plan splits at seams where live rows
    collapse (`_find_split_seams`); each segment is one graph, and at
    every seam ONE host read of the row count re-buckets the seam output
    down before the next segment captures over the smaller shapes.
    Without it the input-scale padding of a graph carries through every
    operator above (a q3 tail sorting ~11k groups at lineitem's
    bucket)."""

    def __init__(self, root: PlanNode, seams: List[PlanNode],
                 conf: TpuConf):
        self.root = root
        self.conf = conf
        self.seams = list(seams)                 # innermost first
        self.leaves = [DeviceResidentScanExec(s) for s in self.seams]
        scope = list(self.seams[1:]) + [root]
        self._links = [_parent_links(up, s)
                       for s, up in zip(self.seams, scope)]
        # graphs per (segment, input bucket key)
        self._programs: List[Dict[tuple, CompiledPlan]] = \
            [{} for _ in range(len(self.seams) + 1)]
        #: this collect's background captures
        self._submitted: list = []

    @property
    def segments(self) -> int:
        return len(self.seams) + 1

    def _install_leaves(self) -> None:
        """Swap every seam for its leaf up front (restored in collect's
        finally): a background capture of a later segment must see the
        leaf before the main thread gets there."""
        for links, leaf in zip(self._links, self.leaves):
            for parent, ci in links:
                parent.children[ci] = leaf

    def _restore_leaves(self) -> None:
        for links, seam in zip(self._links, self.seams):
            for parent, ci in links:
                parent.children[ci] = seam

    def _segment(self, i: int, key: tuple, ctx) -> CompiledPlan:
        progs = self._programs[i]
        plan = progs.get(key)
        if plan is None and i > 0:
            # a background capture may have it ready (or in flight); its
            # exception, injected faults included, re-raises HERE
            from ..runtime.compile_service import (background_enabled,
                                                   get_service)
            if background_enabled(ctx.conf):
                task = get_service(ctx.conf).take((id(self), i, key))
                if task is not None:
                    try:
                        plan = task.wait()
                        ctx.bump("compile_background_used")
                    except TimeoutError:
                        plan = None              # capture it inline
                    if plan is not None:
                        progs[key] = plan
        if plan is None:
            seg_root = self.seams[i] if i < len(self.seams) else self.root
            plan = progs[key] = CompiledPlan(seg_root, ctx.conf)
        return plan

    def _candidate_caps(self, i: int, cap_in: int, conf) -> List[int]:
        """Predicted post-shrink buckets of seam i's output: exact where
        a plan statistic bounds it, else full collapse and none."""
        from ..config import COMPILE_BG_SPECULATE
        cands = []
        r = self.seams[i].static_row_count()
        if r is not None:
            cands.append(min(bucket_capacity(max(int(r), 1), conf), cap_in))
        cands.append(min(bucket_capacity(1, conf), cap_in))
        cands.append(cap_in)
        out: List[int] = []
        for c in cands:
            if c not in out:
                out.append(c)
        return out[:int(conf.get(COMPILE_BG_SPECULATE))]

    @staticmethod
    def _placeholder(spec, layout, cap: int, device) -> DeviceBatch:
        """A stand-in seam output at bucket `cap`: zero lanes of the
        output's dtypes and dictionaries, no live row."""
        cols_spec, names, _rows, _sel = spec
        cols = []
        for (narrow, dt, d, rng, has_hi, enc, _r), (lane_dt, valid_dt) \
                in zip(cols_spec, layout):
            stored = torch.zeros(cap, dtype=lane_dt, device=device)
            valid = torch.zeros(cap, dtype=torch.bool, device=device)
            hi = torch.zeros(cap, dtype=torch.int64, device=device) \
                if has_hi else None
            cols.append(NarrowColumn(stored, valid, dt, d, rng, enc)
                        if narrow else
                        DeviceColumn(stored, valid, dt, d, rng, hi))
        return DeviceBatch(cols, torch.zeros((), dtype=torch.int32,
                                             device=device), list(names))

    def _speculate(self, i: int, outs: List[DeviceBatch], ctx) -> None:
        """Capture candidate graphs of segment i+1 on the compile service
        while this thread reads the seam: the seam then finds the next
        graph ready instead of capturing it on the critical path."""
        from ..runtime.compile_service import background_enabled, get_service
        nxt = i + 1
        if nxt > len(self.seams) or not background_enabled(ctx.conf) or \
                len(outs) != 1:
            return                       # multi-batch seams: no prediction
        db = outs[0]
        if db.sel is not None or db.thin is not None or \
                any(c.offsets is not None for c in db.columns):
            return
        _t, spec = _flatten_batch(db)
        layout = [(c.stored.dtype, c.validity.dtype) for c in db.columns]
        service = get_service(ctx.conf)
        seg_root = self.seams[nxt] if nxt < len(self.seams) else self.root
        conf, device = ctx.conf, ctx.device
        for cap in self._candidate_caps(i, db.capacity, conf):
            key = (cap,)
            if key in self._programs[nxt]:
                continue
            placeholder = [self._placeholder(spec, layout, cap, device)]
            plan = CompiledPlan(seg_root, conf,
                                leaf_overrides={id(self.leaves[i]):
                                                placeholder})

            def thunk(plan=plan, conf=conf, device=device):
                plan.ensure_compiled(ExecContext(conf, device))
                return plan

            self._submitted.append(service.submit((id(self), nxt, key),
                                                  thunk))

    def _drop_speculation(self, ctx) -> None:
        """Take back the background captures this collect did not use
        and wait for those still running: the service would otherwise
        keep their programs (and a failed one's traceback, with the
        tensors of its frames) alive, and no capture may outlive its
        collect (CUDA refuses a device-wide synchronize while any stream
        captures).  A program that captured stays in the plan cache,
        which owns it; a failure of one nobody used is dropped."""
        if not self._submitted:
            return
        from ..runtime.compile_service import get_service
        service = get_service(ctx.conf)
        for task in self._submitted:
            service.take(task.key)
            task.done.wait()
        self._submitted = []

    @staticmethod
    def _shrink(outs: List[DeviceBatch], ctx) -> List[DeviceBatch]:
        from ..ops.batch_ops import ensure_prefix
        sliced = []
        for db in outs:
            if any(c.offsets is not None for c in db.columns):
                raise _SplitUnsupported()         # a ragged seam output
            db = ensure_prefix(db, ctx.conf)      # the seam re-buckets
            n = db.num_rows if isinstance(db.num_rows, int) \
                else int(db.num_rows)             # ONE host read a batch
            cap = min(bucket_capacity(max(n, 1), ctx.conf), db.capacity)
            # the count stays a device scalar: later segments key on the
            # bucket only, so a drifting count reuses their graphs
            sliced.append(_slice_batch(db, cap, torch.full(
                (), n, dtype=torch.int32, device=db.device)))
        return sliced

    def collect(self, ctx: ExecContext) -> HostBatch:
        self._install_leaves()
        try:
            key: tuple = ()
            for i, leaf in enumerate(self.leaves):
                ctx.checkpoint("seam")
                seg = self._segment(i, key, ctx)
                seg.ensure_compiled(ctx)
                outs = seg.execute(ctx)
                try:
                    self._speculate(i, outs, ctx)
                    t0 = time.perf_counter()
                    sliced = self._shrink(outs, ctx)
                finally:
                    seg.release()
                leaf.batches = sliced
                key = tuple(db.capacity for db in sliced)
                m = ctx.metrics
                m["overhead.seam_ms"] = m.get("overhead.seam_ms", 0.0) + \
                    (time.perf_counter() - t0) * 1e3
                m["overhead.seam_count"] = m.get("overhead.seam_count",
                                                 0) + 1
            out = self._segment(len(self.seams), key, ctx).collect(ctx)
        finally:
            # the running background captures read the installed leaves
            self._drop_speculation(ctx)
            self._restore_leaves()
        ctx.bump("whole_plan_split_queries")
        return out

    def programs(self) -> List[_Program]:
        """The programs of every captured segment and bucket."""
        return [p.program for progs in self._programs
                for p in progs.values() if p.program is not None]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _check_capturable(root: PlanNode) -> None:
    """A CPU operator inside a device plan is host work no graph replays:
    such a plan is a host decision from the start."""
    seen, stack = set(), [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if type(n).__module__.endswith("exec.host_exec"):
            raise HostDecision(f"{type(n).__name__} runs on the host")
        stack.extend(n.children)


def build_plan(root: PlanNode, ctx: ExecContext):
    """The whole-plan object for this root: a SplitCompiledPlan where
    row-collapse seams pay for themselves, else one CompiledPlan."""
    _check_capturable(root)
    seams = _find_split_seams(root, ctx.conf)
    return SplitCompiledPlan(root, seams, ctx.conf) if seams \
        else CompiledPlan(root, ctx.conf)


#: plans that needed a host decision: (structure key, source tables) ->
#: (weak references to the tables, the reason); a re-planned query skips
#: the capture attempt (its warm-up would run the plan to the host
#: decision first)
_NO_CAPTURE: Dict[tuple, tuple] = {}
_NO_CAPTURE_ENTRIES = 1024


def _decision_key(root: PlanNode, conf: TpuConf):
    """(key, anchors) of a plan's capture decision, or (None, None)."""
    skey = plan_structure_key(root, conf)
    if skey is None:
        return None, None
    tables = [n._source_table for n in _find_scans(root)
              if isinstance(n, HostScanExec)]
    return (skey, tuple(id(t) for t in tables)), \
        [weakref.ref(t) for t in tables]


def _fallback(holder, ctx: ExecContext, e: BaseException,
              root: Optional[PlanNode] = None) -> None:
    holder._compiled_plan = False
    holder._compiled_reason = f"{type(e).__name__}: {e}"
    ctx.bump("whole_plan_fallbacks")
    if root is not None:
        key, anchors = _decision_key(root, ctx.conf)
        if key is not None:
            with _PLAN_CACHE_LOCK:
                if len(_NO_CAPTURE) >= _NO_CAPTURE_ENTRIES:
                    _NO_CAPTURE.pop(next(iter(_NO_CAPTURE)))
                _NO_CAPTURE[key] = (anchors, holder._compiled_reason)


def _known_fallback(root: PlanNode, conf: TpuConf) -> Optional[str]:
    """The reason a structurally equal plan over the same tables needed a
    host decision, or None."""
    key, _ = _decision_key(root, conf)
    hit = None if key is None else _NO_CAPTURE.get(key)
    if hit is None or not all(a() is not None for a in hit[0]):
        return None
    return hit[1]


def _evict_graphs() -> int:
    """Release every graph of the plan cache, least recently used first,
    with its pool; -> how many.  The cache is bounded by entries, not by
    bytes: a capture or replay that runs out of device memory frees the
    pools this way and tries once more."""
    import gc
    with _PLAN_CACHE_LOCK:
        keys = [k for k, (p, _a) in _PLAN_CACHE.items()
                if p.graph is not None]
        victims = [_PLAN_CACHE.pop(k)[0] for k in keys]
    for p in victims:
        p.release()
    if victims:
        gc.collect()
        torch.cuda.empty_cache()
    return len(victims)


def collect_with_fallback(root: PlanNode, ctx: ExecContext,
                          cache_on: Optional[object] = None
                          ) -> Optional[HostBatch]:
    """Try the whole-plan path; None means "run the eager engine": a
    plan that needs a host decision (its holder is marked False and
    never tries again), or a device OOM during capture or replay that
    evicting the cached graphs (`_evict_graphs`, once) does not cure
    (the eager engine has the out-of-core machinery; the plan stays
    eligible).  Every other exception propagates."""
    from ..runtime.memory import is_oom_error
    holder = cache_on if cache_on is not None else root
    plan = getattr(holder, "_compiled_plan", None)
    if plan is False:
        return None
    if plan is None:
        known = _known_fallback(root, ctx.conf)
        if known is not None:
            holder._compiled_plan = False
            holder._compiled_reason = known
            ctx.bump("whole_plan_fallbacks")
            return None
    for attempt in range(2):
        oom = False
        try:
            if plan is None:
                plan = build_plan(root, ctx)
            try:
                out = plan.collect(ctx)
            except _SplitUnsupported:
                plan = CompiledPlan(root, ctx.conf)
                out = plan.collect(ctx)
        except HostDecision as e:
            _fallback(holder, ctx, e, root)
            return None
        except Exception as e:                    # noqa: BLE001
            if not is_oom_error(e):
                holder._compiled_plan = False
                raise
            oom = True          # retried outside: the traceback is gone
        if not oom:
            break
        if attempt == 0 and _evict_graphs():
            ctx.bump("whole_plan_oom_evictions")
            continue
        # transient memory pressure: eager this time, eligible next time
        ctx.bump("whole_plan_fallbacks")
        holder._compiled_reason = "device_oom"
        return None
    holder._compiled_plan = plan
    ctx.bump("whole_plan_compiled_queries")
    return out


def decision(holder) -> str:
    """What the last collect decided: "whole", "split:<segments>",
    "fallback: <error>" or "eager"."""
    plan = getattr(holder, "_compiled_plan", None)
    if plan is False:
        return f"fallback: {getattr(holder, '_compiled_reason', '?')}"
    if isinstance(plan, SplitCompiledPlan):
        return f"split:{plan.segments}"
    if isinstance(plan, CompiledPlan):
        return "whole"
    return "eager"


def plan_programs(holder) -> List[_Program]:
    """The captured programs behind a holder's plan."""
    plan = getattr(holder, "_compiled_plan", None)
    if isinstance(plan, SplitCompiledPlan):
        return plan.programs()
    if isinstance(plan, CompiledPlan) and plan.program is not None:
        return [plan.program]
    return []
