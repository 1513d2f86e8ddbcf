"""Late-materialization lanes: thin device batches for join pipelines.

Counterpart of spark_rapids_tpu/columnar/lanes.py (the JoinGatherer
role: a join yields gather maps, and rows materialize where a consumer
needs the columns).  A join chain that gathers every payload column of
both sides at every join moves each column once a join; a thin batch
moves it once, at the pipeline's sink.

A join under `sql.join.lateMaterialization.enabled` emits a **thin
batch**: its key and condition columns materialized, and for each
deferred payload column a pointer into a lane source:

  * `LaneSource`: a fully materialized source batch (a join's build
    side, or an upstream source passed through) and an int32 row-id
    lane of the output's capacity, the gather indices the join
    computed anyway.  A lane value < 0 is a null-extended row (an outer
    join's unmatched row).
  * `ThinState.pending`: output column position -> (source ordinal,
    column index in the source).

A downstream join composes the lanes (one int32 take a source) instead
of gathering payloads; a filter composes its mask into the selection
vector (`DeviceBatch.sel`) instead of compacting; a sink (an
aggregation, a sort, a limit, a coalesce, the result fetch: whatever
calls `materialize_refs`, `ensure_prefix` or `compact_batch`) resolves
each column it still needs with one gather through the composed lane.
A column nobody references is never gathered.  A deferred string column
keeps its dictionary on the placeholder, so it crosses the chain as
codes.

Placeholders are zero-length columns.  The reference counts on a shape
error from a consumer that forgot to materialize; in PyTorch `x[:n]` of
an empty tensor is silently empty, so every prefix consumer asserts
`DeviceBatch.assert_prefix` after its `ensure_prefix` instead.

Each gather through a lane counts `late_gather_rows` and
`late_gather_bytes` in the running query's `ctx.metrics` (the
reference's registry families port with ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import DEFAULT_CONF, TpuConf
from .device import DeviceBatch, DeviceColumn


@dataclasses.dataclass
class LaneSource:
    """A materialized source batch and the row-id lane selecting from
    it."""
    batch: DeviceBatch
    lane: torch.Tensor        # (out_capacity,) int32; < 0 => null row

    def nbytes(self) -> int:
        return self.lane.numel() * 4


@dataclasses.dataclass
class ThinState:
    """Deferred-column bookkeeping attached to a DeviceBatch."""
    capacity: int
    sources: List[LaneSource]
    # output column position -> (source ordinal, source column index)
    pending: Dict[int, Tuple[int, int]]

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.sources)

    def select(self, indices: Sequence[int]) -> "Optional[ThinState]":
        """The thin state of DeviceBatch.select(indices): pending
        positions remap to the new column order; sources nobody
        references drop."""
        new_pending: Dict[int, Tuple[int, int]] = {}
        used: List[LaneSource] = []
        src_map: Dict[int, int] = {}
        for out_i, old_i in enumerate(indices):
            ref = self.pending.get(old_i)
            if ref is None:
                continue
            s, c = ref
            if s not in src_map:
                src_map[s] = len(used)
                used.append(self.sources[s])
            new_pending[out_i] = (src_map[s], c)
        if not new_pending:
            return None
        return ThinState(self.capacity, used, new_pending)


def deferred_column(src_col: DeviceColumn) -> DeviceColumn:
    """Zero-length placeholder of a deferred column: the logical type,
    the storage dtype and the source dictionary (a string stays code
    addressed through the chain), no rows."""
    dev = src_col.validity.device
    return DeviceColumn(
        torch.zeros(0, dtype=src_col.data_dtype, device=dev),
        torch.zeros(0, dtype=torch.bool, device=dev), src_col.dtype,
        src_col.dictionary, None,
        None if src_col.hi is None
        else torch.zeros(0, dtype=torch.int64, device=dev))


def _count_gather(rows: int, cols: List[DeviceColumn]) -> None:
    """One payload gather through a lane, into the running query's
    `ctx.metrics`."""
    from ..exec.plan import active_context
    ctx = active_context()
    if ctx is None:
        return
    width = sum(torch.empty((), dtype=c.data_dtype).element_size() + 1 +
                (8 if c.hi is not None else 0) for c in cols)
    nbytes = rows * width
    ctx.bump("late_gather_rows", rows * len(cols))
    ctx.bump("late_gather_bytes", nbytes)


def gather_deferred(src: LaneSource, col_indices: Sequence[int],
                    live: Optional[torch.Tensor],
                    lane: Optional[torch.Tensor] = None
                    ) -> List[DeviceColumn]:
    """Source columns through a row-id lane (`lane`, else the source's):
    rows whose index is < 0 or past the source's rows come back null,
    and `live` (the output's row mask) nulls dead output rows too."""
    from ..ops.filter import grouped_take
    idx = src.lane if lane is None else lane
    src_rows = src.batch.num_rows
    if isinstance(src_rows, torch.Tensor):
        src_rows = src_rows.to(idx.dtype)
    in_bounds = (idx >= 0) & (idx < src_rows)
    vmask = in_bounds if live is None else in_bounds & live
    safe = torch.clamp(idx, 0, max(src.batch.capacity - 1, 0))
    cols = [src.batch.columns[i] for i in col_indices]
    lanes = []
    for c in cols:
        lanes += [c.stored, c.validity] + ([] if c.hi is None else [c.hi])
    moved = iter(grouped_take(lanes, safe))
    out = []
    for c in cols:
        data, valid = next(moved), next(moved)
        out.append(c.rebuilt(data, valid & vmask,
                             None if c.hi is None else next(moved)))
    _count_gather(idx.shape[0], cols)
    return out


def materialize_batch(db: DeviceBatch, conf: TpuConf = DEFAULT_CONF,
                      positions: Optional[Sequence[int]] = None
                      ) -> DeviceBatch:
    """Resolve deferred columns, one gather a lane source.  `positions`
    None resolves every one (the thin state drops); a subset resolves
    only those (a mid-pipeline early materialization: a filter that
    reads a deferred column) and keeps the rest thin."""
    ts = db.thin
    if ts is None:
        return db
    want = set(ts.pending) if positions is None \
        else set(positions) & set(ts.pending)
    remaining = {p: r for p, r in ts.pending.items() if p not in want}
    if not want:
        return db
    live = db.row_mask()
    cols = list(db.columns)
    by_src: Dict[int, List[Tuple[int, int]]] = {}
    for pos in sorted(want):
        s, c = ts.pending[pos]
        by_src.setdefault(s, []).append((pos, c))
    for s, items in sorted(by_src.items()):
        gathered = gather_deferred(ts.sources[s], [c for _p, c in items],
                                   live)
        for (pos, _c), col in zip(items, gathered):
            cols[pos] = col
    new_ts = None
    if remaining:
        keep_src = sorted({s for s, _c in remaining.values()})
        src_map = {s: i for i, s in enumerate(keep_src)}
        new_ts = ThinState(ts.capacity, [ts.sources[s] for s in keep_src],
                           {p: (src_map[s], c)
                            for p, (s, c) in remaining.items()})
    return DeviceBatch(cols, db.num_rows, list(db.names), db.sel, new_ts)


def expr_column_refs(exprs) -> set:
    """Column names referenced anywhere in bound expressions (aggregate
    functions' inputs included)."""
    from ..plan import expressions as E
    out: set = set()

    def walk(e):
        if isinstance(e, E.ColumnRef):
            out.add(e.name)
        for c in getattr(e, "children", ()) or ():
            if isinstance(c, E.Expression):
                walk(c)
    for e in exprs:
        if isinstance(e, E.Expression):
            walk(e)
    return out


def passthrough_positions(db: DeviceBatch, exprs) -> Dict[int, int]:
    """Output position -> input position for projection expressions that
    are plain (possibly aliased) references to still-deferred columns: a
    projection passes those through as placeholders.  A name the batch
    holds twice is ambiguous and never passes through."""
    from ..plan import expressions as E
    ts = db.thin
    out: Dict[int, int] = {}
    if ts is None:
        return out
    counts: Dict[str, int] = {}
    for n in db.names:
        counts[n] = counts.get(n, 0) + 1
    pending_by_name = {db.names[p]: p for p in ts.pending
                       if counts[db.names[p]] == 1}
    for oi, e in enumerate(exprs):
        inner = e.children[0] if isinstance(e, E.Alias) else e
        if isinstance(inner, E.ColumnRef):
            p = pending_by_name.get(inner.name)
            if p is not None:
                out[oi] = p
    return out


def materialize_refs(db: DeviceBatch, exprs,
                     conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Materialize exactly the deferred columns the expressions
    reference; the others stay thin."""
    if db.thin is None:
        return db
    refs = expr_column_refs(exprs)
    positions = [p for p in db.thin.pending if db.names[p] in refs]
    if not positions:
        return db
    return materialize_batch(db, conf, positions)


def materialize_needed(db: DeviceBatch, exprs,
                       conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Sink-side materialization that drops dead columns: the deferred
    columns the expressions reference materialize through their lanes,
    the rest become all-null dense columns (never gathered), so the
    prefix and concat machinery downstream sees a plain batch."""
    if db.thin is None:
        return db
    db = materialize_refs(db, exprs, conf)
    ts = db.thin
    if ts is None:
        return db
    cols = list(db.columns)
    dev = db.device
    for pos, (s, c) in ts.pending.items():
        src_col = ts.sources[s].batch.columns[c]
        cap = ts.capacity
        cols[pos] = DeviceColumn(
            torch.zeros(cap, dtype=src_col.data_dtype, device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev), src_col.dtype,
            src_col.dictionary, None,
            None if src_col.hi is None
            else torch.zeros(cap, dtype=torch.int64, device=dev))
    return DeviceBatch(cols, db.num_rows, list(db.names), db.sel)


def compact_thin(db: DeviceBatch, keep: torch.Tensor,
                 conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Compact a thin batch: materialized columns move through the
    compaction order as `compact_batch` moves them; each deferred column
    is gathered once, straight from its source into its compacted
    position (the lane composes with the order: no materialize, then
    compact).  The order comes from the compaction kernel where
    ops/hopper elects it, as in `compact_batch`."""
    from ..ops.filter import grouped_take, keep_order
    from ..ops.kernels import live_mask
    ts = db.thin
    assert ts is not None
    order, count = keep_order(keep, conf)
    live_out = live_mask(db.capacity, count, keep.device)
    out_cols: List[Optional[DeviceColumn]] = [None] * len(db.columns)
    mat = [i for i in range(len(db.columns)) if i not in ts.pending]
    if mat:
        lanes = []
        for i in mat:
            c = db.columns[i]
            lanes += [c.stored, c.validity] + ([] if c.hi is None else [c.hi])
        moved = iter(grouped_take(lanes, order))
        for i in mat:
            c = db.columns[i]
            data, valid = next(moved), next(moved)
            out_cols[i] = c.rebuilt(data, valid & live_out,
                                    None if c.hi is None else next(moved))
    by_src: Dict[int, List[Tuple[int, int]]] = {}
    for pos, (s, c) in sorted(ts.pending.items()):
        by_src.setdefault(s, []).append((pos, c))
    minus_one = torch.full((), -1, dtype=torch.int32, device=keep.device)
    for s, items in sorted(by_src.items()):
        src = ts.sources[s]
        composed = torch.where(live_out, src.lane[order.long()], minus_one)
        gathered = gather_deferred(src, [c for _p, c in items], live_out,
                                   lane=composed)
        for (pos, _c), col in zip(items, gathered):
            out_cols[pos] = col
    return DeviceBatch(out_cols, count, list(db.names))
