"""Evaluating bound expression lists over one device batch.

Counterpart of spark_rapids_tpu/exec/evaluator.py.  The reference traces
an operator's expression list into one jit-compiled XLA program per row
bucket and caches it; PyTorch runs eagerly, so here the same two phases
(host `prepare`, device `eval_dev`) simply run per batch and there is no
program cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, NarrowColumn
from ..config import TpuConf
from ..ops.kernels import compute_view, storage_view
from ..plan.expressions import (DevVal, EvalCtx, Expression, PrepCtx,
                                narrow_dev)


def _prepare(exprs: Sequence[Expression], db: DeviceBatch, conf: TpuConf):
    """Host phase: -> (PrepCtx, per-expression HostVal)."""
    dicts = {n: c.dictionary for n, c in zip(db.names, db.columns)}
    pctx = PrepCtx(conf, dicts, db.device)
    pctx.batch = db              # its provenance (plan/misc.InputFileName)
    return pctx, [e.prepare(pctx) for e in exprs]


def _input(c: DeviceColumn) -> DevVal:
    """One column as an expression input.  A FOR-narrowed column
    (columnar/device.NarrowColumn) gives its narrow lane as `narrow` and
    widens its data only where an expression reads it (the column keeps
    the widened lane, so the expressions of a batch widen it once)."""
    if isinstance(c, NarrowColumn):
        return DevVal(None, c.validity, c.dtype, c.dictionary, c.value_range,
                      narrow=c.lane,
                      widen=lambda: compute_view(c.data, c.dtype))
    if c.offsets is not None:
        return DevVal(c.data, c.validity, c.dtype, c.dictionary,
                      offsets=c.offsets, elem_valid=c.elem_valid)
    return DevVal(compute_view(c.data, c.dtype), c.validity, c.dtype,
                  c.dictionary, c.value_range, c.hi)


def _build_inputs(db: DeviceBatch) -> Dict[str, DevVal]:
    """name -> DevVal over the batch's compute views."""
    return {n: _input(c) for n, c in zip(db.names, db.columns)}


def eval_ctx(db: DeviceBatch, pctx: PrepCtx, conf: TpuConf) -> EvalCtx:
    return EvalCtx(db.capacity, db.num_rows, _build_inputs(db), conf,
                   db.device)


def evaluate_projection(exprs: Sequence[Expression], names: Sequence[str],
                        db: DeviceBatch, conf: TpuConf,
                        narrow: Optional[str] = None) -> DeviceBatch:
    """Project `db` through bound expressions -> new DeviceBatch.
    `narrow` names a consumer that reads one int64 lane of a DECIMAL
    (a group-by, a window): each result goes through
    `expressions.narrow_dev` for it.  A thin input materializes exactly
    the deferred columns the expressions read; a selection vector is the
    liveness and passes through."""
    if db.thin is not None:
        from ..columnar.lanes import materialize_refs
        db = materialize_refs(db, exprs, conf)
    if db.sel is not None and any(c.offsets is not None
                                  for c in db.columns):
        # the ragged kernels bound the live values by offsets[num_rows]:
        # a prefix batch first (the reference's)
        from ..ops.batch_ops import ensure_prefix
        db = ensure_prefix(db, conf)
    pctx, hostvals = _prepare(exprs, db, conf)
    ctx = eval_ctx(db, pctx, conf)
    live = db.row_mask()
    cols = []
    for e, hv in zip(exprs, hostvals):
        dv = e.eval_dev(ctx)
        if narrow is not None:
            dv = narrow_dev(dv, narrow)
        valid = live if dv.validity is None else dv.validity & live
        if dv.offsets is not None:
            # a ragged result keeps its offsets and element validity
            cols.append(DeviceColumn(dv.data, valid, e.dtype,
                                     hv.dictionary, None, None, dv.offsets,
                                     dv.elem_valid))
            continue
        if dv.narrow is not None and dv.hi is None:
            # a FOR-narrowed value rides through the projection narrow, as
            # the reference's does (its readers widen it when they read);
            # a lane the expressions widened already comes along
            col = NarrowColumn(dv.narrow, valid, e.dtype, hv.dictionary,
                               dv.value_range)
            col.data = dv._data
            cols.append(col)
            continue
        cols.append(DeviceColumn(storage_view(dv.data, e.dtype), valid,
                                 e.dtype, hv.dictionary, dv.value_range,
                                 dv.hi))
    return DeviceBatch(cols, db.num_rows, list(names), db.sel,
                       origin_file=db.origin_file)


def project_batch(exprs: Sequence[Expression], names: Sequence[str],
                  db: DeviceBatch, conf: TpuConf) -> DeviceBatch:
    """ProjectExec's entry point: `evaluate_projection`, except that a
    deferred column referenced only as a plain pass-through stays thin
    (its placeholder and lane move to the output position), so a
    projection between two joins does not force what the chain
    deferred.  Computed expressions materialize exactly their
    references."""
    if db.thin is None:
        return evaluate_projection(exprs, names, db, conf)
    from ..columnar.lanes import (ThinState, materialize_refs,
                                  passthrough_positions)
    pass_map = passthrough_positions(db, exprs)
    eval_idx = [i for i in range(len(exprs)) if i not in pass_map]
    db = materialize_refs(db, [exprs[i] for i in eval_idx], conf)
    ts = db.thin
    if ts is not None:
        # a computed expression may have materialized a pass-through too
        pass_map = {oi: p for oi, p in pass_map.items() if p in ts.pending}
    if ts is None or not pass_map:
        return evaluate_projection(exprs, names, db, conf)
    cols: List[Optional[DeviceColumn]] = [None] * len(exprs)
    if eval_idx:
        ev = evaluate_projection([exprs[i] for i in eval_idx],
                                 [names[i] for i in eval_idx], db, conf)
        for i, c in zip(eval_idx, ev.columns):
            cols[i] = c
    used: List = []
    src_map: Dict[int, int] = {}
    new_pending: Dict[int, Tuple[int, int]] = {}
    for oi, p in sorted(pass_map.items()):
        s, c = ts.pending[p]
        if s not in src_map:
            src_map[s] = len(used)
            used.append(ts.sources[s])
        cols[oi] = db.columns[p]          # the zero-length placeholder
        new_pending[oi] = (src_map[s], c)
    return DeviceBatch(cols, db.num_rows, list(names), db.sel,
                       ThinState(ts.capacity, used, new_pending),
                       db.origin_file)


def compute_predicate(cond: Expression, db: DeviceBatch,
                      conf: TpuConf) -> torch.Tensor:
    """Evaluate a boolean expression -> keep-mask (False for null and
    dead rows).  A thin input materializes the deferred columns the
    condition reads."""
    if db.thin is not None:
        from ..columnar.lanes import materialize_refs
        db = materialize_refs(db, [cond], conf)
    pctx, _ = _prepare([cond], db, conf)
    dv = cond.eval_dev(eval_ctx(db, pctx, conf))
    keep = dv.data if dv.validity is None else dv.data & dv.validity
    return keep & db.row_mask()


def conds_mask(conds: Sequence[Expression], db: DeviceBatch,
               base: torch.Tensor, conf: TpuConf) -> torch.Tensor:
    """AND fused filter predicates into a row mask over `db` (the live
    mask of an aggregate, the key-valid mask of a join side)."""
    for c in conds:
        base = base & compute_predicate(c, db, conf)
    return base
