"""Evaluating bound expression lists over one device batch.

Counterpart of spark_rapids_tpu/exec/evaluator.py.  The reference traces
an operator's expression list into one jit-compiled XLA program per row
bucket and caches it; PyTorch runs eagerly, so here the same two phases
(host `prepare`, device `eval_dev`) simply run per batch and there is no
program cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..columnar.device import DeviceBatch, DeviceColumn
from ..config import TpuConf
from ..ops.kernels import compute_view, live_mask, storage_view
from ..plan.expressions import (DevVal, EvalCtx, Expression, PrepCtx,
                                narrow_dev)


def _prepare(exprs: Sequence[Expression], db: DeviceBatch, conf: TpuConf):
    """Host phase: -> (PrepCtx, per-expression HostVal)."""
    dicts = {n: c.dictionary for n, c in zip(db.names, db.columns)}
    pctx = PrepCtx(conf, dicts, db.device)
    return pctx, [e.prepare(pctx) for e in exprs]


def _build_inputs(db: DeviceBatch) -> Dict[str, DevVal]:
    """name -> DevVal over the batch's compute views."""
    return {n: DevVal(compute_view(c.data, c.dtype), c.validity, c.dtype,
                      c.dictionary, c.value_range, c.hi)
            for n, c in zip(db.names, db.columns)}


def eval_ctx(db: DeviceBatch, pctx: PrepCtx, conf: TpuConf) -> EvalCtx:
    return EvalCtx(db.capacity, db.num_rows, _build_inputs(db), conf,
                   db.device)


def evaluate_projection(exprs: Sequence[Expression], names: Sequence[str],
                        db: DeviceBatch, conf: TpuConf,
                        narrow: Optional[str] = None) -> DeviceBatch:
    """Project `db` through bound expressions -> new DeviceBatch (also
    ProjectExec's entry point: the reference's `project_batch` differs
    only by its late-materialization pass-through, which ports later).
    `narrow` names a consumer that reads one int64 lane of a DECIMAL
    (a group-by, a window): each result goes through
    `expressions.narrow_dev` for it."""
    pctx, hostvals = _prepare(exprs, db, conf)
    ctx = eval_ctx(db, pctx, conf)
    live = live_mask(db.capacity, db.num_rows, db.device)
    cols = []
    for e, hv in zip(exprs, hostvals):
        dv = e.eval_dev(ctx)
        if narrow is not None:
            dv = narrow_dev(dv, narrow)
        valid = live if dv.validity is None else dv.validity & live
        cols.append(DeviceColumn(storage_view(dv.data, e.dtype), valid,
                                 e.dtype, hv.dictionary, dv.value_range,
                                 dv.hi))
    return DeviceBatch(cols, db.num_rows, list(names))


def compute_predicate(cond: Expression, db: DeviceBatch,
                      conf: TpuConf) -> torch.Tensor:
    """Evaluate a boolean expression -> keep-mask (False for null and
    padding rows)."""
    pctx, _ = _prepare([cond], db, conf)
    dv = cond.eval_dev(eval_ctx(db, pctx, conf))
    keep = dv.data if dv.validity is None else dv.data & dv.validity
    return keep & live_mask(db.capacity, db.num_rows, db.device)


def conds_mask(conds: Sequence[Expression], db: DeviceBatch,
               base: torch.Tensor, conf: TpuConf) -> torch.Tensor:
    """AND fused filter predicates into a row mask over `db` (the live
    mask of an aggregate, the key-valid mask of a join side)."""
    for c in conds:
        base = base & compute_predicate(c, db, conf)
    return base
