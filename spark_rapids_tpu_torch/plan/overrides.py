"""Logical plan -> physical device plan.

Counterpart of spark_rapids_tpu/plan/overrides.py.  The reference wraps,
tags and converts every operator, falling back to its pyarrow CPU engine
per operator.  A Limit directly above a Sort becomes TopNExec; inner,
outer and left semi joins become AdaptiveShuffledJoinExec, left anti
joins HashJoinExec (every equi-join HashJoinExec with
`sql.adaptive.enabled=false`) and cross joins CrossJoinExec, as in the
reference.  The reference sends
left semi joins through the adaptive join for its bloom-filter stage;
the port keeps that plan shape, but with `runtimeFilter` resolved off
(ops/bloom.py ports later) the route only materializes the probe side
before the same HashJoinExec, at a higher peak memory.  Column pruning
rewrites an inner join whose one side gives no output column and has
unique keys into a left semi join of the other side, as the reference
does.  The port has no CPU engine yet (exec/host_exec.py ports later), so
this module prunes columns, checks every node and expression the device
path would run, and converts — or raises NotImplementedError naming the
operator and the reason.  It never runs anything on another engine.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import types as t
from ..columnar.device import resolve_device
from ..columnar.host import HostBatch
from ..config import ADAPTIVE_ENABLED, DEFAULT_CONF, TpuConf
from ..exec.plan import (ExecContext, FilterExec, HashAggregateExec,
                         HostScanExec, LimitExec, PlanNode, ProjectExec,
                         SortExec, TopNExec, key_ref_names)
from . import expressions as E
from . import logical as L


def _expr_refs(e, out: set) -> None:
    if isinstance(e, E.ColumnRef):
        out.add(e.name)
    for c in getattr(e, "children", ()) or ():
        if isinstance(c, E.Expression):
            _expr_refs(c, out)


def prune_columns(plan: L.LogicalPlan, required=None) -> L.LogicalPlan:
    """Column-pruning pre-pass: narrow every scan to the columns the query
    reads (every surplus column would be a full padded device lane)."""
    if required is None:
        required = set(plan.schema.names)
    if type(plan) is L.LogicalScan:
        names = [n for n in plan.table.names if n in required]
        if len(names) == len(plan.table.names):
            return plan
        if not names:                 # keep row counts representable
            names = plan.table.names[:1]
        return L.LogicalScan(plan.table.select(names))
    if type(plan) is L.LogicalProject:
        keep = [i for i, n in enumerate(plan.names) if n in required] or [0]
        exprs = [plan.exprs[i] for i in keep]
        child_req: set = set()
        for e in exprs:
            _expr_refs(e, child_req)
        return L.LogicalProject(exprs, prune_columns(plan.child, child_req),
                                [plan.names[i] for i in keep])
    if type(plan) is L.LogicalFilter:
        req = set(required)
        _expr_refs(plan.condition, req)
        return L.LogicalFilter(plan.condition,
                               prune_columns(plan.child, req))
    if type(plan) is L.LogicalAggregate:
        req = set()
        for k in plan.keys:
            _expr_refs(k, req)
        for fn, _n in plan.aggs:
            if fn.child is not None:
                _expr_refs(fn.child, req)
        return L.LogicalAggregate(plan.keys, plan.aggs,
                                  prune_columns(plan.child, req),
                                  key_names=plan.key_names)
    if type(plan) is L.LogicalSort:
        req = set(required)
        for e, _asc, _nf in plan.orders:
            _expr_refs(e, req)
        return L.LogicalSort(plan.orders, prune_columns(plan.child, req))
    if type(plan) is L.LogicalLimit:
        return L.LogicalLimit(plan.limit, prune_columns(plan.child, required))
    if type(plan) is L.LogicalJoin:
        lreq = {n for n in required if n in plan.left.schema.names}
        rreq = {n for n in required if n in plan.right.schema.names}
        join_type = plan.join_type
        left, right = plan.left, plan.right
        lk, rk = plan.left_keys, plan.right_keys
        # an inner join whose one side gives no output column and has
        # unique keys IS a semi join of the other side: each row matches
        # at most once and only existence matters (q3's customer join)
        if join_type == "inner" and not rreq and \
                _logical_keys_unique(right, key_ref_names(rk)):
            join_type = "left_semi"
        elif join_type == "inner" and not lreq and \
                _logical_keys_unique(left, key_ref_names(lk)):
            join_type = "left_semi"
            left, right, lk, rk = right, left, rk, lk
            lreq, rreq = rreq, lreq
        for k in lk:
            _expr_refs(k, lreq)
        for k in rk:
            _expr_refs(k, rreq)
        return L.LogicalJoin(join_type, prune_columns(left, lreq),
                             prune_columns(right, rreq), lk, rk)
    raise NotImplementedError(
        f"{plan.name()} is not ported to the device yet")


def _logical_keys_unique(plan: L.LogicalPlan, names) -> bool:
    """Logical-level distinctness from exact scan statistics carried
    through the operators that keep it (False when unknown): the
    planner-side mirror of PlanNode.keys_unique."""
    if not names:
        return False
    if type(plan) is L.LogicalScan:
        return all(n in plan.table.names for n in names) and \
            plan.table.keys_unique(names)
    if type(plan) in (L.LogicalFilter, L.LogicalLimit, L.LogicalSort):
        return _logical_keys_unique(plan.child, names)
    if type(plan) is L.LogicalProject:
        mapped = []
        for n in names:
            if n not in plan.names:
                return False
            ref = key_ref_names([plan.exprs[plan.names.index(n)]])
            if ref is None:
                return False
            mapped.append(ref[0])
        return _logical_keys_unique(plan.child, mapped)
    if type(plan) is L.LogicalAggregate:
        return bool(plan.key_names) and set(plan.key_names) <= set(names)
    return False


def _refuse(op: str, reasons: List[str]) -> None:
    if reasons:
        raise NotImplementedError(
            f"{op} cannot run on the device: {'; '.join(reasons)}")


def _sort_keys(plan: "L.LogicalSort"):
    from ..ops.sort import SortKey
    schema_in = plan.child.schema
    keys = []
    for e, asc, nf in plan.orders:
        if not isinstance(e, E.ColumnRef):
            _refuse("Sort", [f"sort key {e!r} is not a column reference"])
        keys.append(SortKey(schema_in.field_index(e.name), asc, nf))
    return keys


def _convert(plan: L.LogicalPlan, conf: TpuConf) -> PlanNode:
    schema_in = plan.child.schema if plan.children else None
    if type(plan) is L.LogicalScan:
        return HostScanExec(plan.table, conf.batch_size_rows)
    if type(plan) is L.LogicalProject:
        reasons = []
        for e in plan.exprs:
            reasons += e.bind(schema_in).tree_unsupported(conf)
        _refuse("Project", reasons)
        return ProjectExec(plan.exprs, plan.names,
                           _convert(plan.child, conf))
    if type(plan) is L.LogicalFilter:
        # an aggregate or join right above peels it into a mask; anywhere
        # else it compacts
        _refuse("Filter",
                plan.condition.bind(schema_in).tree_unsupported(conf))
        return FilterExec(plan.condition, _convert(plan.child, conf))
    if type(plan) is L.LogicalAggregate:
        reasons = []
        for k, kn in zip(plan.keys, plan.key_names):
            bk = k.bind(schema_in)
            reasons += bk.tree_unsupported(conf)
            if isinstance(bk.dtype, (t.DecimalType,)) and bk.dtype.is_wide:
                reasons.append(f"group key {kn}: decimal({bk.dtype.precision})"
                               " keys are not supported")
        for fn, _n in plan.aggs:
            reasons += fn.bind(schema_in).unsupported_reasons(conf)
        _refuse("Aggregate", reasons)
        return HashAggregateExec(plan.keys, plan.key_names, plan.aggs,
                                 _convert(plan.child, conf))
    if type(plan) is L.LogicalSort:
        return SortExec(_sort_keys(plan), _convert(plan.child, conf))
    if type(plan) is L.LogicalLimit:
        # a limit right above a sort collapses into top-N (GpuTopN)
        if type(plan.child) is L.LogicalSort:
            return TopNExec(plan.limit, _sort_keys(plan.child),
                            _convert(plan.child.child, conf))
        return LimitExec(plan.limit, _convert(plan.child, conf))
    if type(plan) is L.LogicalJoin:
        return _convert_join(plan, conf)
    raise NotImplementedError(
        f"{plan.name()} is not ported to the device yet")


def _convert_join(plan: "L.LogicalJoin", conf: TpuConf) -> PlanNode:
    from ..exec.adaptive import _MIRROR, AdaptiveShuffledJoinExec
    from ..exec.join import (CrossJoinExec, HashJoinExec,
                             unported_join_reasons)
    left = _convert(plan.left, conf)
    right = _convert(plan.right, conf)
    if plan.join_type == "cross":
        return CrossJoinExec(left, right)
    lkeys = [k.bind(plan.left.schema) for k in plan.left_keys]
    rkeys = [k.bind(plan.right.schema) for k in plan.right_keys]
    reasons = unported_join_reasons(plan.join_type, lkeys, rkeys, left,
                                    right)
    for k in lkeys + rkeys:
        reasons += k.tree_unsupported(conf)
    _refuse("Join", reasons)
    if conf.get(ADAPTIVE_ENABLED) and (plan.join_type in _MIRROR or
                                       plan.join_type == "left_semi"):
        # AQE analogue: the build side is chosen from runtime sizes (a
        # left semi join never swaps; anti joins keep their sides)
        return AdaptiveShuffledJoinExec(plan.join_type, plan.left_keys,
                                        plan.right_keys, left, right)
    return HashJoinExec(plan.join_type, plan.left_keys, plan.right_keys,
                        left, right)


class PhysicalQuery:
    """A converted device plan plus the conf and device it runs with."""

    def __init__(self, root: PlanNode, conf: TpuConf, device: torch.device):
        self.root = root
        self.conf = conf
        self.device = device

    def collect(self, ctx: Optional[ExecContext] = None) -> HostBatch:
        ctx = ctx or ExecContext(self.conf, self.device)
        return self.root.collect(ctx)


def apply_overrides(plan: L.LogicalPlan, conf: TpuConf = DEFAULT_CONF,
                    device=None) -> PhysicalQuery:
    """Prune, check and convert a logical plan for the device (`device`
    None means "cuda" and raises without a card: `resolve_device`)."""
    device = resolve_device(device)
    if not conf.sql_enabled:
        raise NotImplementedError(
            "spark.rapids.tpu.sql.enabled=false runs the CPU engine, which "
            "is not ported yet")
    root = _convert(prune_columns(plan), conf)
    return PhysicalQuery(root, conf, device)
