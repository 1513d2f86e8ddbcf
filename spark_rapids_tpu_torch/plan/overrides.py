"""Logical plan -> physical plan: wrap, tag, convert.

Counterpart of spark_rapids_tpu/plan/overrides.py (the GpuOverrides
role).  `apply_overrides` prunes columns, wraps every logical node in a
`PlanMeta` (and every expression and aggregate in an `ExprMeta` /
`AggMeta`), tags each with the reasons it cannot run on the device, and
converts: a node without reasons becomes a device `PlanNode`, any other
a CPU operator of exec/host_exec.py, with `HostToDeviceExec` /
`DeviceToHostExec` inserted where the two meet.  The reasons are the
reference's: its rules (the expressions' and aggregates'
`unsupported_reasons`, a sort key that is not a column, COUNT(DISTINCT)
beside other aggregates, a join type outside the device's), the
`spark.rapids.tpu.sql.exec.<Name>Exec` and
`spark.rapids.tpu.sql.expression.<Name>` disables, `sql.enabled`, and
the cost-based optimizer (plan/cbo.py, `sql.optimizer.enabled`).
`sql.mode=explainOnly` tags for the device and runs on the CPU;
`sql.explain` (NONE, ALL, NOT_ON_TPU) logs the placement.  Explain lines
read as the reference's: `*Exec <Filter> will run on TPU` and `!Exec
<Project> cannot run on TPU because ...`.

Where the reference runs something on its device and the port has not
ported that device form (an `expressions.Unported` reason: a cast or
a wide decimal form of a later item, ...), the node
is not sent to the CPU engine: `apply_overrides` raises
NotImplementedError naming the slice, unless another reason already
puts the node on the CPU (or `sql.enabled` is false).  Nothing reroutes
an operator between the engines at run time.

The device conversion is unchanged: a Limit directly above a device
Sort becomes TopNExec; an aggregate whose functions are all
CountDistinct becomes DistinctAggregateExec; inner, outer and left semi
joins become AdaptiveShuffledJoinExec, left anti joins HashJoinExec
(every equi-join HashJoinExec with `sql.adaptive.enabled=false`), cross
joins CrossJoinExec, unions UnionExec, expands ExpandExec, windows
WindowExec, ranges RangeExec and samples SampleExec, as in the
reference.  A union's children keep their whole outputs (they align by
position); an expand keeps the output positions its parent reads, and a
window the columns its parent, its keys and its inputs read.  The
reference sends left semi joins through the adaptive join for its
bloom-filter stage, and so does the port (exec/adaptive.py).  Column
pruning rewrites an inner join whose one side gives no output column and
has unique keys into a left semi join of the other side, as the
reference does.

A device plan then takes the reference's post-passes: the aggregate-twin
CSE (`dedupe_agg_twins`), and under their keys `negotiate_lazy_sel`
(joins whose parent reads a selection vector), `negotiate_thin` (joins
whose consumers up to a sink take thin batches) and `negotiate_encoded`
(scans whose consumers take FOR-narrowed lanes).
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import logging
from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as t
from ..columnar.device import resolve_device
from ..columnar.host import HostBatch
from ..config import ADAPTIVE_ENABLED, CBO_ENABLED, DEFAULT_CONF, TpuConf
from ..exec import host_exec as H
# registers coredump.path and test.injectFatalError with the conf
from ..runtime.failure import crash_capture, install_fault_injection
from ..exec.plan import (ExecContext, ExpandExec, FilterExec,
                         HashAggregateExec, HostScanExec, LimitExec,
                         PlanNode, ProjectExec, RangeExec, SampleExec,
                         SortExec, TopNExec, UnionExec, key_ref_names)
from . import expressions as E
from . import logical as L
from .aggregates import (AggregateFunction, CollectList, CountDistinct,
                         Percentile)

log = logging.getLogger(__name__)


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
    if type(plan) is L.LogicalRange:
        return plan
    if type(plan) is L.LogicalSample:
        return L.LogicalSample(plan.fraction, plan.seed,
                               prune_columns(plan.child, required))
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
            for c in (fn.child, getattr(fn, "child2", None)):
                if c is not None:
                    _expr_refs(c, req)
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
    if type(plan) is L.LogicalUnion:
        # children align by position: each keeps its whole output, as in
        # the reference, and prunes below that
        return L.LogicalUnion(*[prune_columns(c, set(c.schema.names))
                                for c in plan.children])
    if type(plan) is L.LogicalExpand:
        # keep the output positions asked for; every projection keeps the
        # same positions, so the rows stay aligned
        keep = [i for i, n in enumerate(plan.names) if n in required] or [0]
        projections = [[p[i] for i in keep] for p in plan.projections]
        child_req: set = set()
        for p in projections:
            for e in p:
                _expr_refs(e, child_req)
        return L.LogicalExpand(projections, [plan.names[i] for i in keep],
                               prune_columns(plan.child, child_req))
    if type(plan) is L.LogicalWindow:
        outs = {name for _spec, name in plan.window_exprs}
        req = {n for n in required if n not in outs}
        for e in plan.partition_keys:
            _expr_refs(e, req)
        for e, _asc, _nf in plan.order_keys:
            _expr_refs(e, req)
        for spec, _name in plan.window_exprs:
            if spec.child is not None:
                _expr_refs(spec.child, req)
        return L.LogicalWindow(plan.window_exprs, plan.partition_keys,
                               plan.order_keys,
                               prune_columns(plan.child, req))
    if type(plan) is L.LogicalGenerate:
        # a generator keeps its whole input (the reference's); pruning
        # goes on below it
        return L.LogicalGenerate(
            plan.generator,
            prune_columns(plan.child, set(plan.child.schema.names)),
            plan.output_names)
    if type(plan) in _PANDAS_NODES:
        # a pandas exec's function may read any column of its input (the
        # reference's): each child keeps its whole output, pruning goes
        # on below it
        out = copy.copy(plan)
        out.children = [prune_columns(c, set(c.schema.names))
                        for c in plan.children]
        return out
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
    if type(plan) in (L.LogicalFilter, L.LogicalLimit, L.LogicalSort,
                      L.LogicalSample):
        return _logical_keys_unique(plan.child, names)
    if type(plan) is L.LogicalRange:
        return list(names) == [plan.col_name]
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


def _sort_keys(node: "L.LogicalSort"):
    from ..ops.sort import SortKey
    schema_in = node.child.schema
    return [SortKey(schema_in.field_index(e.name), asc, nf)
            for e, asc, nf in node.orders]


def _host_to_device(node: "H.HostNode") -> PlanNode:
    """A CPU node under a device parent: the upload takes the whole
    output.  Every type but STRUCT and MAP has a device lane, and no
    STRUCT or MAP column reaches a device parent: no device operator
    outputs one, and column pruning drops what its expressions do not
    read."""
    return H.HostToDeviceExec(node)


def _prefixed(prefix: str, r: str) -> str:
    """`r` under a prefix, still an `Unported` if it was one."""
    return type(r)(f"{prefix}{r}")


# ---------------------------------------------------------------------------
# Meta hierarchy
# ---------------------------------------------------------------------------

class BaseMeta:
    def __init__(self, conf: TpuConf):
        self.conf = conf
        self.reasons: List[str] = []
        #: reasons the port refuses instead of falling back (Unported)
        self.unported: List[str] = []

    def will_not_work(self, reason: str):
        into = self.unported if isinstance(reason, E.Unported) \
            else self.reasons
        if reason not in into:
            into.append(reason)

    @property
    def can_replace(self) -> bool:
        return not self.reasons

    def _roll_up(self, other: "BaseMeta"):
        for r in other.reasons + other.unported:
            self.will_not_work(r)


class ExprMeta(BaseMeta):
    """Wraps one bound expression.  Child reasons roll up: expressions
    are replaced only as whole trees inside an operator."""

    def __init__(self, expr: E.Expression, conf: TpuConf):
        super().__init__(conf)
        self.expr = expr
        self.children = [ExprMeta(c, conf) for c in expr.children]

    def tag(self):
        for c in self.children:
            c.tag()
            self._roll_up(c)
        from .misc import InputFileName
        if any(isinstance(c, InputFileName) for c in self.expr.children):
            # as the reference: the device form is a top-level output only
            self.will_not_work(
                "input_file_name nested inside another expression "
                "(device path supports it as a top-level output only)")
        name = type(self.expr).__name__
        if name in self.conf.shims.unavailable_expressions:
            self.will_not_work(
                f"expression {name} does not exist in Spark "
                f"{self.conf.shims.version_prefix} (shim gate)")
            return
        if not self.conf.is_op_enabled("expression", name):
            self.will_not_work(
                f"expression {name} disabled by "
                f"spark.rapids.tpu.sql.expression.{name}")
            return
        if not E.has_device_rule(self.expr):
            self.will_not_work(f"expression {name} has no TPU rule")
            return
        rule = EXPR_RULES.get(type(self.expr))
        if rule is not None:
            # the reference's signature checks, for the nested types
            # (the flat ones each class's own checks cover)
            for c in self.expr.children:
                if _nested(c.dtype) and not rule.input_sig.supports(c.dtype):
                    self.will_not_work(
                        f"expression {name}: input type "
                        f"{c.dtype.simple_string} not supported")
            if _nested(self.expr.dtype) and \
                    not rule.output_sig.supports(self.expr.dtype):
                self.will_not_work(
                    f"expression {name}: output type "
                    f"{self.expr.dtype.simple_string} not supported")
        for r in self.expr.unsupported_reasons(self.conf):
            self.will_not_work(_prefixed(f"expression {name}: ", r))


def _nested(dt) -> bool:
    return isinstance(dt, (t.ArrayType, t.MapType, t.StructType))


class AggMeta(BaseMeta):
    def __init__(self, fn: AggregateFunction, conf: TpuConf):
        super().__init__(conf)
        self.fn = fn

    def tag(self):
        name = type(self.fn).__name__
        if name in self.conf.shims.unavailable_expressions:
            self.will_not_work(
                f"aggregate {name} does not exist in Spark "
                f"{self.conf.shims.version_prefix} (shim gate)")
            return
        for r in self.fn.unsupported_reasons(self.conf):
            self.will_not_work(_prefixed(f"aggregate {name}: ", r))


class PlanMeta(BaseMeta):
    """Wraps one logical node; subclasses add expression metas, their own
    checks (`tag_self`) and the two conversions."""

    def __init__(self, node: L.LogicalPlan, conf: TpuConf,
                 parent: Optional["PlanMeta"]):
        super().__init__(conf)
        self.node = node
        self.parent = parent
        self.children = [wrap_plan(c, conf, self) for c in node.children]
        self.expr_metas: List[ExprMeta] = []
        self.agg_metas: List[AggMeta] = []

    def _wrap_exprs(self, exprs: Sequence[E.Expression],
                    schema: t.StructType) -> List[E.Expression]:
        bound = []
        for e in exprs:
            b = e.bind(schema)
            self.expr_metas.append(ExprMeta(b, self.conf))
            bound.append(b)
        return bound

    # -- tagging -----------------------------------------------------------
    def tag(self):
        for c in self.children:
            c.tag()
        if not self.conf.sql_enabled:
            self.will_not_work("spark.rapids.tpu.sql.enabled is false")
            return
        key_name = type(self.node).__name__.removeprefix("Logical") + "Exec"
        if not self.conf.is_op_enabled("exec", key_name):
            self.will_not_work(
                f"exec {key_name} disabled by "
                f"spark.rapids.tpu.sql.exec.{key_name}")
        rule = EXEC_RULES.get(type(self.node))
        for f in self.node.schema.fields:
            # a STRUCT or MAP output no exec rule takes: what the shatter
            # (plan/structs.py) left nested runs on the CPU engine
            if _nested(f.data_type) and rule is not None and \
                    not rule.output_sig.supports(f.data_type):
                self.will_not_work(
                    f"output column {f.name}: type "
                    f"{f.data_type.simple_string} not supported")
        for m in self.expr_metas + self.agg_metas:
            m.tag()
            self._roll_up(m)
        self.tag_self()

    def tag_self(self):
        pass

    def check_unported(self):
        """Raise NotImplementedError where this tree would put on the
        device a node whose device form the port lacks."""
        for c in self.children:
            c.check_unported()
        if self.unported and self.can_replace:
            raise NotImplementedError(
                f"{self.node.name()} cannot run on the device: "
                + "; ".join(self.unported))

    # -- conversion --------------------------------------------------------
    def convert(self) -> Tuple[str, object]:
        """("device", PlanNode) or ("host", HostNode)."""
        if self.can_replace and not self.conf.explain_only:
            return "device", self.to_device()
        return "host", self.to_host()

    def to_device(self) -> PlanNode:
        raise NotImplementedError

    def to_host(self) -> "H.HostNode":
        raise NotImplementedError

    def _device_child(self, i: int = 0) -> PlanNode:
        kind, node = self.children[i].convert()
        return node if kind == "device" else _host_to_device(node)

    def _host_child(self, i: int = 0) -> "H.HostNode":
        kind, node = self.children[i].convert()
        return node if kind == "host" else H.DeviceToHostExec(node)

    # -- explain -----------------------------------------------------------
    def explain_lines(self, depth: int = 0) -> List[str]:
        mark = "*" if self.can_replace else "!"
        line = f"{'  ' * depth}{mark}Exec <{self.node.name()}>"
        if self.can_replace:
            line += " will run on TPU"
        else:
            line += (" cannot run on TPU because "
                     + "; ".join(self.reasons[:4]))
            if len(self.reasons) > 4:
                line += f" (+{len(self.reasons) - 4} more)"
        out = [line]
        for c in self.children:
            out += c.explain_lines(depth + 1)
        return out


# ---------------------------------------------------------------------------
# Per-node metas
# ---------------------------------------------------------------------------

class ScanMeta(PlanMeta):
    def to_device(self):
        return HostScanExec(self.node.table, self.conf.batch_size_rows)

    def to_host(self):
        return H.HostSourceExec(self.node.table, self.conf.batch_size_rows)


class ProjectMeta(PlanMeta):
    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        self._wrap_exprs(node.exprs, node.child.schema)

    def to_device(self):
        return ProjectExec(self.node.exprs, self.node.names,
                           self._device_child())

    def to_host(self):
        return H.CpuProjectExec(self.node.exprs, self.node.names,
                                self._host_child())


class FilterMeta(PlanMeta):
    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        self._wrap_exprs([node.condition], node.child.schema)

    def to_device(self):
        # an aggregate or join right above peels it into a mask; anywhere
        # else it compacts
        return FilterExec(self.node.condition, self._device_child())

    def to_host(self):
        return H.CpuFilterExec(self.node.condition, self._host_child())


class AggregateMeta(PlanMeta):
    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        schema = node.child.schema
        self._wrap_exprs(node.keys, schema)
        for fn, _name in node.aggs:
            # version-dependent semantics (shims.py) reach the device
            # evaluate() and the CPU cpu_agg() alike
            fn._shims = conf.shims
            b = fn.bind(schema)
            self.agg_metas.append(AggMeta(b, conf))
            for c in (b.child, getattr(b, "child2", None)):
                if c is not None:
                    self.expr_metas.append(ExprMeta(c, conf))

    def tag_self(self):
        for k, kn in zip(self.node.keys, self.node.key_names):
            kdt = k.bind(self.node.child.schema).dtype
            if isinstance(kdt, (t.ArrayType, t.MapType, t.StructType,
                                t.BinaryType)):
                self.will_not_work(
                    f"group key {kn}: {kdt.simple_string} keys have "
                    "no flat device lane")
            if isinstance(kdt, t.DecimalType) and kdt.is_wide:
                self.will_not_work(
                    f"group key {kn}: decimal({kdt.precision}) keys "
                    "carry a second lane the group-by cannot compare")
        # holistic aggregates (sort-based device execs) cannot mix with
        # streaming ones in one device aggregation
        for family, label in self._holistic_split():
            if any(family) and not all(family):
                self.will_not_work(
                    f"{label} mixed with other aggregates (device path "
                    f"requires a uniform aggregation)")
        from ..config import COLLECT_DEVICE_ENABLED
        if any(isinstance(fn, CollectList) for fn, _n in self.node.aggs) \
                and not self.conf.get(COLLECT_DEVICE_ENABLED):
            # the reference hands such an aggregation to its hash
            # aggregate, which has no collect buffers and raises; the
            # port runs it on the CPU engine (README)
            self.will_not_work(
                "collect_list/collect_set with the device collect "
                f"disabled by {COLLECT_DEVICE_ENABLED.key}")

    def _holistic_split(self):
        aggs = self.node.aggs
        return (([isinstance(fn, Percentile) for fn, _n in aggs],
                 "percentile"),
                ([isinstance(fn, CountDistinct) for fn, _n in aggs],
                 "count(DISTINCT)"),
                ([isinstance(fn, CollectList) for fn, _n in aggs],
                 "collect_list/collect_set"))

    def to_device(self):
        from ..config import COLLECT_DEVICE_ENABLED
        if self.node.aggs and all(isinstance(fn, CollectList)
                                  for fn, _n in self.node.aggs) and \
                self.conf.get(COLLECT_DEVICE_ENABLED):
            from ..exec.collect import CollectAggregateExec
            return CollectAggregateExec(self.node.keys, self.node.key_names,
                                        self.node.aggs, self._device_child())
        if self.node.aggs and all(isinstance(fn, Percentile)
                                  for fn, _n in self.node.aggs):
            from ..exec.percentile import PercentileAggregateExec
            return PercentileAggregateExec(
                self.node.keys, self.node.key_names, self.node.aggs,
                self._device_child())
        if self.node.aggs and all(isinstance(fn, CountDistinct)
                                  for fn, _n in self.node.aggs):
            from ..exec.distinct import DistinctAggregateExec
            return DistinctAggregateExec(self.node.keys, self.node.key_names,
                                         self.node.aggs, self._device_child())
        return HashAggregateExec(self.node.keys, self.node.key_names,
                                 self.node.aggs, self._device_child())

    def to_host(self):
        return H.CpuAggregateExec(self.node.keys, self.node.key_names,
                                  self.node.aggs, self._host_child())


class SortMeta(PlanMeta):
    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        self._wrap_exprs([e for e, _, _ in node.orders], node.child.schema)

    def tag_self(self):
        for e, _asc, _nf in self.node.orders:
            if not isinstance(e, E.ColumnRef):
                self.will_not_work(
                    f"sort key {e!r} is not a column reference "
                    "(planner pre-projection not yet implemented)")

    def to_device(self):
        return SortExec(_sort_keys(self.node), self._device_child())

    def to_host(self):
        return H.CpuSortExec(self.node.orders, self._host_child())


class LimitMeta(PlanMeta):
    def to_device(self):
        # a limit right above a device sort collapses into top-N
        # (GpuTopN)
        child_meta = self.children[0]
        if isinstance(child_meta, SortMeta) and child_meta.can_replace:
            return TopNExec(self.node.limit, _sort_keys(child_meta.node),
                            child_meta._device_child())
        return LimitExec(self.node.limit, self._device_child())

    def to_host(self):
        return H.CpuLimitExec(self.node.limit, self._host_child())


class JoinMeta(PlanMeta):
    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        self.lkeys = self._wrap_exprs(node.left_keys, node.left.schema)
        self.rkeys = self._wrap_exprs(node.right_keys, node.right.schema)

    def tag_self(self):
        from ..exec.join import JOIN_TYPES
        if self.node.join_type not in JOIN_TYPES + ("cross",):
            self.will_not_work(
                f"join type {self.node.join_type} not supported on TPU")

    def to_device(self):
        from ..exec.adaptive import _MIRROR, AdaptiveShuffledJoinExec
        from ..exec.join import (CrossJoinExec, HashJoinExec,
                                 unported_join_reasons)
        left = self._device_child(0)
        right = self._device_child(1)
        n = self.node
        if n.join_type == "cross":
            return CrossJoinExec(left, right)
        reasons = unported_join_reasons(n.join_type)
        if reasons:
            raise NotImplementedError(
                f"Join cannot run on the device: {'; '.join(reasons)}")
        if self.conf.get(ADAPTIVE_ENABLED) and (
                n.join_type in _MIRROR or n.join_type == "left_semi"):
            # AQE analogue: the build side is chosen from runtime sizes (a
            # left semi join never swaps; anti joins keep their sides)
            return AdaptiveShuffledJoinExec(n.join_type, n.left_keys,
                                            n.right_keys, left, right)
        return HashJoinExec(n.join_type, n.left_keys, n.right_keys, left,
                            right)

    def to_host(self):
        n = self.node
        return H.CpuJoinExec(n.join_type, n.left_keys, n.right_keys,
                             self._host_child(0), self._host_child(1))


class UnionMeta(PlanMeta):
    def convert(self):
        kids = [c.convert() for c in self.children]
        if self.can_replace and not self.conf.explain_only:
            return "device", UnionExec(*[
                k if kind == "device" else _host_to_device(k)
                for kind, k in kids])
        return "host", H.CpuUnionExec(*[
            k if kind == "host" else H.DeviceToHostExec(k)
            for kind, k in kids])


class RangeMeta(PlanMeta):
    def to_device(self):
        n = self.node
        return RangeExec(n.start, n.end, n.step, n.col_name)

    def to_host(self):
        n = self.node
        return H.CpuRangeExec(n.start, n.end, n.step, n.col_name)


class ExpandMeta(PlanMeta):
    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        for p in node.projections:
            self._wrap_exprs(p, node.child.schema)

    def to_device(self):
        return ExpandExec(self.node.projections, self.node.names,
                          self._device_child())

    def to_host(self):
        return H.CpuExpandExec(self.node.projections, self.node.names,
                               self._host_child())


class SampleMeta(PlanMeta):
    def to_device(self):
        return SampleExec(self.node.fraction, self.node.seed,
                          self._device_child())

    def to_host(self):
        return H.CpuSampleExec(self.node.fraction, self.node.seed,
                               self._host_child())


class WindowMeta(PlanMeta):
    """LogicalWindow -> WindowExec.  The reference's WindowMeta checks:
    each spec's own, the keys', and one integer/date/timestamp order key
    under a value-offset RANGE frame.  A window that fails them runs on
    the CPU engine (exec/host_exec.CpuWindowExec), as in the reference."""

    def __init__(self, node, conf, parent):
        super().__init__(node, conf, parent)
        schema = node.child.schema
        self._wrap_exprs(node.partition_keys, schema)
        self._wrap_exprs([e for e, _, _ in node.order_keys], schema)
        self.specs = []
        for spec, _name in node.window_exprs:
            b = spec.bind(schema)
            self.specs.append(b)
            if b.child is not None:
                self.expr_metas.append(ExprMeta(b.child, conf))

    def tag_self(self):
        schema = self.node.child.schema
        for b in self.specs:
            name = type(b).__name__
            if not self.conf.is_op_enabled("expression", name):
                self.will_not_work(
                    f"window function {name} disabled by "
                    f"spark.rapids.tpu.sql.expression.{name}")
            for r in b.unsupported_reasons(self.conf):
                self.will_not_work(_prefixed(f"window function {b.name}: ",
                                             r))
        for e, _a, _nf in self.node.order_keys:
            dt = e.bind(schema).dtype
            if isinstance(dt, t.DecimalType) and dt.is_wide:
                self.will_not_work("decimal128 window order key "
                                   "not yet on device")
        if any(b.frame is not None and b.frame.is_value_offset
               for b in self.specs):
            ok = len(self.node.order_keys) == 1 and isinstance(
                self.node.order_keys[0][0].bind(schema).dtype,
                (t.ByteType, t.ShortType, t.IntegerType, t.LongType,
                 t.DateType, t.TimestampType))
            if not ok:
                self.will_not_work(
                    "value-offset RANGE frame needs a single "
                    "integer/date/timestamp order key on device")

    def to_device(self):
        from ..exec.window import WindowExec
        n = self.node
        return WindowExec(n.window_exprs, n.partition_keys, n.order_keys,
                          self._device_child())

    def to_host(self):
        n = self.node
        return H.CpuWindowExec(n.window_exprs, n.partition_keys,
                               n.order_keys, self._host_child())


class GenerateMeta(PlanMeta):
    """LogicalGenerate: explode / posexplode runs on the device over the
    ragged lanes (exec/generate.py) when

      * the generator's input is a plain column reference whose element
        type has a ragged device lane,
      * no OTHER nested column rides along, and
      * the parent provably never reads the exploded column (Spark's
        GenerateExec.requiredChildOutput pruning);

    anything else runs CpuGenerateExec (the reference's GenerateMeta)."""

    def tag_self(self):
        from .collections import _device_elem_ok
        gen = self.node.generator
        child_schema = self.node.child.schema
        arr = getattr(gen, "child", None)
        if not isinstance(arr, E.ColumnRef):
            self.will_not_work("generator input is not a column reference")
            return
        adt = child_schema[arr.name].data_type
        if not isinstance(adt, t.ArrayType) or not (
                _device_elem_ok(adt.element_type)
                or isinstance(adt.element_type, t.StringType)):
            shown = adt.element_type.simple_string \
                if isinstance(adt, t.ArrayType) else adt.simple_string
            self.will_not_work(f"array element type {shown} has no ragged "
                               "device lane")
            return
        for f in child_schema.fields:
            if f.name != arr.name and _nested(f.data_type):
                self.will_not_work(
                    f"second nested column {f.name} alongside the "
                    "exploded input (row gathers are flat)")
                return
        if not self._parent_prunes_input(arr.name):
            self.will_not_work(
                f"parent operator may read the exploded array column "
                f"{arr.name} (requiredChildOutput pruning not provable)")

    def _parent_prunes_input(self, arr_name: str) -> bool:
        p = self.parent
        if not isinstance(p, ProjectMeta):
            return False
        refs: set = set()

        def walk(e):
            if isinstance(e, E.ColumnRef):
                refs.add(e.name)
            for c in e.children:
                walk(c)
            body = getattr(e, "body", None)
            if body is not None:
                walk(body)
        for e in p.node.exprs:
            walk(e)
        return arr_name not in refs

    def to_device(self):
        from ..exec.generate import GenerateExec
        return GenerateExec(self.node.generator, self.node.output_names,
                            self._device_child())

    def to_host(self):
        return H.CpuGenerateExec(self.node.generator, self.node.output_names,
                                 self._host_child())


class _PandasMeta(PlanMeta):
    """Pandas execs run on the host side of the plan by placement (the
    worker boundary is the host, as in the reference's GPU->JVM->python
    hops); transitions bridge device children and parents
    (exec/python_exec.py)."""
    exec_name = ""

    def tag_self(self):
        self.will_not_work(
            "pandas UDFs execute in a python worker process "
            f"(host Arrow boundary; Gpu{self.exec_name} role)")


class MapInPandasMeta(_PandasMeta):
    exec_name = "MapInPandasExec"

    def to_host(self):
        from ..exec.python_exec import MapInPandasExec
        return MapInPandasExec(self.node.fn, self.node.result_schema,
                               self._host_child())


class ArrowEvalPythonMeta(_PandasMeta):
    exec_name = "ArrowEvalPythonExec"

    def to_host(self):
        from ..exec.python_exec import ArrowEvalPythonExec
        return ArrowEvalPythonExec(self.node.udfs, self._host_child())


class FlatMapGroupsInPandasMeta(_PandasMeta):
    exec_name = "FlatMapGroupsInPandasExec"

    def to_host(self):
        from ..exec.python_exec import FlatMapGroupsInPandasExec
        return FlatMapGroupsInPandasExec(
            self.node.key_names, self.node.fn, self.node.result_schema,
            self._host_child())


class FlatMapCoGroupsInPandasMeta(_PandasMeta):
    exec_name = "FlatMapCoGroupsInPandasExec"

    def to_host(self):
        from ..exec.python_exec import FlatMapCoGroupsInPandasExec
        return FlatMapCoGroupsInPandasExec(
            self.node.left_keys, self.node.right_keys, self.node.fn,
            self.node.result_schema, self._host_child(0),
            self._host_child(1))


class AggregateInPandasMeta(_PandasMeta):
    exec_name = "AggregateInPandasExec"

    def to_host(self):
        from ..exec.python_exec import AggregateInPandasExec
        return AggregateInPandasExec(self.node.key_names, self.node.aggs,
                                     self._host_child())


class WindowInPandasMeta(_PandasMeta):
    exec_name = "WindowInPandasExec"

    def to_host(self):
        from ..exec.python_exec import WindowInPandasExec
        return WindowInPandasExec(self.node.partition_names,
                                  self.node.order_names,
                                  self.node.windows, self._host_child())


_PANDAS_METAS = {
    L.LogicalMapInPandas: MapInPandasMeta,
    L.LogicalArrowEvalPython: ArrowEvalPythonMeta,
    L.LogicalFlatMapGroupsInPandas: FlatMapGroupsInPandasMeta,
    L.LogicalFlatMapCoGroupsInPandas: FlatMapCoGroupsInPandasMeta,
    L.LogicalAggregateInPandas: AggregateInPandasMeta,
    L.LogicalWindowInPandas: WindowInPandasMeta}
_PANDAS_NODES = tuple(_PANDAS_METAS)

_META_FOR = {
    **_PANDAS_METAS,
    L.LogicalScan: ScanMeta, L.LogicalProject: ProjectMeta,
    L.LogicalFilter: FilterMeta, L.LogicalAggregate: AggregateMeta,
    L.LogicalSort: SortMeta, L.LogicalLimit: LimitMeta,
    L.LogicalJoin: JoinMeta, L.LogicalUnion: UnionMeta,
    L.LogicalRange: RangeMeta, L.LogicalExpand: ExpandMeta,
    L.LogicalSample: SampleMeta, L.LogicalWindow: WindowMeta,
    L.LogicalGenerate: GenerateMeta,
}


def wrap_plan(node: L.LogicalPlan, conf: TpuConf,
              parent: Optional[PlanMeta] = None) -> PlanMeta:
    return _META_FOR[type(node)](node, conf, parent)


# ---------------------------------------------------------------------------
# Entry point (GpuOverrides.applyOverrides analogue)
# ---------------------------------------------------------------------------

class PhysicalQuery:
    """A tagged and converted plan, with the conf and the device it runs
    with.  `kind` is where its root runs: "device" (a PlanNode) or "host"
    (a CPU HostNode); `collect` gives a HostBatch either way."""

    def __init__(self, meta: PlanMeta, kind: str, root, conf: TpuConf,
                 device: torch.device):
        self.meta = meta
        self.kind = kind
        self.root = root
        self.conf = conf
        self.device = device

    def collect(self, ctx: Optional[ExecContext] = None) -> HostBatch:
        """Run the query inside its recovery scope: the per-batch fault
        sites on the root, the query's injector active, a device permit
        (runtime/semaphore.py), the crash-capture scope
        (runtime/failure.py) and the query-level OOM rungs.  Device- and
        host-kind plans take the same scope."""
        from ..exec.plan import query_scope
        from ..runtime import faults
        from ..runtime.semaphore import device_permit
        from .datetime import conf_timezone, set_session_timezone
        ctx = ctx or ExecContext(self.conf, self.device)
        # the CPU engine's datetime expressions read the session zone
        set_session_timezone(conf_timezone(self.conf))
        install_fault_injection(self.root, self.conf)
        prev = faults.get_active_injector()
        faults.set_active(faults.get_injector(ctx.conf))
        try:
            with query_scope(ctx), device_permit(self.conf, ctx.metrics), \
                    crash_capture(self.conf, ctx):
                return self._collect_with_query_retry(ctx)
        finally:
            faults.set_active(prev)
            for k, v in list(ctx.metrics.items()):
                if isinstance(v, torch.Tensor):
                    # counters kept on the device (the bloom stage's
                    # filtered rows) sync once, here
                    ctx.metrics[k] = int(v)
            if ctx._budget is not None:
                for k, v in ctx.budget.metrics.items():
                    ctx.metrics[f"memory.{k}"] = v

    def _collect_with_query_retry(self, ctx: ExecContext) -> HostBatch:
        """The query-level rungs of the recovery ladder (the reference's
        task-retry role).  An OOM that escapes every operator retry (the
        split ladder's TpuSplitAndRetryOOM included) first escalates into
        the out-of-core rung: spill everything and replay with
        `ctx.ooc_force`, so every eligible join and aggregation runs
        spill-partitioned (exec/ooc.escalate).  An OOM that survives that
        replay reaches the last rung, one whole-query replay
        (`query_oom_replays`).  Plans replay idempotently; anything else,
        or an OOM past the last rung, propagates for classification.  A
        replay starts only after the failed attempt's frames, and the
        device tensors they hold, are gone, and with no shared subtree
        of it left (`ctx.shared`)."""
        from ..config import RETRY_ENABLED
        from ..exec import ooc as O
        from ..runtime.memory import is_oom_error
        while True:
            try:
                return self._collect_once(ctx)
            except Exception as e:               # noqa: BLE001
                if not ctx.conf.get(RETRY_ENABLED) or not is_oom_error(e) \
                        or ctx.metrics.get("query_oom_replays"):
                    raise
                if not O.escalate(ctx, e):
                    ctx.bump("query_oom_replays")
            for held, _readers in ctx.shared.values():
                for sp in held:
                    sp.close()
            ctx.shared.clear()
            # the failed attempt's generators and frames form cycles:
            # collect them, so that their device tensors and spillables
            # are released before the replay allocates
            gc.collect()
            if ctx._budget is not None:
                ctx.budget.spill_all()

    def _whole_plan_enabled(self) -> bool:
        """`sql.compile.wholePlan`: ON captures on either device, OFF
        never.  AUTO stays eager on the port (the reference's AUTO means
        "on the accelerator"): the port's benchmark is to settle it
        (README "Whole-plan capture")."""
        from ..config import WHOLE_PLAN_COMPILE
        return str(self.conf.get(WHOLE_PLAN_COMPILE)).upper() == "ON"

    def _collect_once(self, ctx: ExecContext) -> HostBatch:
        if self._whole_plan_enabled() and not ctx.ooc_force:
            # an escalated context runs the eager engine: the out-of-core
            # tier lives there, while a graph holds its intermediates
            # outside the budget's reach
            from ..exec.compiled import collect_with_fallback
            top = self._renest_top()
            if self.kind == "device":
                out = collect_with_fallback(self.root, ctx, cache_on=self)
                if out is not None:
                    return out
            elif top is not None:
                # the shatter's re-nesting projection (plan/structs.py) is
                # a CPU operator over a device plan: the device part
                # captures, the projection runs on the host over its
                # result
                out = collect_with_fallback(top.child.device_child, ctx,
                                            cache_on=self)
                if out is not None:
                    return top.project(out)
        return self.root.collect(ctx)

    def _renest_top(self):
        """The root CpuProjectExec straight over a device plan, when the
        projection is the shatter's re-nest (else None)."""
        from .collections import (CreateNamedStruct, RenestArrayStruct,
                                  RenestMap)
        root = self.root
        if isinstance(root, H.CpuProjectExec) and \
                isinstance(root.child, H.DeviceToHostExec) and \
                any(isinstance(e, (CreateNamedStruct, RenestMap,
                                   RenestArrayStruct)) for e in root.exprs):
            return root
        return None

    def prewarm(self, ctx: Optional[ExecContext] = None) -> bool:
        """Capture this query's whole plan WITHOUT running it (the
        ahead-of-traffic warm-up).  A split plan captures its first
        segment, the only one whose input is known; the later ones
        capture at run time.  True when a graph is ready; False for a
        host-kind plan, whole-plan capture off, or a plan that needs a
        host decision."""
        from ..exec.compiled import (CompiledPlan, SplitCompiledPlan,
                                     build_plan)
        from ..runtime.capture import HostDecision
        if self.kind != "device" or not self._whole_plan_enabled():
            return False
        ctx = ctx or ExecContext(self.conf, self.device)
        plan = getattr(self, "_compiled_plan", None)
        if plan is False:
            return False
        try:
            if plan is None:
                plan = build_plan(self.root, ctx)
            if isinstance(plan, SplitCompiledPlan):
                plan._install_leaves()
                try:
                    plan._segment(0, (), ctx).ensure_compiled(ctx)
                finally:
                    plan._restore_leaves()
            else:
                assert isinstance(plan, CompiledPlan)
                plan.ensure_compiled(ctx)
        except HostDecision as e:
            self._compiled_plan = False
            self._compiled_reason = f"{type(e).__name__}: {e}"
            return False
        self._compiled_plan = plan
        return True

    def explain(self) -> str:
        """The placement, one line a logical node, in the reference's
        words."""
        return "\n".join(self.meta.explain_lines())

    def physical_tree(self) -> str:
        return self.root.tree_string()

    def fallback_reasons(self) -> List[str]:
        """Every tagger reason in the meta tree (depth-first): the
        structured form of the '!Exec ... because ...' lines."""
        out, stack = [], [self.meta]
        while stack:
            m = stack.pop()
            for r in m.reasons:
                if r not in out:
                    out.append(r)
            stack.extend(m.children)
        return out


def apply_overrides(plan: L.LogicalPlan, conf: TpuConf = DEFAULT_CONF,
                    device=None) -> PhysicalQuery:
    """Prune, wrap, tag and convert a logical plan (`device` None means
    "cuda" and raises without a card: `resolve_device`)."""
    device = resolve_device(device)
    if conf.sql_enabled:
        # the nested-type shatter matters only for the device's
        # placement: the CPU engine (the oracle) keeps the nested plan
        from .structs import shatter_nested
        plan = shatter_nested(plan)
    meta = wrap_plan(prune_columns(plan), conf)
    meta.tag()
    if conf.get(CBO_ENABLED):
        from .cbo import apply_cbo
        apply_cbo(meta)
    if conf.sql_enabled:
        meta.check_unported()
    mode = conf.explain
    if mode != "NONE":
        for line in meta.explain_lines():
            if mode == "ALL" or line.lstrip().startswith("!"):
                log.info(line)
    kind, root = meta.convert()
    if kind == "device":
        from ..config import JOIN_LATE_MATERIALIZATION, JOIN_LAZY_SELECTION
        dedupe_agg_twins(root)
        if conf.get(JOIN_LAZY_SELECTION):
            negotiate_lazy_sel(root)
        if conf.get(JOIN_LATE_MATERIALIZATION):
            negotiate_thin(root)
        from ..ops.encodings import encoding_policy
        if encoding_policy(conf).narrow_lanes:
            negotiate_encoded(root)
    return PhysicalQuery(meta, kind, root, conf, device)


# ---------------------------------------------------------------------------
# Selection vectors and thin batches (exec/join.py, columnar/lanes.py)
# ---------------------------------------------------------------------------

def negotiate_lazy_sel(root: PlanNode) -> None:
    """Mark the joins whose parent reads liveness as a mask (the
    reference's `_negotiate_lazy_sel`, `sql.join.lazySelection`): an
    aggregation folds a selection vector into its live lane, a parent
    join into its probe liveness, and filters and projections in between
    pass it on.  A marked join emits `DeviceBatch.sel` instead of
    compacting its output."""
    from ..exec.adaptive import AdaptiveShuffledJoinExec
    from ..exec.join import HashJoinExec
    joins = (HashJoinExec, AdaptiveShuffledJoinExec)

    def producer(node):
        while isinstance(node, (FilterExec, ProjectExec)):
            node = node.child
        return node if isinstance(node, joins) else None

    seen = set()

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, HashAggregateExec):
            p = producer(node.child)
        elif isinstance(node, joins):
            p = producer(node.left)             # the probe side only
        else:
            p = None
        if p is not None:
            p.lazy_sel = True
        for c in node.children:
            walk(c)

    walk(root)


def negotiate_thin(root: PlanNode) -> None:
    """The legality pass of late materialization (the reference's
    `_negotiate_thin`, `sql.join.lateMaterialization.enabled`): mark
    every equi-join whose consumers, through the thin-transparent
    operators (a projection passes deferred references through, a filter
    composes its mask into the selection vector), end in a sink that
    resolves deferred columns with composed gathers: an aggregation, a
    sort, top-N, a limit, a coalesce, COUNT(DISTINCT), an expand, or
    another join (both of whose sides take thin input).  A marked join
    emits thin batches.  The reference's exchange and collect sinks are
    not in the port yet (ROADMAP Queue 1 items 7 and 9).  A join under
    any other node stays dense: windows, unions, samples, the CPU
    transitions, and the root, whose result fetch the caller may take
    batch by batch."""
    from ..exec.adaptive import AdaptiveShuffledJoinExec
    from ..exec.distinct import DistinctAggregateExec
    from ..exec.join import HashJoinExec
    from ..exec.plan import CoalesceBatchesExec
    joins = (HashJoinExec, AdaptiveShuffledJoinExec)
    transparent = (ProjectExec, FilterExec)
    sinks = (HashAggregateExec, SortExec, TopNExec, CoalesceBatchesExec,
             LimitExec, DistinctAggregateExec, ExpandExec)
    allowed: dict = {}            # id(join) -> AND over its consumers
    found: dict = {}

    def walk(node, thin_ok: bool):
        if isinstance(node, joins):
            allowed[id(node)] = allowed.get(id(node), True) and thin_ok
            found[id(node)] = node
            for c in node.children:
                walk(c, True)
        elif isinstance(node, transparent):
            walk(node.child, thin_ok)
        else:
            for c in node.children:
                walk(c, isinstance(node, sinks))

    walk(root, False)
    for nid, node in found.items():
        if allowed[nid]:
            node.thin_payload = frozenset(node.output_schema.names)


def negotiate_encoded(root: PlanNode) -> None:
    """The legality pass of FOR-narrowed scan uploads (the reference's
    `_negotiate_encoded`, `sql.encoded.narrow.lanes`): a scan's columns
    upload narrowed while every consumer up the chain is one of the
    operators below, which either compute on narrow lanes (comparisons
    and arithmetic, plan/expressions.py) or read them widened
    (`NarrowColumn.data`).  A scan under any other node (a window, the
    CPU transitions) keeps full-width lanes.  The verdict is per scan;
    the reference's exchange and collect nodes are not in the port yet
    (ROADMAP Queue 1 items 7 and 9)."""
    from ..exec.adaptive import AdaptiveShuffledJoinExec
    from ..exec.distinct import DistinctAggregateExec
    from ..exec.join import CrossJoinExec, HashJoinExec
    from ..exec.plan import CoalesceBatchesExec
    safe = (ProjectExec, FilterExec, HashJoinExec, AdaptiveShuffledJoinExec,
            CrossJoinExec, HashAggregateExec, DistinctAggregateExec,
            SortExec, TopNExec, CoalesceBatchesExec, LimitExec, UnionExec,
            ExpandExec, SampleExec)
    allowed: dict = {}
    scans: dict = {}

    def walk(node, enc_ok: bool):
        if isinstance(node, HostScanExec):
            allowed[id(node)] = allowed.get(id(node), True) and enc_ok
            scans[id(node)] = node
            return
        ok = enc_ok and isinstance(node, safe)
        for c in node.children:
            walk(c, ok)

    walk(root, True)          # the result fetch reads widened lanes
    for nid, node in scans.items():
        node.encoded_cols = frozenset(node.output_schema.names) \
            if allowed[nid] else None


# ---------------------------------------------------------------------------
# Plan-level CSE of aggregate subtrees
# ---------------------------------------------------------------------------

def _subtree_fp(node) -> Optional[str]:
    """A physical subtree's identity: full expression fingerprints
    (literal values kept), node extras and, per scan, the source table
    (a scan pruned to other columns of the same table is another
    HostBatch sharing the table's statistics) with its columns and batch
    size; None where the walk does not cover a node.  The node walk is
    the capture key's (exec/compiled.py)."""
    from ..exec.compiled import _node_exprs, _node_extras
    exprs = _node_exprs(node)
    if exprs is None:
        return None
    parts = [type(node).__name__, ";".join(e.fingerprint() for e in exprs),
             repr(_node_extras(node))]
    if isinstance(node, HostScanExec):
        parts.append(f"tbl{id(node.table._stats)}:{node.table.names}:"
                     f"{node.batch_rows}")
    for c in node.children:
        cfp = _subtree_fp(c)
        if cfp is None:
            return None
        parts.append(cfp)
    return "(" + "|".join(parts) + ")"


def dedupe_agg_twins(root: PlanNode) -> None:
    """Plan-level CSE for aggregate subtrees (the reference's
    `_dedupe_agg_twins`): a grouped view that one query reads several
    times (q15's revenue view, read directly and under its own MAX)
    converts into identical but separate physical subtrees; later
    references are re-pointed at the first subtree object.  The
    identity is `_subtree_fp`: aggregates over different tables (the
    q56 class: one shape per channel) never merge.  Sharing the object
    alone saves nothing on the port's eager path, where each parent
    runs its child again: the shared aggregate counts its readers
    (`HashAggregateExec.shared_readers`) and runs once per query."""
    by_fp: dict = {}
    seen = set()
    readers: dict = {}

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for i, c in enumerate(node.children):
            if isinstance(c, HashAggregateExec):
                cfp = _subtree_fp(c)
                if cfp is not None:
                    first = by_fp.setdefault(cfp, c)
                    if first is not c:
                        node.children[i] = c = first
            readers[id(c)] = (c, readers.get(id(c), (c, 0))[1] + 1)
            walk(c)

    walk(root)
    for node, n in readers.values():
        if isinstance(node, HashAggregateExec) and n > 1:
            node.shared_readers = n


# ---------------------------------------------------------------------------
# The rule registry and the supported-ops table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExprRule:
    cls: type
    input_sig: t.TypeSig
    output_sig: t.TypeSig
    desc: str = ""


@dataclasses.dataclass
class ExecRule:
    cls: type
    output_sig: t.TypeSig
    desc: str = ""


#: the port's classes with the reference's type signatures (its
#: `_EXPR_RULES`, `_AGG_RULES`, `_EXEC_RULES`), for the classes the port
#: has; tagging reads each class's own `unsupported_reasons`
EXPR_RULES: dict = {}
AGG_RULES: dict = {}
EXEC_RULES: dict = {}


def _rules(into, module, names, input_sig, output_sig=None, desc=""):
    for name in names.split():
        cls = getattr(module, name, None)
        if cls is not None:
            into[cls] = ExprRule(cls, input_sig, output_sig or input_sig,
                                 desc)


def _register_rules() -> None:
    from . import aggregates as A
    from . import datetime as DT
    from . import strings as STR
    T = t.T
    common = T.DEVICE_COMMON
    simple = T.NUMERIC + T.STRING + T.BOOLEAN + T.DATETIME + T.NULL
    x = EXPR_RULES
    from . import collections as C
    _rules(x, E, "ColumnRef", common + T.ARRAY, desc="column reference")
    arr = common + T.ARRAY
    for names, desc in (
            ("Size", "size(array) from the offsets lane"),
            ("GetArrayItem", "array[i] gather"),
            ("ArrayContains", "segment any-equal"),
            ("ArrayMin", "segment min"), ("ArrayMax", "segment max"),
            ("SortArray", "segment-local lexsort"),
            ("ArrayTransform", "lambda over the flat values lane"),
            ("ArrayFilter", "values-lane compaction"),
            ("ArrayExists", "segment three-valued any"),
            ("ArrayForAll", "segment three-valued all"),
            ("LambdaVar", "lambda-bound element variable"),
            ("ElementAt", "1-based element gather (negative from end)"),
            ("ArrayPosition", "segment first-match position"),
            ("Slice", "values-lane range compaction"),
            ("ReverseArray", "per-row reversal gather"),
            ("ArrayRepeat", "array_repeat (CPU)"),
            ("Flatten", "flatten array<array> (CPU)"),
            ("ArrayDistinct", "first-occurrence dedupe (CPU)"),
            ("ArraysOverlap", "3-valued set overlap (CPU)"),
            ("ArrayUnion", "set union (CPU)"),
            ("ArrayIntersect", "set intersect (CPU)"),
            ("ArrayExcept", "set except (CPU)"),
            ("ArrayRemove", "drop equal elements (CPU)"),
            ("ArrayJoin", "string join (CPU)"),
            ("Sequence", "integral range generation (CPU)")):
        _rules(x, C, names, arr, desc=desc)
    for names, desc in (
            ("StrToMap", "str_to_map (CPU)"),
            ("MapFromArrays", "map_from_arrays (CPU)"),
            ("MapConcat", "map_concat LAST_WIN (CPU)"),
            ("MapEntries", "map_entries (CPU)"),
            ("TransformValues", "map value lambda (CPU)"),
            ("TransformKeys", "map key lambda (CPU)"),
            ("MapFilter", "map entry filter (CPU)")):
        _rules(x, C, names, common + T.MAP + T.ARRAY + T.STRUCT, desc=desc)
    from . import json_fns as JSON
    from . import misc as MISC
    _rules(x, JSON, "FromJson", T.ALL,
           desc="from_json (STRUCT result: CPU path, per-expression "
                "tagging — GpuJsonToStructs role)")
    _rules(x, JSON, "ToJson", T.ALL,
           desc="to_json (STRUCT input: CPU path — GpuStructsToJson role)")
    _rules(x, JSON, "GetJsonObject", T.STRING,
           desc="get_json_object (dictionary transform)")
    _rules(x, MISC, "MonotonicallyIncreasingID", common,
           desc="nondeterministic unique int64 per row (batch-indexed)")
    _rules(x, MISC, "SparkPartitionID", common,
           desc="batch ordinal (the engine's partition analogue)")
    _rules(x, MISC, "InputFileName", common,
           desc="scan provenance of the current batch; '' when unknown")
    from . import hive_udf as HIVE
    from . import udf as UDF
    _rules(x, HIVE, "HiveSimpleUDF HiveGenericUDF", T.ALL_SIMPLE + T.NULL,
           desc="hive UDF: device when TpuHiveUDF (RapidsUDF role), "
                "row-based host otherwise (rowBasedHiveUDFs role)")
    _rules(x, UDF, "TpuUDF", T.NUMERIC + T.BOOLEAN + T.DATETIME,
           desc="columnar UDF over torch tensors (runs on the operator's "
                "device lanes)")
    _rules(x, UDF, "PythonUDF", T.ALL_SIMPLE,
           desc="row-at-a-time python UDF (always CPU path)")
    _rules(x, E, "Literal", common + T.NULL, desc="literal value")
    _rules(x, E, "Alias", common, desc="named expression")
    _rules(x, E, "Add Subtract Multiply Divide IntegralDivide Remainder "
           "UnaryMinus Abs", T.NUMERIC + T.NULL, desc="arithmetic")
    _rules(x, E, "EqualTo NotEqual LessThan LessThanOrEqual GreaterThan "
           "GreaterThanOrEqual EqualNullSafe", T.COMPARABLE, T.BOOLEAN,
           desc="comparison")
    _rules(x, E, "And Or Not", T.BOOLEAN + T.NULL, T.BOOLEAN,
           desc="boolean logic")
    _rules(x, E, "IsNull IsNotNull", T.ALL_SIMPLE, T.BOOLEAN,
           desc="null predicate")
    _rules(x, E, "IsNaN", T.FP, T.BOOLEAN, desc="NaN predicate")
    _rules(x, E, "Coalesce", common, desc="first non-null")
    _rules(x, E, "If", common, desc="if/else")
    _rules(x, E, "CaseWhen", common, desc="case/when")
    _rules(x, E, "In", common, T.BOOLEAN, desc="IN list")
    _rules(x, E, "Sqrt Exp Log Pow Sin Cos Tan Asin Acos Atan Sinh Cosh "
           "Tanh Log10 Log2 Cbrt Signum Atan2 ToDegrees ToRadians Expm1 "
           "Log1p Rint Cot Sec Csc Hypot", T.NUMERIC, T.FP, desc="math fn")
    _rules(x, E, "Floor Ceil", T.NUMERIC, T.INTEGRAL, desc="rounding")
    _rules(x, E, "Round BRound", T.NUMERIC,
           desc="round/bround (HALF_UP / HALF_EVEN)")
    _rules(x, E, "Greatest Least",
           T.NUMERIC + T.DATETIME + T.BOOLEAN + T.NULL,
           desc="n-ary extremum (null-skipping, NaN greatest)")
    _rules(x, E, "BitwiseAnd BitwiseOr BitwiseXor BitwiseNot",
           T.INTEGRAL + T.NULL, desc="bitwise op")
    _rules(x, E, "ShiftLeft ShiftRight ShiftRightUnsigned",
           T.INTEGRAL + T.NULL, desc="Java shift (distance mod width)")
    _rules(x, E, "BitCount", T.INTEGRAL + T.BOOLEAN, T.INTEGRAL,
           desc="population count")
    _rules(x, E, "Murmur3Hash", common, T.INTEGRAL,
           desc="Spark hash() — bit-exact murmur3 device kernels")
    _rules(x, E, "XxHash64", common, T.INTEGRAL,
           desc="Spark xxhash64() — bit-exact XXH64 device kernels")
    _rules(x, E, "WidthBucket", T.NUMERIC, T.INTEGRAL,
           desc="ANSI histogram bucket")
    _rules(x, E, "RaiseError", T.ALL_SIMPLE + T.NULL,
           desc="raise_error (CPU path: device programs cannot throw)")
    _rules(x, E, "Cast", T.ALL_SIMPLE,
           desc="cast (pairs gated by Cast itself)")
    _rules(x, DT, "Year Month DayOfMonth DayOfWeek WeekDay DayOfYear "
           "Quarter WeekOfYear", T.DATETIME, T.INTEGRAL,
           desc="date field extract")
    _rules(x, DT, "Hour Minute Second", T.TIMESTAMP, T.INTEGRAL,
           desc="time field extract")
    _rules(x, DT, "DateAdd DateSub AddMonths LastDay TruncDate",
           T.DATE + T.INTEGRAL, T.DATE, desc="date arithmetic")
    _rules(x, DT, "DateDiff", T.DATE, T.INTEGRAL, desc="date difference")
    _rules(x, DT, "ToUnixTimestamp", T.DATETIME, T.INTEGRAL,
           desc="epoch seconds")
    _rules(x, STR, "Upper Lower InitCap StringTrim StringTrimLeft "
           "StringTrimRight Substring Concat ConcatWs StringReplace Lpad "
           "Rpad StringRepeat Reverse SplitPart",
           T.STRING + T.INTEGRAL + T.NULL, T.STRING,
           desc="string transform (dictionary rewrite)")
    _rules(x, STR, "Length OctetLength BitLength StringLocate Instr Ascii",
           T.STRING + T.INTEGRAL, T.INTEGRAL,
           desc="string measure (device byte kernel / dict gather)")
    _rules(x, STR, "StartsWith EndsWith Contains Like RLike", T.STRING,
           T.BOOLEAN, desc="string predicate (device byte kernel)")
    _rules(x, STR, "RegexpExtract RegexpReplace", T.STRING,
           desc="regex extract/replace (dictionary transform)")
    _rules(x, STR, "ParseUrl", T.STRING,
           desc="parse_url (JNI ParseURI role; dictionary transform)")
    _rules(x, STR, "Conv", T.STRING + T.INTEGRAL, T.STRING,
           desc="base conversion (dictionary transform)")
    _rules(x, STR, "Hex", T.STRING, T.STRING,
           desc="hex of UTF-8 bytes (dictionary transform)")
    _rules(x, STR, "FormatNumber", T.NUMERIC, T.STRING,
           desc="format_number (CPU path)")
    _rules(x, STR, "Bin", T.INTEGRAL, T.STRING, desc="bin (CPU path)")
    _rules(x, STR, "Translate SubstringIndex Left Right Base64E UnBase64 "
           "SoundEx", T.STRING + T.INTEGRAL + T.NULL, T.STRING,
           desc="string transform (dictionary rewrite)")
    _rules(x, STR, "Levenshtein FindInSet", T.STRING, T.INTEGRAL,
           desc="string measure (dictionary int transform)")
    _rules(AGG_RULES, A, "Count Sum Min Max Average First Last BoolAnd "
           "BoolOr", common, desc="aggregate function")
    _rules(AGG_RULES, A, "VariancePop VarianceSamp StddevPop StddevSamp "
           "Corr CovarPop CovarSamp", T.NUMERIC, T.FP,
           desc="statistical aggregate (moment sums on device)")
    _rules(AGG_RULES, A, "CountDistinct", common, T.INTEGRAL,
           desc="count(DISTINCT) as a sorted value-change count")
    _rules(AGG_RULES, A, "Percentile ApproximatePercentile Median",
           T.NUMERIC, T.FP,
           desc="sort-based device percentile (exact; satisfies the "
                "approx rank-error contract trivially)")
    _rules(AGG_RULES, A, "CollectList CollectSet", common, common + T.ARRAY,
           desc="collect as a sorted group-by emitting ragged lanes")
    # ragged ARRAY<primitive|string> lanes: scans upload them, projections
    # carry and compute over them, Generate explodes them; the row
    # reordering operators keep the CPU path (the reference's)
    ragged_elem = (T.INTEGRAL + (T.FP - t.TypeSig(frozenset({"DOUBLE"})))
                   + T.BOOLEAN + T.DATE + T.STRING)
    device_ragged = (simple + T.ARRAY).with_nested(ragged_elem)
    for cls, sig, desc in (
            (L.LogicalScan, device_ragged,
             "in-memory scan + device upload"),
            (L.LogicalProject, (common + T.ARRAY).with_nested(ragged_elem),
             "projection"),
            (L.LogicalGenerate, device_ragged,
             "explode/posexplode over ragged values+offsets lanes"),
            (L.LogicalFilter, simple, "filter"),
            (L.LogicalAggregate, common + T.ARRAY, "hash aggregate"),
            (L.LogicalSort, T.ORDERABLE, "sort"),
            (L.LogicalLimit, simple, "limit"),
            (L.LogicalJoin, common, "hash join"),
            (L.LogicalUnion, simple, "union"),
            (L.LogicalRange, simple, "range generator"),
            (L.LogicalExpand, common, "expand (grouping sets)"),
            (L.LogicalSample, simple, "bernoulli sample (counter-based "
             "hash, seed-deterministic)"),
            (L.LogicalWindow, common, "window functions (partition-sorted "
             "segmented scans)"),
            (L.LogicalMapInPandas, T.ALL,
             "mapInPandas via forked python workers (numpy wire)"),
            (L.LogicalArrowEvalPython, T.ALL,
             "scalar pandas UDFs via forked python workers (numpy wire)"),
            (L.LogicalFlatMapGroupsInPandas, T.ALL,
             "applyInPandas via group-segmented python workers"),
            (L.LogicalFlatMapCoGroupsInPandas, T.ALL,
             "cogrouped applyInPandas via paired python-worker frames"),
            (L.LogicalAggregateInPandas, T.ALL,
             "grouped pandas UDAFs via group-segmented python workers"),
            (L.LogicalWindowInPandas, T.ALL,
             "pandas window UDFs via partition-segmented python workers")):
        EXEC_RULES[cls] = ExecRule(cls, sig, desc)


_register_rules()


def generate_supported_ops() -> str:
    """The supported-ops table (the reference's `generate_supported_ops`,
    docs/supported_ops.md) from the port's registry."""
    lines = ["# Supported expressions and operators", "",
             "Generated from the overrides rule registry "
             "(plan/overrides.py).", "",
             "## Execs", "", "| operator | supported output types |",
             "|---|---|"]
    for cls, rule in sorted(EXEC_RULES.items(),
                            key=lambda kv: kv[0].__name__):
        lines.append(f"| {cls.__name__.removeprefix('Logical')} | "
                     f"{', '.join(sorted(rule.output_sig.tags))} |")
    lines += ["", "## Expressions", "",
              "| expression | input types | output types |", "|---|---|---|"]
    for cls, rule in sorted(EXPR_RULES.items(),
                            key=lambda kv: kv[0].__name__):
        lines.append(f"| {cls.__name__} | "
                     f"{', '.join(sorted(rule.input_sig.tags))} | "
                     f"{', '.join(sorted(rule.output_sig.tags))} |")
    lines += ["", "## Aggregate functions", "",
              "| function | input types |", "|---|---|"]
    for cls, rule in sorted(AGG_RULES.items(),
                            key=lambda kv: kv[0].__name__):
        lines.append(f"| {cls.__name__} | "
                     f"{', '.join(sorted(rule.input_sig.tags))} |")
    lines += ["", "## TPC-DS queries", "",
              "The port's TPC-DS corpus (spark_rapids_tpu_torch/tpcds.py "
              "QUERIES).", "", "| query | operator shape |", "|---|---|"]
    from .. import tpcds
    for name in sorted(tpcds.QUERIES, key=lambda q: int(q[1:])):
        doc = (tpcds.QUERIES[name].__doc__ or "").strip()
        para = " ".join(ln.strip()
                        for ln in doc.split("\n\n")[0].splitlines())
        lines.append(f"| {name} | {para} |")
    lines.append("")
    return "\n".join(lines)
