"""Cost-based placement optimizer (the CostBasedOptimizer role).

Counterpart of spark_rapids_tpu/plan/cbo.py.  The reference's
CostBasedOptimizer.scala:54 (optional, off by default) walks the tagged
meta tree and rejects device placement where the transitions cost more
than the device saves, from static per-operator costs rather than
statistics.

The same shape here: after tagging, a device-placed operator that forms
an island (no child and no parent on the device) pays two host<->device
transitions to run one operator.  For the cheap row-parallel operators
(project, filter, limit, union, expand) the transitions dominate, so the
pass tags them for the CPU with a cost reason, visible in explain like
any other.  Joins, aggregates, sorts and windows stay on the device even
as islands.

Enabled by `spark.rapids.tpu.sql.optimizer.enabled` (default false, as
in the reference).
"""
from __future__ import annotations

from . import logical as L

#: operator classes whose device win is too small to buy two transitions
_CHEAP = (L.LogicalProject, L.LogicalFilter, L.LogicalLimit,
          L.LogicalUnion, L.LogicalExpand)


def apply_cbo(meta) -> int:
    """Post-tag pass over a PlanMeta tree; returns how many nodes were
    tagged for the CPU for cost."""
    return _walk(meta, parent_replaceable=False)


def _walk(meta, parent_replaceable: bool) -> int:
    changed = 0
    for c in meta.children:
        changed += _walk(c, parent_replaceable=meta.can_replace)
    if not meta.can_replace:
        return changed
    if not isinstance(meta.node, _CHEAP):
        return changed
    children_on_device = any(c.can_replace for c in meta.children)
    if parent_replaceable or children_on_device:
        return changed
    meta.will_not_work(
        "cost-based optimizer: isolated cheap operator — two "
        "host<->device transitions outweigh the device win "
        "(spark.rapids.tpu.sql.optimizer.enabled)")
    return changed + 1
