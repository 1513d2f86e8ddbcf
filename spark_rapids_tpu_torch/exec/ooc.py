"""Out-of-core execution tier: the shared budget and partition policy.

Counterpart of spark_rapids_tpu/exec/ooc.py.  What the three
out-of-core operators (the hash join's sub-partition path in
exec/join.py, exec/ooc_agg.py and exec/ooc_sort.py) share:

  * the **resident window**: `sql.ooc.residentFraction` x the query's
    device-memory budget, the bytes one operator may hold on the device
    at a time.  The spill-partition count comes from measured bytes
    against it (`partition_count`), floored by the row-derived count;
  * the **bucket scatter** (`scatter`): one batch split by a hash of
    its keys into budget-registered `Spillable` buckets, the format the
    sub-partition join and the aggregation both re-partition;
  * the **counters** every election and partition pass records in
    `ctx.metrics` (`ooc.<op>_elections`, `_partitions`, `_bytes`,
    `_recursions`, `_passes`).

Operators elect the tier when measured bytes exceed the window, when
rows exceed two target batches, or when the context forces it
(`sql.ooc.force`, or `ctx.ooc_force`, which the query-level OOM ladder
of plan/overrides.py sets through `escalate`).  Each pass boundary
(`fire`) fires the `ooc` chaos site and is a cancellation checkpoint.
The reference's `elect_proactive` reads the measured working-set
history of obs/estimator.py and ports with it (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..columnar.device import DeviceBatch, DeviceColumn
from ..config import (OOC_ENABLED, OOC_FORCE, OOC_MAX_DEPTH,
                      OOC_MAX_PARTITIONS, OOC_RESIDENT_FRACTION)
from ..ops.batch_ops import shrink_to_rows
from ..ops.filter import compact_batch
from ..runtime.faults import get_injector
from ..runtime.memory import Spillable


@dataclasses.dataclass(frozen=True)
class OocPolicy:
    """Resolved out-of-core policy for one ExecContext."""
    enabled: bool
    force: bool                  # sql.ooc.force or a forced context
    window: Optional[int]        # resident window bytes; None = unlimited
    max_partitions: int
    max_depth: int

    def bytes_trip(self, nbytes: int) -> bool:
        """Whether `nbytes` of working set exceeds the resident window."""
        return self.enabled and self.window is not None and \
            nbytes > self.window


def ooc_policy(ctx) -> OocPolicy:
    """The out-of-core policy of a query context.  The window derives
    from the same budget the operators register their spillables with,
    so electing the tier and fitting under the budget agree."""
    conf = ctx.conf
    enabled = bool(conf.get(OOC_ENABLED))
    force = enabled and (bool(conf.get(OOC_FORCE)) or ctx.ooc_force)
    window = None
    if enabled and ctx.budget.limit:
        window = max(int(ctx.budget.limit *
                         float(conf.get(OOC_RESIDENT_FRACTION))), 1 << 14)
    return OocPolicy(enabled, force, window,
                     int(conf.get(OOC_MAX_PARTITIONS)),
                     int(conf.get(OOC_MAX_DEPTH)))


def batch_bytes(db) -> int:
    """Approximate LIVE bytes of a device batch: its padded bytes scaled
    by the live share of its capacity (a lazy count counts as full)."""
    cap = max(int(db.capacity), 1)
    rows = db.num_rows
    rows = int(rows) if isinstance(rows, int) else cap
    return max((db.nbytes() * min(rows, cap)) // cap, 0)


def partition_count(total_bytes: int, policy: OocPolicy,
                    rows_k: int = 1) -> int:
    """Spill-partition fan-out for `total_bytes` of working set: enough
    power-of-two buckets that each holds about one resident window,
    floored by the row-derived count `rows_k` and by 2, clamped to
    `sql.ooc.maxPartitions` (a skewed bucket re-partitions recursively
    instead of widening past the clamp)."""
    k_bytes = 1
    if policy.window:
        need = -(-max(total_bytes, 1) // policy.window)    # ceil div
        k_bytes = 1 << max(need - 1, 0).bit_length()
    k = max(rows_k, k_bytes, 2)
    return min(k, max(policy.max_partitions, 2))


def scatter(db: DeviceBatch, key_cols: List[DeviceColumn],
            live: torch.Tensor, buckets: List[list], salt: int,
            ctx) -> int:
    """Split `db`'s `live` rows into `len(buckets)` hash buckets of
    `key_cols` (`exec/plan._agg_partition_ids`, bit-equal to the
    reference's), appending each non-empty part to its bucket as a
    budget-registered Spillable.  -> the live bytes added: a recursion
    decision must not count the padding of many small slices."""
    from .plan import _agg_partition_ids
    nparts = len(buckets)
    ids = _agg_partition_ids(
        DeviceBatch(key_cols, db.num_rows,
                    [f"_k{i}" for i in range(len(key_cols))]),
        len(key_cols), nparts, salt)
    added = 0
    for p in range(nparts):
        part = compact_batch(db, (ids == p) & live, ctx.conf)
        part = shrink_to_rows(part, int(part.num_rows), ctx.conf)
        if int(part.num_rows):
            sp = Spillable(part, ctx.budget, live_nbytes=batch_bytes(part))
            buckets[p].append(sp)
            added += sp.live_nbytes
    return added


def fire(ctx, op: str, **state) -> None:
    """One out-of-core pass boundary: counts the pass, records the bucket
    state it starts in `ctx.metrics`, fires the `ooc` chaos site with
    the operator and that state in the injected-fault record, and is a
    cancellation checkpoint.  The reference's tracer instant ports with
    the observability slice (ROADMAP Queue 1 item 10)."""
    ctx.bump(f"ooc.{op}_passes")
    ctx.metrics[f"ooc.{op}_state"] = dict(state)
    get_injector(ctx.conf).fire("ooc", op=op, **state)
    ctx.checkpoint(f"ooc_{op}")


def record_election(ctx, op: str, mode: str) -> None:
    ctx.bump(f"ooc.{op}_elections")
    ctx.bump(f"ooc.{op}_elections.{mode}")


def record_partitions(ctx, op: str, k: int, nbytes: int) -> None:
    ctx.bump(f"ooc.{op}_partitions", k)
    ctx.bump(f"ooc.{op}_bytes", nbytes)


def record_recursion(ctx, op: str) -> None:
    ctx.bump(f"ooc.{op}_recursions")


def escalate(ctx, err: Optional[BaseException] = None) -> bool:
    """Arm the out-of-core rung on an escaped OOM `err` (the step between
    the operator retries and the whole-query replay): every eligible
    operator runs out of core on the replay.  False when the tier is
    off or already forced (the caller then falls through to the replay
    rung).

    When `err` is the CUDA caching allocator's (not the budget's), the
    process could not hold what the budget admits (a card shared, or a
    per-process memory fraction): the budget re-bases on what the
    allocator had reserved when it failed (`MemoryBudget.rebase`), so
    that the replay spills its partitions before the operators' working
    set runs out.  The reference's budget has no such ceiling to learn
    from."""
    if not ctx.conf.get(OOC_ENABLED) or ctx.ooc_force:
        return False
    ctx.ooc_force = True
    ctx.bump("query_ooc_escalations")
    record_election(ctx, "query", "reactive")
    if isinstance(err, torch.cuda.OutOfMemoryError) and \
            ctx.device.type == "cuda":
        ctx.budget.rebase(torch.cuda.memory_reserved(ctx.device))
        ctx.metrics["query_budget_rebased_bytes"] = ctx.budget.limit
    return True
