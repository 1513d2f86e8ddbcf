"""Spill-partitioned out-of-core group-by aggregation.

Counterpart of spark_rapids_tpu/exec/ooc_agg.py (GpuAggregateExec's
repartition-based fallback grown into a tier):

  * partial aggregates hash-scatter by GROUP KEY
    (`exec/plan._agg_partition_ids`) into budget-registered `Spillable`
    buckets; key-disjoint buckets make the union of the per-bucket
    results exact, and each bucket finishes on the resident group-by
    tiers;
  * the fan-out comes from the partials' measured bytes against the
    resident window (exec/ooc.py), floored by
    `sql.agg.fallbackPartitions`;
  * a bucket whose rows exceed two target batches re-scatters with a
    re-salted hash (at most `sql.ooc.maxDepth` deep); merges inside a
    bucket roll two batches at a time under `with_retry`.

`HashAggregateExec` (exec/plan.py) decides WHEN to elect this tier;
this module owns the buckets' lifecycle, including the idempotent-close
sweep that an abandoned generator (a LIMIT above) relies on.
"""
from __future__ import annotations

from typing import Iterator, List

from ..columnar.device import DeviceBatch
from ..config import AGG_FALLBACK_PARTITIONS
from ..runtime.memory import Spillable
from ..runtime.retry import with_retry
from . import ooc as O


class OutOfCoreAggregator:
    """Bucket lifecycle of one spill-partitioned aggregation."""

    def __init__(self, agg, nkeys: int, ctx, policy: "O.OocPolicy",
                 k: int):
        self.agg = agg                       # exec.aggregate.HashAggregate
        self.nkeys = nkeys
        self.ctx = ctx
        self.policy = policy
        self.k = k
        self.buckets: List[list] = [[] for _ in range(k)]
        self._scattered = 0

    def _scatter(self, pb: DeviceBatch, buckets, salt: int) -> int:
        """Scatter a partial batch by its group keys; -> live bytes."""
        return O.scatter(pb, pb.columns[:self.nkeys], pb.row_mask(),
                         buckets, salt, self.ctx)

    def add(self, pb: DeviceBatch) -> None:
        """Scatter one partial into the top-level buckets."""
        self._scattered += self._scatter(pb, self.buckets, 0)

    def results(self) -> Iterator[DeviceBatch]:
        ctx = self.ctx
        O.record_partitions(ctx, "agg", self.k, self._scattered)
        try:
            for p, blist in enumerate(self.buckets):
                if blist:
                    O.fire(ctx, "agg", bucket=p, k=self.k, depth=0)
                    yield from self._finalize(blist, 1)
        finally:
            # an abandoned generator or a failure releases every bucket
            self.close()

    def _finalize(self, blist, depth: int) -> Iterator[DeviceBatch]:
        """Merge and finish one bucket.  A bucket whose row count (its
        distinct-key bound) exceeds two target batches re-scatters with
        another salt; the rolling merge keeps two batches resident
        whatever the bucket's byte volume."""
        ctx, conf, policy = self.ctx, self.ctx.conf, self.policy
        total = sum(sp.num_rows for sp in blist)
        total_bytes = sum(sp.live_nbytes for sp in blist)
        rows_trip = len(blist) > 1 and total > 2 * conf.batch_size_rows
        sub: List[list] = []
        acc = None
        try:
            if depth < policy.max_depth and rows_trip:
                k = conf.get(AGG_FALLBACK_PARTITIONS)
                if policy.bytes_trip(total_bytes):
                    O.record_recursion(ctx, "agg")
                    k = max(k, O.partition_count(total_bytes, policy))
                sub = [[] for _ in range(k)]
                added = 0
                for sp in blist:
                    b = sp.get()
                    sp.close()
                    added += self._scatter(b, sub, salt=depth)
                ctx.bump("agg_repartition_fallbacks")
                O.record_partitions(ctx, "agg", k, added)
                for p, sl in enumerate(sub):
                    if sl:
                        O.fire(ctx, "agg", bucket=p, k=k, depth=depth)
                        yield from self._finalize(sl, depth + 1)
                return
            acc = blist[0]
            for sp in blist[1:]:
                # both inputs stay registered through the merge attempt,
                # so the retry's spill_all can demote them; get() inside
                # the attempt re-materializes after a spill
                a, b = acc, sp
                merged = with_retry(ctx.budget, conf,
                                    lambda: self.agg.merge([a.get(),
                                                            b.get()]))
                nxt = Spillable(merged, ctx.budget,
                                live_nbytes=O.batch_bytes(merged))
                a.close()
                b.close()
                acc = nxt
            out = acc.get()
            acc.close()
            yield self.agg.final(out)
        finally:
            for sp in blist:
                sp.close()
            for sl in sub:
                for sp in sl:
                    sp.close()
            if acc is not None:
                acc.close()

    def close(self) -> None:
        for blist in self.buckets:
            for sp in blist:
                sp.close()
