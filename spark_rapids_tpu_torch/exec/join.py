"""Join exec nodes over the hash-table join kernels (ops/join.py).

Counterpart of spark_rapids_tpu/exec/join.py (GpuShuffledHashJoinExec,
GpuHashJoin's gather machinery).  Output schema is left columns ++ right
columns (Spark layout); the RIGHT side is the build side, fully
materialized by concatenation, and probe batches stream through.

This slice ports the join TPC-H q3 runs: INNER, with a build side whose
single-lane keys are unique (exact plan statistics), on the hash-table
tier.  Each probe batch takes the probe-aligned path — probe_first, a
gather of the build columns at the found rows (null where none), then
one compaction of `found & fused probe filters` — so the output keeps
probe order.  Filters right below either input are peeled into masks
(build: the key-valid mask; probe: the liveness), never compacted
first.

Everything else raises NotImplementedError naming the next join slice:
other join types, non-unique or multi-lane builds, string keys, builds
over `sql.kernels.pallas.join.maxBuildRows` or the kernel tier turned
off (the reference's dense and sorted tiers), and builds over twice
`sql.batchSizeRows` (the reference sub-partitions those).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn
from ..ops import join as J
from ..ops.batch_ops import concat_batches
from ..ops.filter import compact_batch, gather_batch
from ..plan import expressions as E
from .evaluator import conds_mask, evaluate_projection
from .plan import ExecContext, PlanNode, key_ref_names, peel_filters

NEXT_JOIN_SLICE = "the next join slice (ROADMAP Queue 1)"


def side_unique(keys, side: PlanNode) -> bool:
    """A join side's keys are plain columns whose tuple is unique."""
    names = key_ref_names(keys)
    return names is not None and side.keys_unique(names)


def join_keys_unique(join_type: str, left, right, left_keys, right_keys,
                     names) -> bool:
    """Uniqueness through an equi-join: semi/anti keep a subset of left
    rows; otherwise a side's columns stay unique iff that side was unique
    AND the other side's join keys are unique (each row matches at most
    once)."""
    if join_type in (J.LEFT_SEMI, J.LEFT_ANTI):
        return left.keys_unique(names)
    if all(n in left.output_schema.names for n in names):
        return left.keys_unique(names) and side_unique(right_keys, right)
    if all(n in right.output_schema.names for n in names):
        return right.keys_unique(names) and side_unique(left_keys, left)
    return False


def unported_join_reasons(join_type: str, left_keys, right_keys
                          ) -> List[str]:
    """Why this slice cannot run a join (bound keys), [] if it can."""
    reasons = []
    if join_type != J.INNER:
        reasons.append(f"{join_type} joins port with {NEXT_JOIN_SLICE}")
    if len(left_keys) != 1:
        reasons.append("only single-column equi-joins are ported; "
                       f"composite keys port with {NEXT_JOIN_SLICE}")
    if any(isinstance(e.dtype, t.StringType)
           for e in list(left_keys) + list(right_keys)):
        reasons.append("string join keys (dictionary unification across "
                       f"sides) port with {NEXT_JOIN_SLICE}")
    return reasons


def join_column_range(join_type: str, left, right, name):
    """Value ranges through a join: joins gather existing rows, so a
    column's range only narrows (outer-join nulls are not values)."""
    if name in left.output_schema.names:
        return left.column_range(name)
    if join_type not in (J.LEFT_SEMI, J.LEFT_ANTI) and \
            name in right.output_schema.names:
        return right.column_range(name)
    return None


class HashJoinExec(PlanNode):
    """Equi-join with the RIGHT side as the build side (callers swap the
    inputs to choose, as exec/adaptive.py does)."""

    def __init__(self, join_type: str, left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression],
                 left: PlanNode, right: PlanNode,
                 probe_conds: Optional[List[E.Expression]] = None,
                 build_conds: Optional[List[E.Expression]] = None):
        super().__init__(left, right)
        self.join_type = join_type
        self.left_keys = [e.bind(left.output_schema) for e in left_keys]
        self.right_keys = [e.bind(right.output_schema) for e in right_keys]
        reasons = unported_join_reasons(join_type, self.left_keys,
                                        self.right_keys)
        if reasons:
            raise NotImplementedError("; ".join(reasons))
        # pre-fused filter predicates, evaluated as masks on raw batches
        self.probe_conds = list(probe_conds or [])
        self.build_conds = list(build_conds or [])

    @property
    def left(self) -> PlanNode:
        return self.children[0]

    @property
    def right(self) -> PlanNode:
        return self.children[1]

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType(list(self.left.output_schema.fields) +
                            list(self.right.output_schema.fields))

    def keys_unique(self, names) -> bool:
        return join_keys_unique(self.join_type, self.left, self.right,
                                self.left_keys, self.right_keys, names)

    def column_range(self, name):
        return join_column_range(self.join_type, self.left, self.right,
                                 name)

    def _key_cols(self, db: DeviceBatch, exprs, ctx) -> List[DeviceColumn]:
        """Key columns: plain references read the storage lane as is (so
        both sides' lanes match), anything else is projected."""
        names = key_ref_names(exprs)
        if names is not None:
            return [db.column_by_name(n) for n in names]
        return evaluate_projection(exprs, [f"_k{i}" for i in range(
            len(exprs))], db, ctx.conf).columns

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        right_src, peeled = peel_filters(self.right)
        build_conds = self.build_conds + peeled
        left_src, peeled = peel_filters(self.left)
        probe_conds = self.probe_conds + peeled
        right_batches = [db for db in right_src.execute(ctx)
                         if not (isinstance(db.num_rows, int) and
                                 db.num_rows == 0)]
        if not right_batches:
            return      # an empty build side: an inner join emits nothing
        if sum(b.capacity for b in right_batches) > \
                2 * ctx.conf.batch_size_rows and \
                sum(int(b.num_rows) for b in right_batches) > \
                2 * ctx.conf.batch_size_rows:
            raise NotImplementedError(
                "a build side over 2 x sql.batchSizeRows rows is "
                "sub-partitioned in the reference; that ports with the "
                "out-of-core slice (ROADMAP Queue 1 item 6)")
        build_batch = concat_batches(right_batches, ctx.conf)
        yield from self._join_stream(build_batch, left_src.execute(ctx),
                                     ctx, build_conds, probe_conds)

    def _join_stream(self, build_batch: DeviceBatch, probe_iter,
                     ctx: ExecContext, build_conds=(), probe_conds=()
                     ) -> Iterator[DeviceBatch]:
        from ..ops.hopper import elect_join
        if key_ref_names(self.left_keys) is None or \
                not side_unique(self.right_keys, self.right):
            raise NotImplementedError(
                "joins whose build keys are not unique plain columns "
                f"(probe_counts/expand_pairs) port with {NEXT_JOIN_SLICE}")
        tier = elect_join(ctx.conf, build_batch.capacity)
        if tier is None:
            raise NotImplementedError(
                "a join outside the hash-table tier (kernel tier off, or a "
                "build over sql.kernels.pallas.join.maxBuildRows) runs the "
                "reference's dense or sorted join tier, which ports with "
                f"{NEXT_JOIN_SLICE}")
        build_keys = self._key_cols(build_batch, self.right_keys, ctx)
        # fused build-side filters: failing rows never match
        build_pre = conds_mask(build_conds, build_batch,
                               build_batch.row_mask(), ctx.conf)
        build = J.BuildTable(build_batch, build_keys,
                             extra_valid=build_pre if build_conds else None,
                             hash_tier=tier)
        out_names = list(self.output_schema.names)
        for pb in probe_iter:
            if isinstance(pb.num_rows, int) and pb.num_rows == 0:
                continue
            probe_keys = self._key_cols(pb, self.left_keys, ctx)
            # fused probe-side filters: failing rows are dead
            pre = conds_mask(probe_conds, pb, pb.row_mask(), ctx.conf)
            probe_valid = pre
            for c in probe_keys:
                probe_valid = probe_valid & c.validity
            build_idx, ok = J.probe_aligned(
                build, J.key_cols_lanes(probe_keys), probe_valid)
            # unmatched rows gather -1: their right columns come out null
            build_lane = torch.where(ok, build_idx,
                                     torch.full_like(build_idx, -1))
            right_cols = gather_batch(build_batch, build_lane, pb.num_rows,
                                      null_out_of_bounds=True).columns
            pairs = DeviceBatch(list(pb.columns) + right_cols, pb.num_rows,
                                out_names)
            yield compact_batch(pairs, ok & pre, ctx.conf)

