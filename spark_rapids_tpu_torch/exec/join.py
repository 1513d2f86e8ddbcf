"""Join exec nodes over the hash-table join kernels (ops/join.py).

Counterpart of spark_rapids_tpu/exec/join.py (GpuShuffledHashJoinExec,
GpuHashJoin's gather machinery).  Output schema is left columns ++ right
columns (Spark layout; left columns only for semi and anti joins); the
RIGHT side is the build side, fully materialized by concatenation, and
probe batches stream through.

Every equi-join type of the hash-table tier runs: inner, left/right/full
outer, left semi and left anti, over unique or non-unique build keys, on
one key column or on a composite key whose exact column ranges pack it
into one injective lane (`range_pack_spec`).  Per probe batch:

  * semi/anti: the matched flag (`probe_matched_lazy`, no host sync),
    then one compaction of the kept probe rows;
  * a build whose plain key columns are unique: the probe-aligned path
    (`probe_aligned`, a gather of the build columns at the found rows,
    null where none, one compaction); right/full outer joins mark the
    matched build rows with a scatter-max;
  * any other build: `probe_counts` (one host sync for the pair total),
    `expand_pairs` into a bucket of that size, the two gathers and one
    compaction; right/full outer joins OR in `build_matched_flags`;
  * left/full outer joins then emit the unmatched probe rows with null
    right columns, and right/full outer joins emit the unmatched build
    rows with null left columns after the last probe batch.

Filters right below either input are peeled into masks (build: the
key-valid mask; probe: the liveness), never compacted first.  An empty
build side still gives outer and anti joins their rows.

Late materialization, `join.lazySelection` and thin batches resolve off
in the port (README "Conf"), so every join output is compacted where the
JAX package may yield a masked or thin batch; the rows and their order
are the same.  The reference's dense presence bitmap for semi/anti joins
over a dense key domain is its dense tier, not ported: the hash table
takes those joins, with the same rows.

What stays unported raises NotImplementedError naming its slice: cross
joins (CrossJoinExec), string keys, composite keys that do not pack (the
sorted tier), a join with the kernel tier off or a build over
`sql.kernels.pallas.join.maxBuildRows` (the dense and sorted tiers), and
builds over twice `sql.batchSizeRows` (the reference sub-partitions
those).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, bucket_capacity,
                               storage_dtype)
from ..ops import join as J
from ..ops.batch_ops import concat_batches
from ..ops.filter import compact_batch, gather_batch
from ..plan import expressions as E
from .evaluator import conds_mask, evaluate_projection
from .plan import ExecContext, PlanNode, key_ref_names, peel_filters

NEXT_JOIN_SLICE = "the next join slice (ROADMAP Queue 1)"
JOIN_TYPES = (J.INNER, J.LEFT_OUTER, J.RIGHT_OUTER, J.FULL_OUTER,
              J.LEFT_SEMI, J.LEFT_ANTI)


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


def range_pack_spec(left_keys, right_keys, left: PlanNode, right: PlanNode):
    """([(lo, stride)] per key column, total span) when a composite key of
    plain columns folds into ONE injective int64 lane from exact column
    ranges over BOTH sides, else None.  Packed values lie in [0, total)."""
    ln = key_ref_names(left_keys)
    rn = key_ref_names(right_keys)
    if ln is None or rn is None or len(ln) < 2:
        return None
    spans = []
    for lname, rname in zip(ln, rn):
        lr = left.column_range(lname)
        rr = right.column_range(rname)
        if lr is None or rr is None:
            return None
        lo = min(lr[0], rr[0])
        spans.append((lo, max(lr[1], rr[1]) - lo + 1))
    total = 1
    for _lo, span in spans:
        total *= span
        if total >= (1 << 62):
            return None
    spec = []
    stride = 1
    for lo, span in reversed(spans):
        spec.append((lo, stride))
        stride *= span
    spec.reverse()
    return spec, total


def packed_lane(key_cols: Sequence[DeviceColumn], spec) -> torch.Tensor:
    """Fold per-column int64 lanes into the packed lane of `spec`."""
    packed = None
    for c, (lo, stride) in zip(key_cols, spec):
        part = (c.data.to(torch.int64) - lo) * stride
        packed = part if packed is None else packed + part
    return packed


def unported_join_reasons(join_type: str, left_keys, right_keys,
                          left: PlanNode, right: PlanNode) -> List[str]:
    """Why the port cannot run a join (bound keys over the physical
    inputs), [] if it can."""
    reasons = []
    if join_type == J.CROSS:
        reasons.append(f"cross joins (CrossJoinExec) port with "
                       f"{NEXT_JOIN_SLICE}")
    elif join_type not in JOIN_TYPES:
        reasons.append(f"unsupported join type {join_type}")
    if any(isinstance(e.dtype, t.StringType)
           for e in list(left_keys) + list(right_keys)):
        reasons.append("string join keys (dictionary unification across "
                       f"sides) port with {NEXT_JOIN_SLICE}")
    elif len(left_keys) > 1 and \
            range_pack_spec(left_keys, right_keys, left, right) is None:
        reasons.append("composite keys that do not pack into one lane "
                       "(plain integer columns with exact ranges) take the "
                       f"reference's sorted tier, which ports with "
                       f"{NEXT_JOIN_SLICE}")
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


def _null_columns(schema: t.StructType, capacity: int,
                  device: torch.device) -> List[DeviceColumn]:
    """All-null columns of `schema` (an outer join's missing side); a
    string column gets an empty dictionary, which means every row is
    null."""
    return [DeviceColumn(
        torch.zeros(capacity, dtype=storage_dtype(f.data_type),
                    device=device),
        torch.zeros(capacity, dtype=torch.bool, device=device), f.data_type,
        np.array([], str) if isinstance(f.data_type, t.StringType) else None)
        for f in schema.fields]


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
                                        self.right_keys, left, right)
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
        lf = list(self.left.output_schema.fields)
        if self.join_type in (J.LEFT_SEMI, J.LEFT_ANTI):
            return t.StructType(lf)
        return t.StructType(lf + list(self.right.output_schema.fields))

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
            yield from self._empty_build_output(left_src, probe_conds, ctx)
            return
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

    def _with_null_right(self, pb: DeviceBatch, keep: torch.Tensor,
                         ctx: ExecContext) -> DeviceBatch:
        """The probe rows of `keep` with null right columns (the outer
        joins' unmatched probe rows), compacted."""
        padded = DeviceBatch(
            list(pb.columns) + _null_columns(self.right.output_schema,
                                             pb.capacity, pb.device),
            pb.num_rows, list(self.output_schema.names))
        return compact_batch(padded, keep, ctx.conf)

    def _join_stream(self, build_batch: DeviceBatch, probe_iter,
                     ctx: ExecContext, build_conds=(), probe_conds=()
                     ) -> Iterator[DeviceBatch]:
        from ..ops.hopper import elect_join
        tier = elect_join(ctx.conf, build_batch.capacity)
        if tier is None:
            raise NotImplementedError(
                "a join outside the hash-table tier (kernel tier off, or a "
                "build over sql.kernels.pallas.join.maxBuildRows) runs the "
                "reference's dense or sorted join tier, which ports with "
                f"{NEXT_JOIN_SLICE}")
        jt = self.join_type
        build_keys = self._key_cols(build_batch, self.right_keys, ctx)
        # fused build-side filters: failing rows never match and never
        # surface as outer-unmatched
        build_pre = conds_mask(build_conds, build_batch,
                               build_batch.row_mask(), ctx.conf)
        pack = None
        if len(self.right_keys) > 1:
            pack, _total = range_pack_spec(self.left_keys, self.right_keys,
                                           self.left, self.right)
        build = J.BuildTable(
            build_batch, build_keys,
            lanes_override=None if pack is None
            else [packed_lane(build_keys, pack)],
            extra_valid=build_pre if build_conds else None, hash_tier=tier)
        # a unique build of plain key columns: every probe row matches at
        # most once, so the output rides the probe's capacity, sync-free
        # (semi and anti joins need only the matched flag, whatever the
        # build)
        aligned = jt not in (J.LEFT_SEMI, J.LEFT_ANTI) and \
            key_ref_names(self.left_keys) is not None and \
            side_unique(self.right_keys, self.right)
        outer_build = jt in (J.RIGHT_OUTER, J.FULL_OUTER)
        build_matched = torch.zeros(build_batch.capacity, dtype=torch.bool,
                                    device=build_batch.device) \
            if outer_build else None
        out_names = list(self.output_schema.names)
        for pb in probe_iter:
            if isinstance(pb.num_rows, int) and pb.num_rows == 0:
                continue
            probe_keys = self._key_cols(pb, self.left_keys, ctx)
            probe_lanes = [packed_lane(probe_keys, pack)] if pack \
                else J.key_cols_lanes(probe_keys)
            # fused probe-side filters: failing rows are dead for every
            # join type (no match, and no outer-unmatched row either)
            pre = conds_mask(probe_conds, pb, pb.row_mask(), ctx.conf)
            probe_valid = pre
            for c in probe_keys:
                probe_valid = probe_valid & c.validity

            if jt in (J.LEFT_SEMI, J.LEFT_ANTI):
                matched = J.probe_matched_lazy(build, probe_lanes,
                                               probe_valid)
                # anti keeps null-key rows: they match nothing
                keep = matched if jt == J.LEFT_SEMI else pre & ~matched
                out = compact_batch(pb, keep, ctx.conf)
                yield DeviceBatch(out.columns, out.num_rows, out_names)
                continue

            if aligned:
                build_idx, ok = J.probe_aligned(build, probe_lanes,
                                                probe_valid)
                # unmatched rows gather -1: their right columns come out
                # null
                build_lane = torch.where(ok, build_idx,
                                         torch.full_like(build_idx, -1))
                right_cols = gather_batch(build_batch, build_lane,
                                          pb.num_rows,
                                          null_out_of_bounds=True).columns
                if outer_build:
                    hit = torch.zeros(build_batch.capacity,
                                      dtype=torch.int32, device=pb.device)
                    hit.scatter_reduce_(0, build_idx.long(),
                                        ok.to(torch.int32), "amax")
                    build_matched |= hit > 0
                out = DeviceBatch(list(pb.columns) + right_cols,
                                  pb.num_rows, out_names)
                if jt == J.LEFT_OUTER:
                    # every filter-surviving probe row survives
                    yield compact_batch(out, pre, ctx.conf) \
                        if probe_conds else out
                    continue
                yield compact_batch(out, ok & pre, ctx.conf)
                if jt == J.FULL_OUTER:
                    yield self._with_null_right(pb, pre & ~ok, ctx)
                continue

            first, counts, cum, total = J.probe_counts(build, probe_lanes,
                                                       probe_valid)
            unmatched = pre
            if total > 0:
                out_cap = bucket_capacity(total, ctx.conf)
                probe_idx, build_idx, ok, probe_matched = J.expand_pairs(
                    build, probe_lanes, probe_valid, first, counts, cum,
                    out_cap, total)
                if outer_build:
                    build_matched |= J.build_matched(build, first, counts)
                unmatched = pre & ~probe_matched
                lg = gather_batch(pb, probe_idx, total)
                rg = gather_batch(build_batch, build_idx, total)
                pairs = DeviceBatch(lg.columns + rg.columns, total,
                                    out_names)
                yield compact_batch(pairs, ok, ctx.conf)
            if jt in (J.LEFT_OUTER, J.FULL_OUTER):
                yield self._with_null_right(pb, unmatched, ctx)

        if outer_build:
            padded = DeviceBatch(
                _null_columns(self.left.output_schema, build_batch.capacity,
                              build_batch.device) +
                list(build_batch.columns), build_batch.num_rows, out_names)
            yield compact_batch(padded, build_pre & ~build_matched,
                                ctx.conf)

    def _empty_build_output(self, left_src, probe_conds,
                            ctx: ExecContext) -> Iterator[DeviceBatch]:
        """An empty build side: inner, semi and right outer joins emit
        nothing (the probe side is not even run); left/full outer and
        anti joins pass the filter-surviving probe rows through, outer
        joins with null right columns."""
        if self.join_type in (J.INNER, J.LEFT_SEMI, J.RIGHT_OUTER):
            return
        out_names = list(self.output_schema.names)
        for pb in left_src.execute(ctx):
            if int(pb.num_rows) == 0:
                continue
            if probe_conds:
                pb = compact_batch(pb, conds_mask(
                    probe_conds, pb, pb.row_mask(), ctx.conf), ctx.conf)
            cols = list(pb.columns)
            if self.join_type != J.LEFT_ANTI:
                cols += _null_columns(self.right.output_schema, pb.capacity,
                                      pb.device)
            yield DeviceBatch(cols, pb.num_rows, out_names)
