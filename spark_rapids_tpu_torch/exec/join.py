"""Join exec nodes over the hash-table join kernels and the sorted tier
(ops/join.py).

Counterpart of spark_rapids_tpu/exec/join.py (GpuShuffledHashJoinExec,
GpuHashJoin's gather machinery).  Output schema is left columns ++ right
columns (Spark layout; left columns only for semi and anti joins); the
RIGHT side is the build side, fully materialized by concatenation, and
probe batches stream through.

Every equi-join type of the hash-table tier runs: inner, left/right/full
outer, left semi and left anti, over unique or non-unique build keys, on
one key column (a string key's probe codes remap into the build's
dictionary, `remap_codes_into`; a string absent there matches nothing)
or on a composite key whose exact column ranges pack it into one
injective lane (`range_pack_spec`).  Per probe batch:

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

`CrossJoinExec` pairs every probe row with every build row: a build
of one row by construction (a scalar subquery) is broadcast onto each
probe batch with no host sync, any other build is gathered pairwise.

A build over twice `sql.batchSizeRows` rows, or over the out-of-core
resident window in bytes (exec/ooc.py), runs the sub-partition join:
both sides hash-scatter into spillable buckets
(`exec/plan._agg_partition_ids`, bit-equal to the reference's, so the
buckets and their order are the reference's) and each bucket pair joins
through the same kernels.

With the join family off, a build over
`sql.kernels.pallas.join.maxBuildRows`, or a shed at the `kernel` chaos
site (ops/hopper elect_join), the same single lane runs the sorted tier
(ops/join.py), with the same rows in the same order.

What stays unported raises NotImplementedError naming its ROADMAP item:
composite keys that do not pack into one lane, strings among them (the
reference's multi-lane sorted tier, Queue 1 item 1(d)).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, bucket_capacity,
                               storage_dtype)
from ..config import HASH_SUBPARTITION_FALLBACK
from ..ops import join as J
from ..ops.batch_ops import (concat_batches, ensure_unique_dict,
                             remap_codes_into, shrink_to_rows)
from ..ops.filter import compact_batch, gather_batch
from ..plan import expressions as E
from . import ooc as O
from .evaluator import conds_mask, evaluate_projection
from .plan import ExecContext, PlanNode, key_ref_names, peel_filters

#: where the multi-lane sorted tier (composite keys that do not pack)
#: ports
NEXT_JOIN_SLICE = "ROADMAP Queue 1 item 1(d)"
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
    if join_type not in JOIN_TYPES:
        reasons.append(f"unsupported join type {join_type}")
    strings = [isinstance(e.dtype, t.StringType)
               for e in list(left_keys) + list(right_keys)]
    if any(strings) and (len(left_keys) > 1 or not all(strings)):
        reasons.append("composite string join keys take the reference's "
                       f"multi-lane sorted tier, which ports with "
                       f"{NEXT_JOIN_SLICE}")
    elif len(left_keys) > 1 and \
            range_pack_spec(left_keys, right_keys, left, right) is None:
        reasons.append("composite keys that do not pack into one lane "
                       "(plain integer columns with exact ranges) take the "
                       f"reference's multi-lane sorted tier, which ports "
                       f"with {NEXT_JOIN_SLICE}")
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
        gate = 2 * ctx.conf.batch_size_rows
        if ctx.conf.get(HASH_SUBPARTITION_FALLBACK):
            # an oversized build re-hash-partitions BOTH sides into
            # independent sub-joins (GpuSubPartitionHashJoin): equal keys
            # land in the same bucket on both sides.  The gate sizes by
            # rows (two target batches) and by bytes against the
            # out-of-core resident window, and a forced context trips it;
            # capacities bound both from above with no host sync
            policy = O.ooc_policy(ctx)
            padded = sum(b.nbytes() for b in right_batches)
            if sum(b.capacity for b in right_batches) > gate or \
                    policy.bytes_trip(padded) or policy.force:
                build_rows = sum(int(b.num_rows) for b in right_batches)
                build_bytes = sum(O.batch_bytes(b) for b in right_batches)
                if build_rows > gate or policy.bytes_trip(build_bytes) or \
                        policy.force:
                    yield from self._sub_partition_join(
                        right_batches, left_src, build_conds, probe_conds,
                        ctx, policy)
                    return
                right_batches = [b for b in right_batches
                                 if int(b.num_rows)]
                if not right_batches:
                    yield from self._empty_build_output(
                        left_src, probe_conds, ctx)
                    return
        build_batch = concat_batches(right_batches, ctx.conf)
        if build_batch.capacity > gate:
            # one compacted batch keeps its input's capacity (q18's
            # 15,000,000 order groups under its HAVING at SF10): re-bucket
            # it to its rows, as concat_batches packs several
            build_batch = shrink_to_rows(build_batch,
                                         int(build_batch.num_rows), ctx.conf)
        yield from self._join_stream(build_batch, left_src.execute(ctx),
                                     ctx, build_conds, probe_conds)

    def _scatter(self, db: DeviceBatch, exprs, conds, buckets,
                 salt: int, ctx: ExecContext) -> int:
        """Scatter one batch by its join keys (exec/ooc.scatter); the
        fused filters apply here, so the bucket joins run with none."""
        return O.scatter(db, self._key_cols(db, exprs, ctx),
                         conds_mask(conds, db, db.row_mask(), ctx.conf),
                         buckets, salt, ctx)

    def _sub_partition_join(self, right_batches, left_src, build_conds,
                            probe_conds, ctx: ExecContext,
                            policy: "O.OocPolicy"
                            ) -> Iterator[DeviceBatch]:
        """The partitioned-spill join (the out-of-core tier): both sides
        hash-scatter into budget-registered spillable buckets, k from the
        build's rows and its bytes against the resident window
        (exec/ooc.py); a bucket whose build still exceeds the window
        re-partitions with a re-salted hash, at most `sql.ooc.maxDepth`
        deep.  Each bucket pair runs `_join_stream`, the resident join's
        kernels, and buckets come out in bucket order."""
        conf = ctx.conf
        build_rows = sum(int(b.num_rows) for b in right_batches)
        build_bytes = sum(O.batch_bytes(b) for b in right_batches)
        # the row-derived fan-out floors the byte-derived one, so a
        # context with no budget keeps the reference's row sizing
        rows_k = min(1 << max(1, (build_rows // conf.batch_size_rows)
                              .bit_length() - 1), 32)
        k = O.partition_count(build_bytes, policy, rows_k=rows_k)
        ctx.bump("join_subpartition_fallbacks")
        O.record_election(
            ctx, "join",
            "bytes" if policy.bytes_trip(build_bytes) else
            ("forced" if policy.force and
             build_rows <= 2 * conf.batch_size_rows else "rows"))

        def process(bl, pl, depth):
            """Join one (build, probe) bucket pair, re-partitioning it
            while its build exceeds the window."""
            bucket_bytes = sum(sp.live_nbytes for sp in bl)
            if bl and policy.bytes_trip(bucket_bytes) and \
                    depth < policy.max_depth and \
                    sum(sp.num_rows for sp in bl) > 1:
                # a skewed bucket: re-salted recursive re-partition
                O.record_recursion(ctx, "join")
                k2 = O.partition_count(bucket_bytes, policy)
                sub_b = [[] for _ in range(k2)]
                sub_p = [[] for _ in range(k2)]
                try:
                    added = 0
                    for sl, subs, exprs in ((bl, sub_b, self.right_keys),
                                            (pl, sub_p, self.left_keys)):
                        for sp in sl:
                            b = sp.get()
                            sp.close()
                            added += self._scatter(b, exprs, (), subs,
                                                   depth + 1, ctx)
                    O.record_partitions(ctx, "join", k2, added)
                    for p in range(k2):
                        if sub_b[p] or sub_p[p]:
                            O.fire(ctx, "join", bucket=p, k=k2,
                                   depth=depth + 1)
                            yield from process(sub_b[p], sub_p[p],
                                               depth + 1)
                finally:
                    for part in sub_b + sub_p:
                        for sp in part:
                            sp.close()
                return

            def probes():
                for sp in pl:
                    b = sp.get()
                    sp.close()
                    yield b
            if not bl:
                # an empty build bucket: the empty-build rule decides
                if self.join_type in (J.INNER, J.LEFT_SEMI, J.RIGHT_OUTER):
                    for sp in pl:     # nothing to emit: no re-upload
                        sp.close()
                    return
                yield from self._empty_build_stream(probes(), (), ctx)
                return
            bbs = [sp.get() for sp in bl]
            build_batch = concat_batches(bbs, conf)
            for sp in bl:
                sp.close()
            yield from self._join_stream(build_batch, probes(), ctx)

        build_parts = [[] for _ in range(k)]
        probe_parts = [[] for _ in range(k)]
        try:
            added = 0
            for db in right_batches:
                added += self._scatter(db, self.right_keys, build_conds,
                                       build_parts, 0, ctx)
            right_batches.clear()          # the buckets hold the rows now
            for db in left_src.execute(ctx):
                if int(db.num_rows) == 0:
                    continue
                added += self._scatter(db, self.left_keys, probe_conds,
                                       probe_parts, 0, ctx)
            O.record_partitions(ctx, "join", k, added)
            for p in range(k):
                bl, pl = build_parts[p], probe_parts[p]
                if bl or pl:
                    O.fire(ctx, "join", bucket=p, k=k, depth=0)
                    yield from process(bl, pl, 0)
        finally:
            # an abandoned generator (a LIMIT above) or a failure must not
            # leak registered spillables or block files; close is
            # idempotent, so handles the loop consumed release nothing
            # twice
            for part in build_parts + probe_parts:
                for sp in part:
                    sp.close()

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
        # None: the sorted tier (ops/join.py) takes the join
        tier = elect_join(ctx.conf, build_batch.capacity)
        jt = self.join_type
        build_keys = [ensure_unique_dict(c) for c in self._key_cols(
            build_batch, self.right_keys, ctx)]
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
            # a string key's codes move into the build's dictionary
            probe_keys = [remap_codes_into(c, b.dictionary)
                          if b.dictionary is not None else c
                          for c, b in zip(self._key_cols(
                              pb, self.left_keys, ctx), build_keys)]
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
        """An empty build side at the top: inner, semi and right outer
        joins do not even run the probe side."""
        if self.join_type in (J.INNER, J.LEFT_SEMI, J.RIGHT_OUTER):
            return
        yield from self._empty_build_stream(left_src.execute(ctx),
                                            probe_conds, ctx)

    def _empty_build_stream(self, probe_iter, probe_conds,
                            ctx: ExecContext) -> Iterator[DeviceBatch]:
        """Probe batches against an empty build, for the join types that
        emit rows there: left/full outer and anti joins pass the
        filter-surviving probe rows through, outer joins with null right
        columns."""
        out_names = list(self.output_schema.names)
        for pb in probe_iter:
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


class CrossJoinExec(PlanNode):
    """Every (left, right) pair, left columns then right
    (GpuCartesianProductExec's role).  A right side of exactly one row
    by construction (`static_row_count() == 1`: a scalar subquery, the
    HAVING-against-a-total shape) broadcasts its row onto every left
    batch with no host sync.  Any other right side materializes into
    one batch of nb rows, and a left batch of n rows gathers left row
    i // nb and right row i % nb for the first n * nb slots of a bucket
    of that size."""

    def __init__(self, left: PlanNode, right: PlanNode):
        super().__init__(left, right)

    @property
    def output_schema(self) -> t.StructType:
        return t.StructType(list(self.children[0].output_schema.fields) +
                            list(self.children[1].output_schema.fields))

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        left, right = self.children
        out_names = list(self.output_schema.names)
        if right.static_row_count() == 1:
            build = list(right.execute(ctx))[0]
            for pb in left.execute(ctx):
                zeros = torch.zeros(pb.capacity, dtype=torch.int64,
                                    device=pb.device)
                rg = gather_batch(build, zeros, pb.num_rows)
                yield DeviceBatch(list(pb.columns) + rg.columns,
                                  pb.num_rows, out_names)
            return
        right_batches = [db for db in right.execute(ctx)
                         if int(db.num_rows) > 0]
        if not right_batches:
            return
        build = concat_batches(right_batches, ctx.conf)
        nb = int(build.num_rows)
        for pb in left.execute(ctx):
            npr = int(pb.num_rows)
            if npr == 0:
                continue
            total = npr * nb
            i = torch.arange(bucket_capacity(total, ctx.conf),
                             dtype=torch.int64, device=pb.device)
            lg = gather_batch(pb, i // nb, total)
            rg = gather_batch(build, i % nb, total)
            yield DeviceBatch(lg.columns + rg.columns, total, out_names)
