"""Join exec nodes over the join tiers of ops/join.py.

Counterpart of spark_rapids_tpu/exec/join.py (GpuShuffledHashJoinExec,
GpuHashJoin's gather machinery).  Output schema is left columns ++ right
columns (Spark layout; left columns only for semi and anti joins); the
RIGHT side is the build side, fully materialized by concatenation, and
probe batches stream through.

Every equi-join type runs: inner, left/right/full outer, left semi and
left anti, over unique or non-unique build keys, on any key columns (a
string key's probe codes remap into the build's dictionary,
`remap_codes_into`; a string absent there matches nothing).  The tier
is chosen once per build side, as the reference's `_join_stream` does:

  1. a composite key of plain columns whose exact ranges pack folds
     into one injective lane (`range_pack_spec`);
  2. a single lane over a bounded domain (the packed span, a string
     dictionary's size or a column's exact range, `dense_domain`) can
     take the dense direct-address tier;
  3. the hash-table kernels are elected (ops/hopper elect_join): under
     `denseReplace` ON, the port's default, they take every join they
     can table; AUTO keeps a dense domain on the dense tier up to 4x the
     build capacity, OFF always; a semi or anti join over a dense domain
     then reads the presence bitmap (`join.matchedViaPresence`) without
     an election;
  4. otherwise `BuildTable` runs the sorted tier: the single lane, or
     several lanes' composite hash with every pair verified.

Per probe batch:

  * semi/anti: the matched flag (`probe_matched_lazy`, no host sync;
    several lanes count and expand their candidates and keep the
    verified flags), then one compaction of the kept probe rows;
  * a single-lane build whose plain key columns are unique: the
    probe-aligned path (`probe_aligned`, a gather of the build columns
    at the found rows, null where none, one compaction); right/full
    outer joins mark the matched build rows;
  * any other build: `probe_counts` (one host sync for the pair total),
    `expand_pairs` into a bucket of that size, the two gathers and one
    compaction; right/full outer joins OR in `build_matched`;
  * left/full outer joins then emit the unmatched probe rows with null
    right columns, and right/full outer joins emit the unmatched build
    rows with null left columns after the last probe batch.

Filters right below either input are peeled into masks (build: the
key-valid mask; probe: the liveness), never compacted first.  An empty
build side still gives outer and anti joins their rows.  The query's
metrics count `join_pallas_hash`, `join_dense_domain` and the kernel
fallbacks (`kernel_fallback.hash_probe_join.<reason>`).

Under `sql.join.lazySelection` (plan/overrides `negotiate_lazy_sel`) a
join whose parent reads liveness as a mask (an aggregation, another
join's probe side) emits its kept rows as a selection vector
(`DeviceBatch.sel`) instead of compacting them.  Under
`sql.join.lateMaterialization.enabled` (`negotiate_thin`) a join whose
consumers up to a pipeline sink all take thin batches emits its right
columns as a build row-id lane (columnar/lanes.py) and passes a thin
probe's lanes through, composed through the pair expansion; a masked
probe gathers at its full capacity.  The sub-partition join's bucket
build batches that thin output points into stay reserved in the query's
budget until the sink drops them (`MemoryBudget.hold`).

`CrossJoinExec` pairs every probe row with every build row: a build
of one row by construction (a scalar subquery) is broadcast onto each
probe batch with no host sync, any other build is gathered pairwise.

A build over twice `sql.batchSizeRows` rows, or over the out-of-core
resident window in bytes (exec/ooc.py), runs the sub-partition join:
both sides hash-scatter into spillable buckets
(`exec/plan._agg_partition_ids` over every key column, bit-equal to the
reference's, so the buckets and their order are the reference's) and
each bucket pair joins through the same tiers.
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
from ..ops.batch_ops import (concat_batches, ensure_prefix,
                             ensure_unique_dict, remap_codes_into,
                             shrink_to_rows)
from ..ops.filter import compact_batch, gather_batch
from ..plan import expressions as E
from ..runtime.capture import capturing
from . import ooc as O
from .evaluator import conds_mask, evaluate_projection
from .plan import ExecContext, PlanNode, key_ref_names, peel_filters

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


def unported_join_reasons(join_type: str) -> List[str]:
    """Why the port cannot run a join, [] if it can: every key set runs,
    so only the join type can refuse."""
    if join_type not in JOIN_TYPES:
        return [f"unsupported join type {join_type}"]
    return []


def span_fits(span: int, build_capacity: int) -> bool:
    """The direct-address tables' sizing policy (the reference's): a
    span of at most 16x the build capacity or 2^20 keys, and never past
    2^26 keys (offsets of 256 MiB)."""
    return span <= max(16 * build_capacity, 1 << 20) and span <= (1 << 26)


def dense_domain(left_keys, right_keys, right: PlanNode,
                 build_keys: Sequence[DeviceColumn], build_capacity: int):
    """(lo, hi) covering every valid build key of a single-key join
    whose span fits a direct-address table: a string key's dictionary
    size (codes are dense), an integer key's exact range.  None
    otherwise."""
    if len(right_keys) != 1:
        return None
    c = build_keys[0]
    if isinstance(c.dtype, t.StringType):
        if c.dictionary is None:
            return None
        lo, hi = 0, max(len(c.dictionary), 1) - 1
    else:
        rn = key_ref_names(right_keys)
        if rn is None or key_ref_names(left_keys) is None:
            return None
        rng = right.column_range(rn[0])
        if rng is None:
            return None
        lo, hi = int(rng[0]), int(rng[1])
    return (lo, hi) if span_fits(hi - lo + 1, build_capacity) else None


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
        reasons = unported_join_reasons(join_type)
        if reasons:
            raise NotImplementedError("; ".join(reasons))
        # pre-fused filter predicates, evaluated as masks on raw batches
        self.probe_conds = list(probe_conds or [])
        self.build_conds = list(build_conds or [])
        # a mask-aware parent (plan/overrides negotiate_lazy_sel): emit a
        # selection vector instead of compacting the output
        self.lazy_sel = False
        # the output names that may ride as row-id lanes to the pipeline
        # sink (plan/overrides negotiate_thin); None = dense output
        self.thin_payload = None

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
        # a capture builds one table over the whole build side: the
        # sub-partition tier sizes itself by host row counts, and a
        # graph's memory is its own (a capture that runs out of memory
        # runs eager, where this tier is)
        if ctx.conf.get(HASH_SUBPARTITION_FALLBACK) and not capturing():
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
        if build_batch.capacity > gate and not capturing():
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
        fused filters apply here, so the bucket joins run with none.  A
        thin batch materializes its key and condition columns first; the
        other deferred columns resolve inside the bucket compactions
        (lanes.compact_thin, one composed gather)."""
        if db.thin is not None:
            from ..columnar.lanes import materialize_refs
            db = materialize_refs(db, list(exprs) + list(conds), ctx.conf)
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
            if self._defer_right():
                # thin output points into the bucket's build batch past
                # its spillables' release: the budget keeps its bytes
                # until the sink drops the last lane
                ctx.budget.hold(build_batch)
            del bbs
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

    # -- late materialization --------------------------------------------

    def _thin_transparent(self) -> bool:
        """Whether this join carries a thin probe stream through (passes
        its lanes along or composes them) instead of materializing it."""
        return self.thin_payload is not None and self.join_type in (
            J.INNER, J.LEFT_OUTER, J.LEFT_SEMI, J.LEFT_ANTI)

    def _defer_right(self) -> List[int]:
        """Right column indices deferred behind a build row-id lane:
        inner and left outer joins only (their null extension is the -1
        lane; right and full outer joins emit a dense build tail)."""
        if self.thin_payload is None or \
                self.join_type not in (J.INNER, J.LEFT_OUTER):
            return []
        return [j for j, f in enumerate(self.right.output_schema.fields)
                if f.name in self.thin_payload]

    def _prep_probe(self, pb: DeviceBatch, probe_conds,
                    ctx: ExecContext) -> DeviceBatch:
        """A thin probe batch materializes whole unless this join is
        thin-transparent; a transparent join still materializes the
        deferred columns its keys and conditions read, and any pending
        column the parent pipeline did not allow."""
        if pb.thin is None:
            return pb
        from ..columnar.lanes import materialize_batch, materialize_refs
        if not self._thin_transparent():
            return materialize_batch(pb, ctx.conf)
        pb = materialize_refs(pb, list(self.left_keys) + list(probe_conds),
                              ctx.conf)
        if pb.thin is not None:
            bad = [p for p in pb.thin.pending
                   if pb.names[p] not in self.thin_payload]
            if bad:
                ctx.bump("join_thin_early_materialized", len(bad))
                pb = materialize_batch(pb, ctx.conf, bad)
        return pb

    @staticmethod
    def _make_thin(out_capacity: int, probe_thin, build_batch, build_lane,
                   defer_right, nleft: int, probe_sources=None):
        """The ThinState of a join output: the probe side's lane sources
        ride through (as they are, or composed through the pair
        expansion), the build side adds one source addressed by
        `build_lane`.  None when nothing is pending."""
        from ..columnar.lanes import LaneSource, ThinState
        sources = list(probe_sources if probe_sources is not None
                       else (probe_thin.sources if probe_thin else []))
        pending = dict(probe_thin.pending) if probe_thin else {}
        if defer_right:
            ord_b = len(sources)
            sources.append(LaneSource(build_batch, build_lane))
            for j in defer_right:
                pending[nleft + j] = (ord_b, j)
        if not pending:
            return None
        return ThinState(out_capacity, sources, pending)

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
        from ..config import (JOIN_DENSE_BUILD_VIA_SORT,
                              JOIN_MATCHED_VIA_MERGE,
                              JOIN_MATCHED_VIA_PRESENCE)
        from ..ops.hopper import count_fallback, elect_join, kernel_tier
        jt = self.join_type
        conf = ctx.conf
        build_keys = [ensure_unique_dict(c) for c in self._key_cols(
            build_batch, self.right_keys, ctx)]
        # fused build-side filters: failing rows never match and never
        # surface as outer-unmatched
        build_pre = conds_mask(build_conds, build_batch,
                               build_batch.row_mask(), conf)
        cap = build_batch.capacity
        # the tier, as the reference chooses it: a composite key of plain
        # columns with exact ranges packs into one lane (its span a
        # ready-made domain), a single key may have a dense domain, then
        # the kernel election, then BuildTable
        pack = None
        if len(self.right_keys) > 1:
            spec = range_pack_spec(self.left_keys, self.right_keys,
                                   self.left, self.right)
            if spec is not None:
                pack, span = spec
                domain = (0, span - 1) if span_fits(span, cap) else None
        if pack is None:
            domain = dense_domain(self.left_keys, self.right_keys,
                                  self.right, build_keys, cap)
        dense_span = None if domain is None else domain[1] - domain[0] + 1
        via_presence = conf.get(JOIN_MATCHED_VIA_PRESENCE)
        tier_conf = kernel_tier(conf)
        if jt in (J.LEFT_SEMI, J.LEFT_ANTI) and domain is not None and \
                via_presence and tier_conf.join_dense_replace != "ON":
            # a semi or anti join over a dense domain reads the presence
            # bitmap, which beats both tables whatever the span
            tier = None
            if tier_conf.join:
                count_fallback("hash_probe_join", "dense_matched")
        else:
            tier = elect_join(conf, cap, dense_span=dense_span)
        if tier is not None:
            domain = None               # the hash table takes the join
            ctx.bump("join_pallas_hash")
        if domain is not None:
            ctx.bump("join_dense_domain")
        # uniqueness serves the single-lane paths only (a slot table, the
        # probe-aligned output); several lanes never read it
        build_unique = (pack is not None or len(self.right_keys) == 1) \
            and side_unique(self.right_keys, self.right)
        build = J.BuildTable(
            build_batch, build_keys,
            lanes_override=None if pack is None
            else [packed_lane(build_keys, pack)],
            extra_valid=build_pre if build_conds else None, hash_tier=tier,
            domain=domain, unique=domain is not None and build_unique,
            dense_via_sort=conf.get(JOIN_DENSE_BUILD_VIA_SORT),
            matched_via_merge=conf.get(JOIN_MATCHED_VIA_MERGE),
            matched_via_presence=via_presence)
        # a unique single-lane build of plain key columns: every probe
        # row matches at most once, so the output rides the probe's
        # capacity, sync-free (semi and anti joins need only the matched
        # flag, whatever the build)
        aligned = jt not in (J.LEFT_SEMI, J.LEFT_ANTI) and build.exact and \
            key_ref_names(self.left_keys) is not None and build_unique
        outer_build = jt in (J.RIGHT_OUTER, J.FULL_OUTER)
        build_matched = torch.zeros(build_batch.capacity, dtype=torch.bool,
                                    device=build_batch.device) \
            if outer_build else None
        out_names = list(self.output_schema.names)
        # late materialization: the deferred right columns ride a build
        # row-id lane, gathered once at the sink; a thin probe stream
        # passes its lanes through
        transparent = self._thin_transparent()
        defer_right = self._defer_right()
        defer_set = frozenset(defer_right)
        nleft = len(self.left.output_schema.fields)
        nright = len(self.right.output_schema.fields)
        mat_right = [j for j in range(nright) if j not in defer_set]
        if defer_right:
            from ..columnar.lanes import deferred_column
            placeholders = {j: deferred_column(build_batch.columns[j])
                            for j in defer_right}

        def right_cols(lane, rows) -> List[DeviceColumn]:
            """The right columns at `lane` (-1: null): the materialized
            ones gathered, the deferred ones as placeholders."""
            if not defer_right:
                return gather_batch(build_batch, lane, rows,
                                    null_out_of_bounds=True).columns
            ctx.bump("join_deferred_gathers", len(defer_right))
            got = iter(gather_batch(build_batch.select(mat_right), lane,
                                    rows, null_out_of_bounds=True).columns
                       if mat_right else [])
            return [placeholders[j] if j in defer_set else next(got)
                    for j in range(nright)]

        for pb in probe_iter:
            if isinstance(pb.num_rows, int) and pb.num_rows == 0:
                continue
            pb = self._prep_probe(pb, probe_conds, ctx)
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
                if build.exact:
                    matched = J.probe_matched_lazy(build, probe_lanes,
                                                   probe_valid)
                else:
                    # several lanes: count the candidates and keep the
                    # verified flags (collisions match nothing)
                    first, counts, cum, total = J.probe_counts(
                        build, probe_lanes, probe_valid)
                    matched = torch.zeros_like(probe_valid)
                    if total > 0:
                        matched = J.expand_pairs(
                            build, probe_lanes, probe_valid, first, counts,
                            cum, bucket_capacity(total, conf), total)[3]
                # anti keeps null-key rows: they match nothing
                keep = matched if jt == J.LEFT_SEMI else pre & ~matched
                if self.lazy_sel or (transparent and pb.thin is not None):
                    # a mask-aware parent, or a thin stream whose lanes
                    # must stay aligned with its rows: no compaction
                    yield DeviceBatch(list(pb.columns),
                                      keep.sum(dtype=torch.int32),
                                      out_names, keep, pb.thin)
                    continue
                out = compact_batch(pb, keep, ctx.conf)
                yield DeviceBatch(out.columns, out.num_rows, out_names)
                continue

            if aligned:
                build_idx, ok = J.probe_aligned(build, probe_lanes,
                                                probe_valid)
                # unmatched rows gather -1: their right columns come out
                # null.  A masked probe's live rows are no prefix, so it
                # gathers at its whole capacity
                build_lane = torch.where(ok, build_idx,
                                         torch.full_like(build_idx, -1))
                out_rows = pb.capacity if pb.sel is not None \
                    else pb.num_rows
                rcols = right_cols(build_lane, out_rows)
                thin = self._make_thin(
                    pb.capacity, pb.thin, build_batch,
                    build_lane.to(torch.int32), defer_right, nleft) \
                    if (defer_right or pb.thin is not None) else None
                if outer_build:
                    build_matched |= J.matched_flags(
                        build_idx, ok, build_batch.capacity,
                        build.matched_via_merge)
                out = DeviceBatch(list(pb.columns) + rcols, pb.num_rows,
                                  out_names, None, thin)
                if jt == J.LEFT_OUTER:
                    # every filter-surviving probe row survives
                    if not probe_conds and pb.sel is None:
                        yield out
                    elif self.lazy_sel or thin is not None:
                        # a masked probe's liveness passes through
                        yield DeviceBatch(out.columns,
                                          pre.sum(dtype=torch.int32),
                                          out_names, pre, thin)
                    else:
                        yield compact_batch(out, pre, ctx.conf)
                    continue
                keep = ok & pre
                if jt == J.INNER and (self.lazy_sel or thin is not None):
                    yield DeviceBatch(out.columns,
                                      keep.sum(dtype=torch.int32),
                                      out_names, keep, thin)
                else:
                    yield compact_batch(out, keep, ctx.conf)
                if jt == J.FULL_OUTER:
                    yield self._with_null_right(pb, pre & ~ok, ctx)
                continue

            first, counts, cum, total = J.probe_counts(build, probe_lanes,
                                                       probe_valid)
            go_thin = bool(defer_right) or (transparent and
                                            pb.thin is not None)
            unmatched = pre
            if total > 0:
                out_cap = bucket_capacity(total, ctx.conf)
                probe_idx, build_idx, ok, probe_matched = J.expand_pairs(
                    build, probe_lanes, probe_valid, first, counts, cum,
                    out_cap, total)
                if outer_build:
                    build_matched |= J.build_matched(build, first, counts,
                                                     build_idx, ok)
                unmatched = pre & ~probe_matched
                if go_thin:
                    yield self._thin_pairs(pb, build_batch, probe_idx,
                                           build_idx, ok, total, out_cap,
                                           right_cols, defer_right, nleft)
                else:
                    lg = gather_batch(pb, probe_idx, total)
                    rg = gather_batch(build_batch, build_idx, total)
                    pairs = DeviceBatch(lg.columns + rg.columns, total,
                                        out_names)
                    yield compact_batch(pairs, ok, ctx.conf)
            if jt in (J.LEFT_OUTER, J.FULL_OUTER):
                if go_thin and jt == J.LEFT_OUTER:
                    # unmatched probe rows: the deferred right columns
                    # keep a -1 (null) lane, the probe's lanes pass
                    # through
                    null_lane = torch.full((pb.capacity,), -1,
                                           dtype=torch.int32,
                                           device=pb.device)
                    rcols = _null_columns(self.right.output_schema,
                                          pb.capacity, pb.device)
                    for j in defer_right:
                        rcols[j] = placeholders[j]
                    yield DeviceBatch(
                        list(pb.columns) + rcols,
                        unmatched.sum(dtype=torch.int32), out_names,
                        unmatched,
                        self._make_thin(pb.capacity, pb.thin, build_batch,
                                        null_lane, defer_right, nleft))
                else:
                    yield self._with_null_right(pb, unmatched, ctx)

        if outer_build:
            padded = DeviceBatch(
                _null_columns(self.left.output_schema, build_batch.capacity,
                              build_batch.device) +
                list(build_batch.columns), build_batch.num_rows, out_names)
            yield compact_batch(padded, build_pre & ~build_matched,
                                ctx.conf)

    def _thin_pairs(self, pb: DeviceBatch, build_batch: DeviceBatch,
                    probe_idx, build_idx, ok, total: int, out_cap: int,
                    right_cols, defer_right, nleft: int) -> DeviceBatch:
        """The expanded pairs as a thin batch: only the materialized
        columns are gathered; the probe's lanes compose through
        `probe_idx` (one int32 take a source) and the deferred right
        columns ride the new build lane.  `ok` is its selection."""
        from ..columnar.lanes import LaneSource
        pend = pb.thin.pending if pb.thin is not None else {}
        mat_l = [i for i in range(nleft) if i not in pend]
        lg = iter(gather_batch(pb.select(mat_l), probe_idx, total).columns
                  if mat_l else [])
        minus_one = torch.full((), -1, dtype=torch.int32,
                               device=probe_idx.device)
        probe_sources = []
        if pb.thin is not None:
            safe = torch.clamp(probe_idx, 0, max(pb.capacity - 1, 0)).long()
            for s in pb.thin.sources:
                probe_sources.append(LaneSource(
                    s.batch, torch.where(ok, s.lane[safe], minus_one)))
        build_lane = torch.where(ok, build_idx.to(torch.int32), minus_one)
        rcols = right_cols(build_lane, total)
        left_cols = [pb.columns[i] if i in pend else next(lg)
                     for i in range(nleft)]
        thin = self._make_thin(out_cap, pb.thin, build_batch, build_lane,
                               defer_right, nleft,
                               probe_sources=probe_sources)
        return DeviceBatch(left_cols + rcols, ok.sum(dtype=torch.int32),
                           list(self.output_schema.names), ok, thin)

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
            if pb.thin is not None and not self._thin_transparent():
                from ..columnar.lanes import materialize_batch
                pb = materialize_batch(pb, ctx.conf)
            if probe_conds:
                pb = compact_batch(pb, conds_mask(
                    probe_conds, pb, pb.row_mask(), ctx.conf), ctx.conf)
            cols = list(pb.columns)
            if self.join_type != J.LEFT_ANTI:
                cols += _null_columns(self.right.output_schema, pb.capacity,
                                      pb.device)
            out = DeviceBatch(cols, pb.num_rows, out_names, pb.sel, pb.thin)
            # a selection vector and the probe's lanes pass through to a
            # parent that takes them
            yield out if self.lazy_sel or self._thin_transparent() \
                else ensure_prefix(out, ctx.conf)


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
