"""Adaptive (runtime-statistics) join: the engine's AQE analogue.

Counterpart of spark_rapids_tpu/exec/adaptive.py
(GpuShuffledSymmetricHashJoinExec's build-side choice from measured
sizes).  `AdaptiveShuffledJoinExec` materializes BOTH join inputs as
completed stages, measures their device bytes, and builds on the
smaller side — except that a side with unique join keys is worth more
than raw size (it unlocks the sync-free probe-aligned path) unless it is
more than 8x bigger.  Only inner and outer joins swap (`_MIRROR`: left
outer becomes right outer and back, full outer stays); a swap mirrors the
join type and restores the left-then-right column order on output, so
the swap is invisible.  A left semi join runs here without a swap (the
reference sends it here for its bloom filter); a left anti join never
comes here (plan/overrides.py).

Filters right below either input ride into the join as masks
(exec/plan.py peel_filters), so the stages hold the raw child batches
and the sizes compared are pre-filter sizes; correctness never depends
on the choice.  Each stage batch is a `Spillable` registered with the
query's budget (runtime/memory.py), so a stage may wait on the host or
on disk while the other side materializes; the replay takes each batch
back with `get()` and then `close()`s it.

The bloom runtime filter (`sql.join.runtimeFilter.enabled`, on by
default as in the reference; ops/bloom.py) wraps the probe side of an
inner, right outer or left semi join, where an unmatched probe row never
reaches the output, when the probe stage's bytes reach
`runtimeFilter.sizeRatio` times the build's: the build stage's keys set
the filter's bits (its fused filters mask the insertion) and each probe
batch is compacted to the rows whose key may be in the build.  A build
of at most two target batches whose single key's range fits a dense
span gets none: its join probes a table whose cost the filter's
compaction would not save (the reference's rule, whatever the tier
`denseReplace` then elects).  A thin probe batch (columnar/lanes.py)
keeps its lanes: the stage materializes the key columns only and
composes its verdict into the selection vector instead of compacting.
The query's metrics read `bloom_filter_slots` and `bloom_filtered_rows`.

The re-planned join takes the node's `lazy_sel` and `thin_payload`
(plan/overrides negotiate_lazy_sel, negotiate_thin); a swap's column
permutation carries the selection vector and the deferred columns
(`DeviceBatch.select`).  A stage may hold a masked or thin batch: a
spill resolves it to a row prefix (runtime/memory Spillable.spill).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from .. import types as t
from ..columnar.device import DeviceBatch
from ..ops.batch_ops import device_rows
from ..plan import expressions as E
from ..runtime.memory import Spillable
from .evaluator import conds_mask
from .join import (HashJoinExec, join_column_range, join_keys_unique,
                   key_ref_names, side_unique, span_fits)
from .plan import ExecContext, PlanNode, peel_filters

_MIRROR = {"inner": "inner", "left_outer": "right_outer",
           "right_outer": "left_outer", "full_outer": "full_outer"}


class _ReplayStage(PlanNode):
    """A completed stage (its spillable batches) the re-planned join
    replays once; statistics delegate to the node that produced it."""

    def __init__(self, batches: List[Spillable], source: PlanNode):
        super().__init__()
        self.batches = batches
        self._source = source

    @property
    def output_schema(self) -> t.StructType:
        return self._source.output_schema

    def keys_unique(self, names):
        return self._source.keys_unique(names)   # the same rows

    def column_range(self, name):
        return self._source.column_range(name)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for sp in self.batches:
            db = sp.get()
            sp.close()
            yield db


class _BloomFilterStage(PlanNode):
    """The probe-side runtime filter: drops the rows whose join key is
    certainly absent from the build side (ops/bloom.py).  Statistics
    delegate to the child, whose rows it keeps a subset of."""

    def __init__(self, child: PlanNode, bits, key_cols_fn, k: int,
                 key_exprs=()):
        super().__init__(child)
        self.bits = bits
        self.key_cols_fn = key_cols_fn
        self.k = k
        self.key_exprs = list(key_exprs)

    @property
    def output_schema(self) -> t.StructType:
        return self.children[0].output_schema

    def keys_unique(self, names):
        return self.children[0].keys_unique(names)

    def column_range(self, name):
        return self.children[0].column_range(name)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..ops.bloom import bloom_might_contain
        from ..ops.filter import compact_batch
        for db in self.children[0].execute(ctx):
            if db.thin is not None:
                from ..columnar.lanes import materialize_refs
                db = materialize_refs(db, self.key_exprs, ctx.conf)
            keep = bloom_might_contain(self.bits, self.key_cols_fn(db), db,
                                       self.k) & db.row_mask()
            if db.thin is not None:
                # a compaction is the row gather late materialization
                # skips: the verdict becomes the selection vector
                kept = keep.sum(dtype=torch.int32)
                ctx.bump("bloom_filtered_rows",
                         device_rows(db) -
                         kept)
                yield DeviceBatch(list(db.columns), kept, list(db.names),
                                  keep, db.thin)
                continue
            out = compact_batch(db, keep, ctx.conf)
            # counted on the device, read once at the query's end
            ctx.bump("bloom_filtered_rows",
                     device_rows(db) -
                     out.num_rows)
            yield out


class AdaptiveShuffledJoinExec(PlanNode):
    """Equi-join whose build side is chosen from measured input sizes.
    Output schema and semantics are HashJoinExec(join_type, ...)'s."""

    def __init__(self, join_type: str, left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression],
                 left: PlanNode, right: PlanNode):
        super().__init__(left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        # forwarded to the re-planned HashJoinExec (plan/overrides)
        self.lazy_sel = False
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
        if self.join_type in ("left_semi", "left_anti"):
            return t.StructType(lf)
        return t.StructType(lf + list(self.right.output_schema.fields))

    def keys_unique(self, names):
        return join_keys_unique(self.join_type, self.left, self.right,
                                self.left_keys, self.right_keys, names)

    def column_range(self, name):
        return join_column_range(self.join_type, self.left, self.right,
                                 name)

    @staticmethod
    def _materialize(node: PlanNode, ctx: ExecContext, stage: List):
        # no per-batch count sync: empty batches are padding only, and
        # the sizes below are capacity bytes (host-known)
        for db in node.execute(ctx):
            if not (isinstance(db.num_rows, int) and db.num_rows == 0):
                stage.append(Spillable(db, ctx.budget))

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        left_stage: List[Spillable] = []
        right_stage: List[Spillable] = []
        try:
            yield from self._run(ctx, left_stage, right_stage)
        finally:
            # an abandoned generator (a LIMIT above) releases the stages
            # the join never replayed; close is idempotent
            for sp in left_stage + right_stage:
                sp.close()

    def _run(self, ctx: ExecContext, left_stage, right_stage
             ) -> Iterator[DeviceBatch]:
        left_src, left_conds = peel_filters(self.left)
        right_src, right_conds = peel_filters(self.right)
        self._materialize(left_src, ctx, left_stage)
        self._materialize(right_src, ctx, right_stage)
        lbytes = sum(sp.nbytes for sp in left_stage)
        rbytes = sum(sp.nbytes for sp in right_stage)
        swap = self.join_type in _MIRROR and lbytes < rbytes
        if self.join_type in _MIRROR:
            run_u = side_unique(self.right_keys, self.right)
            lun_u = side_unique(self.left_keys, self.left)
            if run_u != lun_u:
                if lun_u and lbytes <= 8 * max(rbytes, 1):
                    swap = True
                elif run_u and rbytes <= 8 * max(lbytes, 1):
                    swap = False
        left = _ReplayStage(left_stage, self.left)
        right = _ReplayStage(right_stage, self.right)
        if not swap:
            join = HashJoinExec(
                self.join_type, self.left_keys, self.right_keys, left, right,
                probe_conds=left_conds, build_conds=right_conds)
            join.lazy_sel, join.thin_payload = \
                self.lazy_sel, self.thin_payload
            self._maybe_bloom(join, self.join_type, right_stage,
                              max(lbytes, 1), rbytes, ctx)
            yield from join.execute(ctx)
            return
        jt = _MIRROR[self.join_type]
        join = HashJoinExec(jt, self.right_keys, self.left_keys, right, left,
                            probe_conds=right_conds, build_conds=left_conds)
        join.lazy_sel, join.thin_payload = self.lazy_sel, self.thin_payload
        self._maybe_bloom(join, jt, left_stage, max(rbytes, 1), lbytes, ctx)
        # the mirrored output is right-cols ++ left-cols; restore the order
        n_r = len(self.right.output_schema.fields)
        n_l = len(self.left.output_schema.fields)
        perm = list(range(n_r, n_r + n_l)) + list(range(n_r))
        for db in join.execute(ctx):
            yield db.select(perm)

    @staticmethod
    def _maybe_bloom(join: HashJoinExec, jt: str, build_stage: List,
                     probe_bytes: int, build_bytes: int,
                     ctx: ExecContext) -> None:
        """Wrap the join's probe side in a bloom runtime filter where it
        pays and is safe: inner, right outer and left semi joins only
        (left/full outer joins keep unmatched probe rows, anti joins
        emit them), probe bytes at least `runtimeFilter.sizeRatio` times
        the build's, and no single-batch build whose one key fits a
        dense span."""
        from ..config import (RUNTIME_FILTER_ENABLED, RUNTIME_FILTER_FPP,
                              RUNTIME_FILTER_RATIO)
        from ..ops.bloom import bloom_build, optimal_hashes, optimal_slots
        conf = ctx.conf
        if jt not in ("inner", "right_outer", "left_semi") or \
                not conf.get(RUNTIME_FILTER_ENABLED) or \
                probe_bytes < build_bytes * conf.get(RUNTIME_FILTER_RATIO):
            return
        build_rows = sum(sp.num_rows for sp in build_stage)
        rn = key_ref_names(join.right_keys)
        if rn is not None and len(rn) == 1 and \
                key_ref_names(join.left_keys) is not None and \
                build_rows <= 2 * conf.batch_size_rows:
            rng = join.right.column_range(rn[0])
            if rng is not None and span_fits(int(rng[1]) - int(rng[0]) + 1,
                                             max(build_rows, 1)):
                return
        m = optimal_slots(build_rows, fpp=conf.get(RUNTIME_FILTER_FPP))
        k = optimal_hashes(build_rows, m)
        bits = None
        for sp in build_stage:
            bb = sp.get()
            if bb.thin is not None:
                from ..columnar.lanes import materialize_refs
                bb = materialize_refs(bb, list(join.right_keys) +
                                      list(join.build_conds), conf)
            # the fused build filters mask the insertion, else the filter
            # keeps the keys they remove
            live = conds_mask(join.build_conds, bb, bb.row_mask(), conf) \
                if join.build_conds else None
            bits = bloom_build(join._key_cols(bb, join.right_keys, ctx), bb,
                               m, k, bits, live=live)

        def probe_keys(db):
            return join._key_cols(db, join.left_keys, ctx)
        join.children[0] = _BloomFilterStage(join.children[0], bits,
                                             probe_keys, k, join.left_keys)
        ctx.metrics["bloom_filter_slots"] = m
