"""Hash-aggregate execution: partial -> merge -> final over device batches.

Counterpart of spark_rapids_tpu/exec/aggregate.py.  Per input batch the
aggregate inputs are projected and the update group-by runs (partial);
partials concatenate and re-group with the merge kinds; the final
projection evaluates each aggregate's result expression over the merged
buffers.

Group-bys elect their tier as the reference's `_run_groupby` does:
  * the segmented-aggregation kernels (ops/hopper/segagg.py) whenever
    every key is bounded — dictionary codes, booleans, or integers with
    exact scan ranges (or the exact range a cast of a string knows from
    its dictionary: `DeviceColumn.value_range`) — and the packed domain
    passes the election gate
    (ops/hopper elect_segagg, `segagg.maxDomain`);
  * else the dense no-sort tier (ops/groupby.dense_groupby_trace) when
    every key is a dictionary code or a boolean and the bucket product
    stays within `sql.agg.denseDomainMax` (`_dense_domains`);
    `sql.agg.denseDomainViaSort=true` sends those keys through the
    sorted group-by's packed lane instead;
  * else the sorted group-by (ops/groupby.groupby_trace), with the
    bounded keys packed into one sort lane.
`GROUPBY_TIERS` counts each tier's group-by calls.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, bucket_capacity,
                               storage_dtype, to_host)
from ..columnar.host import HostBatch
from ..config import DENSE_AGG_DOMAIN_MAX, DENSE_AGG_VIA_SORT, TpuConf
from ..ops import groupby as G
from ..ops.batch_ops import (concat_batches, ensure_unique_dict,
                             shrink_to_capacity, shrink_to_rows,
                             unify_dictionaries)
from ..plan import expressions as E
from ..runtime.capture import capturing, host_constant
from ..plan.aggregates import (ROWS_EXACT, AggregateFunction,
                               _deep_resolved, past_rows_error,
                               uses_half_lanes)
from .evaluator import conds_mask, evaluate_projection

_PACK_BUDGET = 1 << 62

#: group-by calls by elected tier ("segagg", "dense", "sort"), raised in
#: `_run_groupby`; read (and zeroed) by whoever checks a query's tier
GROUPBY_TIERS = {"segagg": 0, "dense": 0, "sort": 0}


def reset_groupby_tiers() -> None:
    for k in GROUPBY_TIERS:
        GROUPBY_TIERS[k] = 0


def _dense_domains(key_cols, conf: TpuConf) -> "Optional[List[int]]":
    """Per-key domain sizes when ALL keys are dictionary codes or
    booleans and the bucket product stays within the dense budget."""
    limit = conf.get(DENSE_AGG_DOMAIN_MAX)
    sizes = []
    total = 1
    for c in key_cols:
        if c.dictionary is not None:
            sizes.append(max(len(c.dictionary), 1))
        elif isinstance(c.dtype, t.BooleanType):
            sizes.append(2)
        else:
            return None
        total *= sizes[-1] + 1
        if total > limit:
            return None
    return sizes


def _key_pack_spec(key_cols, key_ranges) -> "Optional[tuple]":
    """Per-key (lo, span) for keys with exact static bounds — plan range
    statistics or dictionary domains (pow2-quantized span) — greedily
    until the span product budget; None unless every key packs or at
    least two do (one packed lane must replace lanes to pay for
    itself)."""
    spec = []
    total = 1
    packed = 0
    for i, c in enumerate(key_cols):
        rng = key_ranges[i] if key_ranges is not None else None
        entry = None
        if isinstance(c.dtype, t.StringType):
            if c.dictionary is not None:
                span = max(len(c.dictionary), 1) + 1
                entry = (0, 1 << (span - 1).bit_length())
        elif isinstance(c.dtype, (t.DoubleType, t.FloatType)):
            entry = None
        elif rng is not None:
            lo, hi = int(rng[0]), int(rng[1])
            entry = (lo, hi - lo + 2)
        elif isinstance(c.dtype, t.BooleanType):
            entry = (0, 3)
        if entry is not None and total * entry[1] <= _PACK_BUDGET:
            total *= entry[1]
            packed += 1
            spec.append(entry)
        else:
            spec.append(None)
    if packed == len(key_cols) or packed >= 2:
        return tuple(spec)
    return None


def holistic_pack_spec(key_cols, key_exprs, child):
    """The pack spec of the holistic (sorted_segments) aggregation execs
    (exec/percentile.py, exec/collect.py): the child's range of each
    plainly referenced key and the dictionary and boolean domains, so
    every key folds into one sort lane when all are bounded."""
    from .plan import _key_ref_name
    ranges = []
    for e in key_exprs:
        ref = _key_ref_name(e)
        ranges.append(None if ref is None else child.column_range(ref))
    return _key_pack_spec(key_cols, ranges)


def _domains_as_pack(domains):
    """Dense key domains (codes in [0, size)) as a packed-lane spec:
    slot 0 stays the null slot, codes shift up by one."""
    return tuple((0, size + 1) for size in domains)


def _run_groupby(key_cols: List[DeviceColumn], agg_cols: List[DeviceColumn],
                 specs: List[G.AggSpec], live, capacity: int,
                 key_ranges=None, conf: TpuConf = None):
    from ..ops.hopper import elect_segagg
    from ..ops.hopper.segagg import segagg_groupby_trace
    key_cols = [ensure_unique_dict(c) for c in key_cols]
    # a key without a plan range may know its own (a cast of a string)
    key_ranges = [c.value_range if r is None else r for c, r in zip(
        key_cols, key_ranges or [None] * len(key_cols))]
    domains = _dense_domains(key_cols, conf)
    pack = _domains_as_pack(domains) if domains is not None \
        else _key_pack_spec(key_cols, key_ranges)
    tier = None
    # the most groups there can be: the packed domain where a tier knows
    # it, else the capacity (a capture keeps this static bound, not the
    # count)
    bound = capacity
    if pack is not None and all(s is not None for s in pack):
        total = 1
        for _lo, span in pack:
            total *= int(span)
        has_float_sum = any(s.kind == G.SUM and t.is_floating(s.dtype)
                            for s in specs)
        tier = elect_segagg(conf, total, has_float_sum)
        if tier is not None:
            bound = min(capacity, total)
    info = [(c.dtype, True, c.data.dtype) for c in key_cols]
    if tier is not None:
        GROUPBY_TIERS["segagg"] += 1
        fn = segagg_groupby_trace(pack, info, list(specs), capacity,
                                  capacity)
    elif domains is not None and not conf.get(DENSE_AGG_VIA_SORT):
        GROUPBY_TIERS["dense"] += 1
        dom = 1
        for d in domains:
            dom *= int(d)
        bound = min(capacity, dom)
        fn = G.dense_groupby_trace(list(domains), list(specs), capacity)
    else:
        GROUPBY_TIERS["sort"] += 1
        fn = G.groupby_trace(info, list(specs), capacity, capacity,
                             pack_spec=pack)
    out_keys, outs, num_groups = fn(
        [c.data for c in key_cols], [c.validity for c in key_cols],
        [c.data for c in agg_cols], [c.validity for c in agg_cols], live)
    # the group count comes to the host, as in the reference's eager
    # path: shrinking to the real bucket keeps the merge and sort small.
    # Under capture it stays a device count over the static capacity.
    if not capturing():
        num_groups = int(num_groups)
    return key_cols, out_keys, outs, num_groups, bound


def _buffer_dicts(specs: Sequence[G.AggSpec],
                  source_cols: Sequence[DeviceColumn]) -> List:
    """Each buffer's dictionary: a STRING buffer (FIRST/LAST) holds the
    codes of its input column, so it carries that column's dictionary."""
    return [source_cols[s.input_idx].dictionary
            if isinstance(s.dtype, t.StringType) and s.input_idx >= 0
            else None for s in specs]


def check_agg_buffers_supported(aggs) -> None:
    """A wide (p > 18) DECIMAL read straight off a column may carry a high
    word, which no buffer lane reads: plan-time tagging sends such an
    aggregate to the CPU engine (`AggregateFunction.unsupported_reasons`);
    a direct caller fails here (the reference's check of the same
    name)."""
    for fn, _name in aggs:
        child = getattr(fn, "child", None)
        if child is not None and E.consumes_wide_host(child):
            raise NotImplementedError(
                f"128-bit host decimal input to {fn.name} not supported "
                "on device")


def _run_reduce(agg_cols: List[DeviceColumn], specs: List[G.AggSpec],
                live, capacity: int):
    return G.reduce_trace(list(specs), capacity)(
        [c.data for c in agg_cols], [c.validity for c in agg_cols], live)


class HashAggregate:
    """Bound group-by aggregation over a stream of device batches."""

    def __init__(self, key_exprs: Sequence[E.Expression],
                 key_names: Sequence[str],
                 aggs: Sequence[Tuple[AggregateFunction, str]],
                 conf: TpuConf, key_ranges=None):
        self.key_exprs = list(key_exprs)
        self.key_names = list(key_names)
        self.aggs = list(aggs)
        self.conf = conf
        check_agg_buffers_supported(self.aggs)
        # exact (lo, hi) per key from plan statistics (or None): lets
        # bounded integer keys pack into the kernel's bucket lane
        self.key_ranges = list(key_ranges) if key_ranges is not None \
            else [None] * len(self.key_exprs)
        self.update_specs: List[G.AggSpec] = []
        self.merge_specs: List[G.AggSpec] = []
        # rows read so far (the batches' capacities: no sync), bounded
        # where a wide DECIMAL sum's half lanes are exact
        self.rows_read = 0
        self.rows_bounded = any(uses_half_lanes(fn) for fn, _n in self.aggs)
        self.input_exprs: List[E.Expression] = []
        self.buffer_slices: List[Tuple[int, int]] = []
        for fn, _name in self.aggs:
            start = len(self.update_specs)
            # an input object a function lists twice (AVG's sum and
            # count) is projected, gathered and counted once
            seen = {}
            for (kind, bdt), inp in zip(fn.update_ops(), fn.inputs()):
                idx = -1
                if inp is not None:
                    idx = seen.get(id(inp), len(self.input_exprs))
                    if idx == len(self.input_exprs):
                        seen[id(inp)] = idx
                        self.input_exprs.append(inp)
                self.update_specs.append(G.AggSpec(kind, idx, bdt))
            self.buffer_slices.append((start, len(self.update_specs)))
        # merge specs operate on buffer columns positionally
        for fn, _name in self.aggs:
            for mkind, mdt in fn.merge_ops():
                self.merge_specs.append(
                    G.AggSpec(mkind, len(self.merge_specs), mdt))

    def materialize_inputs(self, db: DeviceBatch,
                           conds: Sequence[E.Expression]) -> DeviceBatch:
        """An aggregation is a sink of thin join output: the deferred
        columns its keys, inputs and fused filters read materialize here,
        one gather a lane source; the rest are never gathered."""
        if db.thin is None:
            return db
        from ..columnar.lanes import materialize_refs
        return materialize_refs(db, list(conds) + self.key_exprs +
                                self.input_exprs, self.conf)

    # ---- phases ----

    def partial(self, db: DeviceBatch, live=None) -> DeviceBatch:
        """One input batch -> (keys + buffer columns) partial result.
        `live` (optional bool mask) fuses upstream filters: filtered rows
        never contribute, and nothing is compacted."""
        agg_cols = evaluate_projection(
            self.input_exprs,
            [f"_in{i}" for i in range(len(self.input_exprs))], db,
            self.conf, narrow="HashAggregateExec").columns \
            if self.input_exprs else []
        if live is None:
            live = db.row_mask()
        if not self.key_exprs:
            outs = _run_reduce(agg_cols, self.update_specs, live, db.capacity)
            return self._reduce_outs_to_batch(
                outs, _buffer_dicts(self.update_specs, agg_cols))
        key_batch = evaluate_projection(self.key_exprs, self.key_names, db,
                                        self.conf, narrow="HashAggregateExec")
        key_cols, out_keys, outs, n_groups, bound = _run_groupby(
            key_batch.columns, agg_cols, self.update_specs, live,
            db.capacity, key_ranges=self.key_ranges, conf=self.conf)
        return self._groupby_outs_to_batch(
            key_cols, out_keys, outs, n_groups,
            _buffer_dicts(self.update_specs, agg_cols), bound)

    def partial_fused(self, db: DeviceBatch, conds: Sequence[E.Expression],
                      raw: bool = False):
        """Filter + key/input projection + update group-by for one batch:
        the fused filters become the group-by's live mask.  `raw` (global
        aggregates) returns (the buffer scalars, their dictionaries)
        instead of a batch.  Every input batch passes here: past
        `ROWS_EXACT` rows an aggregation with a wide DECIMAL sum raises
        rather than wrap its half lanes."""
        self.rows_read += db.capacity
        if self.rows_bounded and self.rows_read > ROWS_EXACT:
            raise past_rows_error(self.rows_read)
        live = conds_mask(conds, db, db.row_mask(), self.conf)
        if raw and not self.key_exprs:
            agg_cols = evaluate_projection(
                self.input_exprs,
                [f"_in{i}" for i in range(len(self.input_exprs))], db,
                self.conf, narrow="HashAggregateExec").columns
            return (_run_reduce(agg_cols, self.update_specs, live,
                                db.capacity),
                    _buffer_dicts(self.update_specs, agg_cols))
        return self.partial(db, live)

    def merge_raw(self, partials: List[Tuple[List, List]]
                  ) -> Tuple[List, List]:
        """Merge per-batch global-aggregate (buffer scalars,
        dictionaries); a STRING buffer's codes move into the union of its
        batches' dictionaries first."""
        if len(partials) == 1:
            return partials[0]
        k = len(partials)
        outs = [list(p[0]) for p in partials]
        dicts = []
        for i in range(len(self.update_specs)):
            ds = [p[1][i] for p in partials]
            if ds[0] is not None and any(d is not ds[0] for d in ds):
                unified, remaps = unify_dictionaries(ds)
                for o, r in zip(outs, remaps):
                    table = host_constant(r, o[i][0].device)
                    o[i] = (table[torch.clamp(o[i][0], 0, len(r) - 1)
                                  .long()], o[i][1])
                ds = [unified]
            dicts.append(ds[0])
        stacks = [torch.stack([o[i][0] for o in outs])
                  for i in range(len(self.update_specs))]
        valids = [torch.stack([o[i][1] for o in outs])
                  for i in range(len(self.update_specs))]
        live = torch.ones(k, dtype=torch.bool, device=stacks[0].device)
        return (G.reduce_trace(self.merge_specs, k)(stacks, valids, live),
                dicts)

    def merge(self, partials: List[DeviceBatch]) -> DeviceBatch:
        merged = concat_batches(partials, self.conf)
        nkeys = len(self.key_exprs)
        key_cols = merged.columns[:nkeys]
        buf_cols = merged.columns[nkeys:]
        dicts = _buffer_dicts(self.merge_specs, buf_cols)
        if not self.key_exprs:
            outs = _run_reduce(buf_cols, self.merge_specs, merged.row_mask(),
                               merged.capacity)
            return self._reduce_outs_to_batch(outs, dicts)
        key_cols, out_keys, outs, n_groups, bound = _run_groupby(
            key_cols, buf_cols, self.merge_specs, merged.row_mask(),
            merged.capacity, key_ranges=self.key_ranges, conf=self.conf)
        return self._groupby_outs_to_batch(key_cols, out_keys, outs, n_groups,
                                           dicts, bound)

    def final(self, merged: DeviceBatch) -> DeviceBatch:
        """Evaluate result expressions over (keys + buffers)."""
        schema = merged.schema
        out_exprs: List[E.Expression] = [
            E.ColumnRef(name).bind(schema) for name in self.key_names]
        for (fn, _name), (start, end) in zip(self.aggs, self.buffer_slices):
            refs = [E.ColumnRef(f"_buf{j}").bind(schema)
                    for j in range(start, end)]
            out_exprs.append(_deep_resolved(fn.evaluate(refs)))
        names = self.key_names + [name for _fn, name in self.aggs]
        return evaluate_projection(out_exprs, names, merged, self.conf)

    # ---- plumbing ----

    def _buffer_names(self):
        return [f"_buf{i}" for i in range(len(self.update_specs))]

    def _groupby_outs_to_batch(self, key_cols, out_keys, outs, n_groups,
                               dicts, bound: int):
        cols = [DeviceColumn(kd, kv, kc.dtype, kc.dictionary, kc.value_range)
                for (kd, kv), kc in zip(out_keys, key_cols)]
        # update and merge specs share buffer dtypes positionally
        for (data, valid), spec, d in zip(outs, self.update_specs, dicts):
            cols.append(DeviceColumn(data.to(storage_dtype(spec.dtype)),
                                     valid, spec.dtype, d))
        db = DeviceBatch(cols, n_groups,
                         self.key_names + self._buffer_names())
        if isinstance(n_groups, torch.Tensor):
            # a device count (under capture): the static bound cuts
            return shrink_to_capacity(db, bound, self.conf)
        return shrink_to_rows(db, n_groups, self.conf)

    def _reduce_outs_to_batch(self, outs, dicts) -> DeviceBatch:
        """Global-aggregate buffer scalars as row 0 of a 1-row batch."""
        cap = bucket_capacity(1, self.conf)
        cols = []
        for (data, valid), spec, dic in zip(outs, self.update_specs, dicts):
            sdt = storage_dtype(spec.dtype)
            d = torch.zeros(cap, dtype=sdt, device=data.device)
            v = torch.zeros(cap, dtype=torch.bool, device=data.device)
            d[0] = data.to(sdt)
            v[0] = valid
            cols.append(DeviceColumn(d, v, spec.dtype, dic))
        return DeviceBatch(cols, 1, self._buffer_names())

    def final_host(self, outs, dicts) -> HostBatch:
        """Finish a global aggregation on the host from its merged buffer
        scalars (the reference's `final_host`): the buffers come to the
        CPU as one 1-row batch and each result expression runs there; a
        DECIMAL average whose upscaled sum leaves int64 divides exact
        Python integers (`_DecimalAvgEvaluate`)."""
        cpu = torch.device("cpu")
        buffers = self._reduce_outs_to_batch(
            [(d.to(cpu), v.to(cpu)) for d, v in outs], dicts)
        schema = buffers.schema
        cols = []
        for (fn, _name), (start, end) in zip(self.aggs, self.buffer_slices):
            refs = [E.ColumnRef(f"_buf{j}").bind(schema)
                    for j in range(start, end)]
            expr = _deep_resolved(fn.evaluate(refs))
            out = evaluate_projection([expr], ["_out"], buffers, self.conf)
            cols.append(to_host(out, 1).columns[0])
        return HostBatch(cols, [name for _fn, name in self.aggs])
