"""The device percentile aggregation.

Counterpart of spark_rapids_tpu/exec/percentile.py (the role of the
reference's GpuPercentile and GpuApproximatePercentile): an aggregation
whose functions are all of the percentile family runs here
(plan/overrides.py).  Percentile is holistic, so the exec concatenates
the child's batches (`int(db.num_rows)` over the stream is a host
decision, as in the reference) and runs one sort-segment program a
distinct input expression (ops/percentile.py); a stable sort over the
same key lanes segments the groups alike for each.

Over several batches an aggregation of only approx_percentile takes the
PARTIAL/FINAL shape (`_sketched`): a device sketch of each batch, the
sketches merged a group on the host (ops/quantile_sketch.py), then
interpolated.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, bucket_capacity,
                               to_device, to_host)
from ..ops import percentile as P
from ..ops.batch_ops import concat_batches, ensure_unique_dict, shrink_to_rows
from ..plan import expressions as E
from ..plan.aggregates import ApproximatePercentile, Percentile, _resolved
from ..runtime.capture import capturing
from .aggregate import holistic_pack_spec
from .evaluator import evaluate_projection
from .plan import ExecContext, PlanNode, _key_ref_name


def _value_columns(aggs):
    """(one DOUBLE cast a distinct input expression, agg i -> (its column,
    its percentage))."""
    val_exprs: List[E.Expression] = []
    val_map: List[Tuple[int, float]] = []
    seen = {}
    for fn, _name in aggs:
        fp = fn.child.fingerprint()
        if fp not in seen:
            seen[fp] = len(val_exprs)
            val_exprs.append(_resolved(E.Cast(fn.child, t.DOUBLE)))
        val_map.append((seen[fp], fn.percentage))
    return val_exprs, val_map


class PercentileAggregateExec(PlanNode):
    def __init__(self, key_exprs: Sequence[E.Expression],
                 key_names: Sequence[str],
                 aggs: Sequence[Tuple[Percentile, str]], child: PlanNode):
        super().__init__(child)
        schema = child.output_schema
        self.key_exprs = [e.bind(schema) for e in key_exprs]
        self.key_names = list(key_names)
        self.aggs = [(fn.bind(schema), name) for fn, name in aggs]
        if not all(isinstance(fn, Percentile) for fn, _ in self.aggs):
            raise TypeError("PercentileAggregateExec runs the percentile "
                            "family only")

    @property
    def output_schema(self) -> t.StructType:
        fields = [t.StructField(n, e.dtype)
                  for n, e in zip(self.key_names, self.key_exprs)]
        fields += [t.StructField(n, t.DOUBLE) for _fn, n in self.aggs]
        return t.StructType(fields)

    def keys_unique(self, names) -> bool:
        return not self.key_exprs or set(self.key_names) <= set(names)

    def static_row_count(self):
        return 1 if not self.key_exprs else None

    def column_range(self, name):
        if name not in self.key_names:
            return None
        ref = _key_ref_name(self.key_exprs[self.key_names.index(name)])
        return None if ref is None else self.child.column_range(ref)

    def _project(self, db: DeviceBatch, val_exprs, conf):
        nk = len(self.key_exprs)
        proj = evaluate_projection(
            self.key_exprs + val_exprs,
            [f"_k{i}" for i in range(nk)] +
            [f"_v{j}" for j in range(len(val_exprs))], db, conf,
            narrow="PercentileAggregateExec")
        keys = [ensure_unique_dict(c) for c in proj.columns[:nk]]
        info = [(c.dtype, True, c.data.dtype) for c in keys]
        pack = holistic_pack_spec(keys, self.key_exprs, self.child)
        return keys, proj.columns[nk:], info, pack

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        conf = ctx.conf
        batches = [db for db in self.child.execute(ctx)
                   if int(db.num_rows) > 0]
        if not batches:
            if not self.key_exprs:
                yield self._null_row(ctx)
            return
        if len(batches) > 1 and all(isinstance(fn, ApproximatePercentile)
                                    for fn, _ in self.aggs):
            yield self._sketched(batches, ctx)
            return
        merged = concat_batches(batches, conf)
        val_exprs, val_map = _value_columns(self.aggs)
        keys, vals, info, pack = self._project(merged, val_exprs, conf)
        live = merged.row_mask()
        cap = merged.capacity
        results: list = [None] * len(self.aggs)
        out_keys = n_groups = None
        for j, vcol in enumerate(vals):
            qs = sorted({q for jj, q in val_map if jj == j})
            fn = P.percentile_trace(info, qs, cap, cap, pack_spec=pack)
            ok, per_q, ng = fn([c.data for c in keys],
                               [c.validity for c in keys],
                               vcol.data.to(torch.float64), vcol.validity,
                               live)
            if out_keys is None:
                out_keys, n_groups = ok, ng if capturing() else int(ng)
            for i, (jj, q) in enumerate(val_map):
                if jj == j:
                    results[i] = per_q[qs.index(q)]
        cols = [DeviceColumn(kd, kv, kc.dtype, kc.dictionary)
                for (kd, kv), kc in zip(out_keys, keys)]
        cols += [DeviceColumn(data, valid, t.DOUBLE)
                 for data, valid in results]
        if self.key_exprs:
            n_out = n_groups
        else:
            n_out = torch.clamp(n_groups, min=1) \
                if isinstance(n_groups, torch.Tensor) else max(n_groups, 1)
        names = self.key_names + [n for _f, n in self.aggs]
        yield shrink_to_rows(DeviceBatch(cols, n_out, names), n_out, conf)

    def _sketched(self, batches: List[DeviceBatch], ctx: ExecContext
                  ) -> DeviceBatch:
        """The PARTIAL a batch (a device sketch per group), the host merge
        per group across batches, and the interpolated FINAL."""
        from ..columnar.host import from_pydict
        from ..config import APPROX_PERCENTILE_SKETCH_K
        from ..ops.quantile_sketch import merge_sketches, query_sketch
        conf = ctx.conf
        k = int(conf.get(APPROX_PERCENTILE_SKETCH_K))
        val_exprs, val_map = _value_columns(self.aggs)
        nk = len(self.key_exprs)
        # group key tuple -> per value column a list of (count, points)
        sketches: dict = {}
        for db in batches:
            keys, vals, info, pack = self._project(db, val_exprs, conf)
            live = db.row_mask()
            cap = db.capacity
            for j, vcol in enumerate(vals):
                fn = P.sketch_trace(info, k, cap, cap, pack_spec=pack)
                ok, cnt, pts = fn([c.data for c in keys],
                                  [c.validity for c in keys],
                                  vcol.data.to(torch.float64),
                                  vcol.validity, live)
                ng = cnt.shape[0]
                kb = to_host(DeviceBatch(
                    [DeviceColumn(kd, kv, kc.dtype, kc.dictionary)
                     for (kd, kv), kc in zip(ok, keys)] or
                    [DeviceColumn(cnt, torch.ones_like(cnt, dtype=torch.bool),
                                  t.LONG)],
                    ng, [f"_k{i}" for i in range(max(nk, 1))]), ng)
                rows = list(zip(*[c.to_pylist() for c in kb.columns[:nk]])) \
                    if nk else [()] * ng
                cnt_h = cnt.cpu().numpy()
                pts_h = pts.cpu().numpy()
                for g, kt in enumerate(rows):
                    slot = sketches.setdefault(kt, [[] for _ in val_exprs])
                    slot[j].append((int(cnt_h[g]), pts_h[g]))
        if not sketches and not nk:
            sketches[()] = [[] for _ in val_exprs]
        keys_out = sorted(sketches, key=lambda kt: tuple(
            (v is None, v) for v in kt))
        final = {kt: [merge_sketches(slots[jj], k=k)
                      for jj in range(len(val_exprs))]
                 for kt, slots in sketches.items()}
        data = {n: [kt[i] for kt in keys_out]
                for i, n in enumerate(self.key_names)}
        for (jj, q), (_fn, name) in zip(val_map, self.aggs):
            data[name] = [query_sketch(*final[kt][jj], q)
                          for kt in keys_out]
        hb = from_pydict(data, self.output_schema)
        return to_device(hb, conf, device=ctx.device)

    def _null_row(self, ctx: ExecContext) -> DeviceBatch:
        cap = bucket_capacity(1, ctx.conf)
        cols = [DeviceColumn(torch.zeros(cap, dtype=torch.float64,
                                         device=ctx.device),
                             torch.zeros(cap, dtype=torch.bool,
                                         device=ctx.device), t.DOUBLE)
                for _ in self.aggs]
        return DeviceBatch(cols, 1, [n for _f, n in self.aggs])

    def describe(self):
        return (f"PercentileAggregateExec[keys={self.key_names}, "
                f"{[n for _f, n in self.aggs]}]")
