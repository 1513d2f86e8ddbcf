"""The device collect_list / collect_set aggregation.

Counterpart of spark_rapids_tpu/exec/collect.py (the role of the
reference's collect aggregations over cuDF lists): a group-by whose
functions are all collect functions runs here (plan/overrides.py,
behind `sql.agg.collect.enabled`) through the sort-segment collect
(ops/percentile.collect_trace), and emits RAGGED columns.  Collect is
holistic (a group's list spans every batch), so the child's batches
concatenate first (`int(db.num_rows)` over the stream is a host
decision, as in the reference).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, bucket_capacity,
                               storage_dtype)
from ..ops import percentile as P
from ..ops.batch_ops import concat_batches, ensure_unique_dict
from ..plan import expressions as E
from ..plan.aggregates import CollectList, CollectSet
from ..runtime.capture import capturing
from .aggregate import holistic_pack_spec
from .evaluator import evaluate_projection
from .plan import ExecContext, PlanNode


class CollectAggregateExec(PlanNode):
    def __init__(self, key_exprs: Sequence[E.Expression],
                 key_names: Sequence[str],
                 aggs: Sequence[Tuple[CollectList, str]], child: PlanNode):
        super().__init__(child)
        schema = child.output_schema
        self.key_exprs = [e.bind(schema) for e in key_exprs]
        self.key_names = list(key_names)
        self.aggs = [(fn.bind(schema), name) for fn, name in aggs]
        if not all(isinstance(fn, CollectList) for fn, _ in self.aggs):
            raise TypeError("CollectAggregateExec runs collect_list and "
                            "collect_set only")

    @property
    def output_schema(self) -> t.StructType:
        fields = [t.StructField(n, e.dtype)
                  for n, e in zip(self.key_names, self.key_exprs)]
        fields += [t.StructField(n, fn.dtype) for fn, n in self.aggs]
        return t.StructType(fields)

    def keys_unique(self, names) -> bool:
        return not self.key_exprs or set(self.key_names) <= set(names)

    def static_row_count(self):
        return 1 if not self.key_exprs else None

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        conf = ctx.conf
        batches = [db for db in self.child.execute(ctx)
                   if int(db.num_rows) > 0]
        if not batches:
            if not self.key_exprs:
                yield self._empty_row(ctx)
            return
        merged = concat_batches(batches, conf)
        # one value column a (input, distinct) pair
        val_exprs: List[E.Expression] = []
        flavors: List[bool] = []
        val_of: List[int] = []
        seen = {}
        for fn, _name in self.aggs:
            fp = (fn.child.fingerprint(), isinstance(fn, CollectSet))
            if fp not in seen:
                seen[fp] = len(val_exprs)
                val_exprs.append(fn.child)
                flavors.append(fp[1])
            val_of.append(seen[fp])
        nk = len(self.key_exprs)
        proj = evaluate_projection(
            self.key_exprs + val_exprs,
            [f"_k{i}" for i in range(nk)] +
            [f"_v{j}" for j in range(len(val_exprs))], merged, conf,
            narrow="CollectAggregateExec")
        keys = [ensure_unique_dict(c) for c in proj.columns[:nk]]
        # collect_set dedupes by code: a duplicate-free dictionary
        vals = [ensure_unique_dict(c) for c in proj.columns[nk:]]
        live = merged.row_mask()
        cap = merged.capacity
        info = [(c.dtype, True, c.data.dtype) for c in keys]
        pack = holistic_pack_spec(keys, self.key_exprs, self.child)
        outs = []
        out_keys = n_groups = group_live = None
        for vcol, distinct in zip(vals, flavors):
            fn = P.collect_trace(info, cap, cap, distinct, vcol.dtype,
                                 pack_spec=pack)
            ok, values, offs, ev, ng, gl = fn(
                [c.data for c in keys], [c.validity for c in keys],
                vcol.data, vcol.validity, live)
            if out_keys is None:
                out_keys, n_groups = ok, ng if capturing() else int(ng)
                group_live = gl
            outs.append((values, offs, ev, vcol))
        cols = [DeviceColumn(kd, kv, kc.dtype, kc.dictionary)
                for (kd, kv), kc in zip(out_keys, keys)]
        if not nk:
            # a global collect has its one (possibly empty) list
            group_live = torch.arange(cap, device=live.device) < 1
        for j, (fn, _n) in zip(val_of, self.aggs):
            values, offs, ev, vcol = outs[j]
            cols.append(DeviceColumn(values, group_live, fn.dtype,
                                     vcol.dictionary, None, None, offs, ev))
        if nk:
            n_out = n_groups
        else:
            n_out = torch.clamp(n_groups, min=1) \
                if isinstance(n_groups, torch.Tensor) else max(n_groups, 1)
        yield DeviceBatch(cols, n_out,
                          self.key_names + [n for _f, n in self.aggs])

    def _empty_row(self, ctx: ExecContext) -> DeviceBatch:
        cap = bucket_capacity(1, ctx.conf)
        dev = ctx.device
        cols = [DeviceColumn(
            torch.zeros(cap, dtype=storage_dtype(fn.dtype.element_type),
                        device=dev),
            torch.arange(cap, device=dev) < 1, fn.dtype,
            np.array([], str) if isinstance(fn.dtype.element_type,
                                            t.StringType) else None,
            None, None, torch.zeros(cap + 1, dtype=torch.int32,
                                          device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev))
            for fn, _n in self.aggs]
        return DeviceBatch(cols, 1, [n for _f, n in self.aggs])

    def describe(self):
        return (f"CollectAggregateExec[keys={self.key_names}, "
                f"{[n for _f, n in self.aggs]}]")
