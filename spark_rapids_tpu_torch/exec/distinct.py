"""count(DISTINCT) aggregation exec.

Counterpart of spark_rapids_tpu/exec/distinct.py.  An aggregation whose
functions are all CountDistinct runs here (plan/overrides.py): the
child's batches concatenate into one, the keys and the distinct values
are projected over it, and each distinct input expression runs one
sorted count (ops/distinct.py).  String keys and values are remapped to
a duplicate-free dictionary first, so code equality is string equality.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity
from ..ops.batch_ops import concat_batches, ensure_unique_dict, shrink_to_rows
from ..ops.distinct import distinct_count_trace, exact_value_range
from ..plan import expressions as E
from ..plan.aggregates import CountDistinct
from ..runtime.capture import capturing
from .aggregate import holistic_pack_spec
from .evaluator import evaluate_projection
from .plan import ExecContext, PlanNode, _key_ref_name


class DistinctAggregateExec(PlanNode):
    def __init__(self, key_exprs: Sequence[E.Expression],
                 key_names: Sequence[str],
                 aggs: Sequence[Tuple[CountDistinct, str]],
                 child: PlanNode):
        super().__init__(child)
        schema = child.output_schema
        self.key_exprs = [e.bind(schema) for e in key_exprs]
        self.key_names = list(key_names)
        self.aggs = [(fn.bind(schema), name) for fn, name in aggs]
        if not all(isinstance(fn, CountDistinct) for fn, _ in self.aggs):
            raise TypeError("DistinctAggregateExec runs CountDistinct only")

    @property
    def output_schema(self) -> t.StructType:
        fields = [t.StructField(n, e.dtype)
                  for n, e in zip(self.key_names, self.key_exprs)]
        fields += [t.StructField(n, t.LONG, False) for _fn, n in self.aggs]
        return t.StructType(fields)

    def keys_unique(self, names) -> bool:
        # one output row per group-key tuple; a global count has one row
        return not self.key_exprs or set(self.key_names) <= set(names)

    def static_row_count(self):
        return 1 if not self.key_exprs else None

    def column_range(self, name):
        if name not in self.key_names:
            return None
        return self._range_of(self.key_exprs[self.key_names.index(name)])

    def _range_of(self, e: E.Expression):
        """The child's range of a plain column expression, else None."""
        ref = _key_ref_name(e)
        return None if ref is None else self.child.column_range(ref)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        conf = ctx.conf
        batches = [db for db in self.child.execute(ctx)
                   if not (isinstance(db.num_rows, int) and db.num_rows == 0)]
        if not batches:
            if not self.key_exprs:
                yield self._zero_row(ctx)
            return
        merged = concat_batches(batches, conf)
        # each distinct input expression is counted once
        val_exprs: List[E.Expression] = []
        val_of: List[int] = []
        seen = {}
        for fn, _name in self.aggs:
            fp = fn.child.fingerprint()
            if fp not in seen:
                seen[fp] = len(val_exprs)
                val_exprs.append(fn.child)
            val_of.append(seen[fp])
        nk = len(self.key_exprs)
        proj = evaluate_projection(
            self.key_exprs + val_exprs,
            [f"_k{i}" for i in range(nk)] +
            [f"_v{j}" for j in range(len(val_exprs))], merged, conf,
            narrow="DistinctAggregateExec")
        key_cols = [ensure_unique_dict(c) for c in proj.columns[:nk]]
        val_cols = [ensure_unique_dict(c) for c in proj.columns[nk:]]
        live = merged.row_mask()
        cap = merged.capacity
        info = [(c.dtype, True, c.data.dtype) for c in key_cols]
        pack = holistic_pack_spec(key_cols, self.key_exprs, self.child)
        counts = []
        out_keys = n_groups = None
        for vcol, e in zip(val_cols, val_exprs):
            fn = distinct_count_trace(
                info, cap, cap, pack_spec=pack,
                val_range=exact_value_range(vcol, self._range_of(e)))
            ok, cnt, ng = fn([c.data for c in key_cols],
                             [c.validity for c in key_cols], vcol, live)
            if out_keys is None:
                out_keys, n_groups = ok, ng if capturing() else int(ng)
            counts.append(cnt)
        cols = [DeviceColumn(kd, kv, kc.dtype, kc.dictionary)
                for (kd, kv), kc in zip(out_keys, key_cols)]
        for j in val_of:
            # count(DISTINCT) is never null; a global count's one slot
            # is live even when no row was
            cnt, group_live = counts[j]
            if not nk:
                group_live = torch.arange(cap, device=cnt.device) < 1
            cols.append(DeviceColumn(cnt, group_live, t.LONG))
        names = self.key_names + [n for _f, n in self.aggs]
        # a global count has its one row even over no live row
        n_out = n_groups if nk else 1
        yield shrink_to_rows(DeviceBatch(cols, n_out, names), n_out, conf)

    def _zero_row(self, ctx: ExecContext) -> DeviceBatch:
        cap = bucket_capacity(1, ctx.conf)
        live = torch.arange(cap, device=ctx.device) < 1
        cols = [DeviceColumn(torch.zeros(cap, dtype=torch.int64,
                                         device=ctx.device), live, t.LONG)
                for _ in self.aggs]
        return DeviceBatch(cols, 1, [n for _f, n in self.aggs])
