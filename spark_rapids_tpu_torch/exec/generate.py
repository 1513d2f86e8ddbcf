"""explode / posexplode on the device over ragged columns.

Counterpart of spark_rapids_tpu/exec/generate.py (the role of
GpuGenerateExec): over the values+offsets layout the exploded rows ARE
the values lane.  The parent's columns gather through the value -> row
map (ops/ragged.row_ids), `pos` is the slot's place in its row, and the
output's capacity is the values lane's own bucket, so the operator reads
nothing on the host and captures whole (exec/compiled.py).

As Spark's GenerateExec.requiredChildOutput prunes it, the exploded
ARRAY column leaves the output: plan/overrides.py places this exec only
where the parent never reads it.  `outer` also emits the rows whose
array is null or empty, once each with a null element (and pos), as a
second, compacted batch.
"""
from __future__ import annotations

from typing import Iterator, List

import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn
from ..ops import ragged as R
from ..ops.batch_ops import ensure_prefix
from ..ops.filter import compact_batch, gather_batch
from .plan import ExecContext, PlanNode


class GenerateExec(PlanNode):
    """explode/posexplode(col): the child's columns but the array input,
    then [pos,] col."""

    def __init__(self, generator, output_names: List[str], child: PlanNode):
        super().__init__(child)
        self.generator = generator.bind(child.output_schema)
        self._gen_fields = self.generator.output_fields()
        self.output_names = list(output_names) or \
            [f.name for f in self._gen_fields]
        self._arr_name = self.generator.child.name

    @property
    def output_schema(self) -> t.StructType:
        fields = [f for f in self.child.output_schema.fields
                  if f.name != self._arr_name]
        for f, n in zip(self._gen_fields, self.output_names):
            fields.append(t.StructField(n, f.data_type, f.nullable))
        return t.StructType(fields)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        gen = self.generator
        elem = gen.child.dtype.element_type
        out_names = list(self.output_schema.names)
        for db in self.child.execute(ctx):
            db = ensure_prefix(db, ctx.conf)
            col = db.column_by_name(self._arr_name)
            parent_src = db.select([i for i, n in enumerate(db.names)
                                    if n != self._arr_name])
            vcap = col.value_capacity
            rid = R.row_ids(col.offsets, vcap)
            live = R.value_live(col.offsets, vcap, db.num_rows)
            n_out = R._at(col.offsets, db.num_rows).to(torch.int32)
            safe_rid = torch.clamp(rid, 0, db.capacity - 1)
            parent = gather_batch(parent_src, torch.where(
                live, safe_rid, torch.full_like(safe_rid, -1)), n_out,
                null_out_of_bounds=True)
            out_cols = list(parent.columns)
            if gen.pos:
                pos = torch.arange(vcap, dtype=torch.int64,
                                   device=rid.device) - \
                    col.offsets.to(torch.int64)[safe_rid]
                out_cols.append(DeviceColumn(pos.to(torch.int32), live,
                                             t.INT))
            out_cols.append(DeviceColumn(col.data, col.elem_valid & live,
                                         elem, col.dictionary))
            yield DeviceBatch(out_cols, n_out, out_names)
            if gen.outer:
                # a null or empty array's row, once, with a null element
                off = col.offsets.to(torch.int64)
                empty = db.row_mask() & ((off[1:] == off[:-1]) |
                                         ~col.validity)
                dev = empty.device
                if parent_src.columns:
                    base = compact_batch(parent_src, empty, ctx.conf)
                    cap, n_empty = base.capacity, base.num_rows
                    extra = list(base.columns)
                else:
                    cap, extra = db.capacity, []
                    n_empty = empty.sum(dtype=torch.int32)
                if gen.pos:
                    extra.append(DeviceColumn(
                        torch.zeros(cap, dtype=torch.int32, device=dev),
                        torch.zeros(cap, dtype=torch.bool, device=dev),
                        t.INT))
                extra.append(DeviceColumn(
                    torch.zeros(cap, dtype=col.data.dtype, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev), elem,
                    col.dictionary))
                yield DeviceBatch(extra, n_empty, out_names)

    def describe(self):
        return f"GenerateExec[{self.generator!r}]"
