"""WindowExec: partition-sorted window evaluation.

Counterpart of spark_rapids_tpu/exec/window.py.  The exec

  1. concatenates the child stream into one batch (a window needs whole
     partitions; string columns' per-batch dictionaries unify there),
  2. projects the partition keys, order keys and function inputs as
     appended internal columns in one projection,
  3. sorts by (partition keys ascending nulls first, order keys)
     (ops/sort.sort_batch),
  4. runs the window program (ops/window.window_trace) over the sorted
     lanes and emits the child columns and the window outputs in sorted
     order, as Spark's WindowExec does.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn, storage_dtype
from ..ops.batch_ops import concat_batches
from ..ops.sort import SortKey, sort_batch
from ..ops.window import window_trace
from ..plan import expressions as E
from ..plan.window import WindowFrame, WindowFunctionSpec, default_frame
from .evaluator import evaluate_projection
from .plan import ExecContext, PlanNode

_STRUCTURAL = ("row_number", "rank", "dense_rank", "percent_rank",
               "cume_dist", "ntile", "lead", "lag")


class WindowExec(PlanNode):
    """window_exprs: (WindowFunctionSpec, out_name) pairs.
    partition_keys: expressions; order_keys: (expr, asc, nulls_first)."""

    def __init__(self, window_exprs: Sequence[Tuple[WindowFunctionSpec, str]],
                 partition_keys: Sequence[E.Expression],
                 order_keys: Sequence[Tuple[E.Expression, bool, bool]],
                 child: PlanNode):
        from ..plan.window import check_window_analysis
        super().__init__(child)
        check_window_analysis(window_exprs, order_keys)
        schema = child.output_schema
        self.window_exprs = [(spec.bind(schema), name)
                             for spec, name in window_exprs]
        self.partition_keys = [e.bind(schema) for e in partition_keys]
        self.order_keys = [(e.bind(schema), asc, nf)
                           for e, asc, nf in order_keys]

    @property
    def output_schema(self) -> t.StructType:
        fields = list(self.child.output_schema.fields)
        for spec, name in self.window_exprs:
            fields.append(t.StructField(name, spec.dtype))
        return t.StructType(fields)

    def column_range(self, name):
        # the child's columns pass through (permuted)
        if name in self.child.output_schema.names:
            return self.child.column_range(name)
        return None

    def _resolved_frame(self, spec: WindowFunctionSpec) -> WindowFrame:
        if spec.frame is not None:
            return spec.frame
        if spec.kind in _STRUCTURAL:
            return WindowFrame("range", None, None)   # structural; unused
        return default_frame(bool(self.order_keys))

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        batches = [db for db in self.child.execute(ctx)
                   if int(db.num_rows) > 0]
        if not batches:
            return
        db = concat_batches(batches, ctx.conf)
        del batches
        child_names = list(db.names)
        n_child = len(child_names)

        # --- 2. append internal key/input columns via one projection ---
        aug_exprs: List[E.Expression] = [
            E.ColumnRef(n).bind(db.schema) for n in child_names]
        aug_names = list(child_names)
        p_idx, o_idx, v_idx = [], [], []
        for i, e in enumerate(self.partition_keys):
            aug_exprs.append(e)
            aug_names.append(f"__w_p{i}")
            p_idx.append(len(aug_exprs) - 1)
        for i, (e, _a, _nf) in enumerate(self.order_keys):
            aug_exprs.append(e)
            aug_names.append(f"__w_o{i}")
            o_idx.append(len(aug_exprs) - 1)
        spec_input_idx: List[int] = []
        n_inputs = 0
        for spec, _name in self.window_exprs:
            if spec.child is None:
                spec_input_idx.append(-1)
                continue
            aug_exprs.append(spec.child)
            aug_names.append(f"__w_v{n_inputs}")
            v_idx.append(len(aug_exprs) - 1)
            spec_input_idx.append(n_inputs)
            n_inputs += 1
        aug = evaluate_projection(aug_exprs, aug_names, db, ctx.conf)
        del db
        # keys and inputs are read as one int64 lane; the child's own
        # columns pass through with their high words
        for i in p_idx + o_idx + v_idx:
            c = aug.columns[i]
            dv = E.narrow_dev(E.DevVal(c.data, c.validity, c.dtype,
                                       hi=c.hi), "WindowExec")
            aug.columns[i] = DeviceColumn(dv.data, c.validity, c.dtype,
                                          c.dictionary, c.value_range)

        # --- 3. sort by (partition, order) ---
        sort_keys = [SortKey(i, True, True) for i in p_idx]
        sort_keys += [SortKey(i, asc, nf) for i, (_e, asc, nf)
                      in zip(o_idx, self.order_keys)]
        s = sort_batch(aug, sort_keys, ctx.conf) if sort_keys else aug
        del aug

        # --- 4. the window program ---
        specs_frames = [(spec, self._resolved_frame(spec), vi)
                        for (spec, _n), vi in zip(self.window_exprs,
                                                  spec_input_idx)]
        part_cols = [s.columns[i] for i in p_idx]
        order_cols = [s.columns[i] for i in o_idx]
        val_cols = [s.columns[i] for i in v_idx]
        order_dirs = tuple((asc, nf) for _e, asc, nf in self.order_keys)
        fn = window_trace(
            tuple((c.dtype,) for c in part_cols),
            tuple((c.dtype,) for c in order_cols),
            tuple((c.dtype,) for c in val_cols),
            specs_frames, s.capacity, order_dirs=order_dirs)
        outs = fn(tuple(c.data for c in part_cols),
                  tuple(c.validity for c in part_cols),
                  tuple(c.data for c in order_cols),
                  tuple(c.validity for c in order_cols),
                  tuple(c.data for c in val_cols),
                  tuple(c.validity for c in val_cols),
                  s.row_mask())

        cols = list(s.columns[:n_child])
        names = list(child_names)
        for (spec, name), vi, (data, valid) in zip(self.window_exprs,
                                                   spec_input_idx, outs):
            dictionary = None
            if isinstance(spec.dtype, t.StringType) and vi >= 0:
                # value pass-through functions keep the input dictionary
                dictionary = val_cols[vi].dictionary
            cols.append(DeviceColumn(data.to(storage_dtype(spec.dtype)),
                                     valid, spec.dtype, dictionary))
            names.append(name)
        yield DeviceBatch(cols, s.num_rows, names)

