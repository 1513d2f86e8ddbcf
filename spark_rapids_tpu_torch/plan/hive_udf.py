"""Hive UDFs inside the columnar pipeline.

Counterpart of spark_rapids_tpu/plan/hive_udf.py.  The reference runs
hive UDFs in the columnar plan two ways:
  * `com.nvidia.spark.RapidsUDF` hive variants evaluate COLUMNAR on the
    device (hiveUDFs.scala GpuHiveSimpleUDF / GpuHiveGenericUDF when the
    UDF implements RapidsUDF);
  * plain hive UDFs run ROW-BASED ON THE HOST inside the columnar
    pipeline (rowBasedHiveUDFs.scala GpuRowBasedHiveSimpleUDF /
    GenericUDF): the batch becomes rows, the UDF evaluates each, the
    results become a column again.

Here a hive-style UDF is any object with an `evaluate(*args)` method
(the org.apache.hadoop.hive.ql.exec.UDF contract).  If it ALSO
implements `evaluate_columnar(*tensors)` (`TpuHiveUDF`, the RapidsUDF
analogue: torch tensors on the batch's device, the result cast to the
declared type as a TpuUDF's is), it is placed on the device; otherwise
it evaluates row-based on the CPU engine, with the reason in explain,
as the reference places it.  The CPU engine runs the row form of
either kind.  The UDF object is pinned for the process's
lifetime, as a TpuUDF's function is: the fingerprint keys on its id.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import types as t
from ..columnar.host import column_from_values
from ..ops.kernels import merge_validity
from .expressions import DevVal, Expression, HostVal
from .udf import _UDF_PIN, as_result, lane_reasons


class TpuHiveUDF:
    """User base class: the `com.nvidia.spark.RapidsUDF` analogue for
    hive-style UDFs.  Subclasses implement BOTH

      evaluate(*row_values) -> value             (hive row contract)
      evaluate_columnar(*tensors) -> tensor      (device lanes)

    and the planner places the columnar form on the device, keeping the
    row form for the CPU engine's reference."""

    def evaluate(self, *args):
        raise NotImplementedError

    def evaluate_columnar(self, *arrays):
        raise NotImplementedError


class HiveSimpleUDF(Expression):
    """hive `UDF`-contract expression: `udf.evaluate(*row_values)` per
    row, row-based on the host inside the columnar pipeline
    (rowBasedHiveUDFs.scala role); a TpuHiveUDF with a columnar form is
    placed on the device instead (hiveUDFs.scala RapidsUDF role)."""

    def __init__(self, udf, return_type: t.DataType, *args: Expression,
                 name: Optional[str] = None):
        self.children = tuple(args)
        self.udf = udf
        _UDF_PIN[id(udf)] = udf
        self.return_type = return_type
        self.udf_name = name or type(udf).__name__

    def _resolve(self):
        self.dtype = self.return_type
        self.nullable = True

    def _fp_extra(self):
        return f"{self.udf_name}@{id(self.udf)}"

    def _columnar(self) -> bool:
        return callable(getattr(self.udf, "evaluate_columnar", None)) \
            and not isinstance(
                getattr(type(self.udf), "evaluate_columnar", None),
                property) and \
            type(self.udf).evaluate_columnar is not \
            TpuHiveUDF.evaluate_columnar

    def unsupported_reasons(self, conf):
        if self._columnar():
            return lane_reasons(self.children, self.return_type,
                                "hive RapidsUDF")
        return [f"hive UDF {self.udf_name} is row-based — evaluates on "
                "host inside the columnar pipeline "
                "(rowBasedHiveUDFs.scala role)"]

    def _prepare(self, pctx, kids):
        return HostVal()

    def _eval_dev(self, ctx, kids):
        like = kids[0].data if kids else ctx.full(0, torch.int64)
        data = self.udf.evaluate_columnar(*[k.data for k in kids])
        return DevVal(as_result(data, self.dtype, like, ctx.capacity),
                      merge_validity(*[k.validity for k in kids]),
                      self.dtype)

    def _row_args(self, row):
        return row

    def _eval_cpu(self, batch, kids):
        # the row form, also for a TpuHiveUDF (the reference's CPU path)
        cols = [k.to_pylist() for k in kids]
        out = []
        for row in zip(*cols) if cols else [() for _ in
                                            range(batch.num_rows)]:
            try:
                out.append(self.udf.evaluate(*self._row_args(row)))
            except Exception as e:          # noqa: BLE001
                raise RuntimeError(
                    f"hive UDF {self.udf_name} failed: {e!r}") from e
        return column_from_values(out, self.dtype)

    def __repr__(self):
        return f"{self.udf_name}({', '.join(map(repr, self.children))})"


class HiveGenericUDF(HiveSimpleUDF):
    """hive GenericUDF contract: `evaluate(deferred_objects)` where each
    deferred object's .get() yields the argument (lazy evaluation —
    rowBasedHiveUDFs.scala GpuRowBasedHiveGenericUDF)."""

    class _Deferred:
        __slots__ = ("_v",)

        def __init__(self, v):
            self._v = v

        def get(self):
            return self._v

    def _row_args(self, row):
        return ([self._Deferred(v) for v in row],)
