"""UDFs: the columnar device UDF and the row-at-a-time Python UDF.

Counterpart of spark_rapids_tpu/plan/udf.py (the reference's RapidsUDF
and row-based UDF roles, SURVEY §2.8).

  * **TpuUDF** — the user writes a function over torch tensors on the
    batch's device.  On the device engine it runs eagerly on the
    operator's input lanes like any other expression, and under
    whole-plan capture (exec/compiled.py) its ops are recorded into the
    plan's CUDA graph.  A function that reads a device value on the host
    (`.item()`, a boolean index) raises `runtime/capture.HostDecision`
    through the `SyncDetector` there, and the plan runs eagerly.  Null
    semantics: a row is null when any input row is null;
    `needs_validity=True` hands the function (data, validity) pairs
    instead, and it may return (data, validity).  The result is cast to
    the declared return type: the body is the user's torch code and
    follows torch's promotion rules (int64 / int64 is float32 there),
    while downstream lanes assume the declared type.  A DECIMAL input is
    its unscaled int64 lane, on both engines (ROADMAP Queue 3 item 17:
    the reference's CPU engine drops the fraction instead).
  * **PythonUDF** — any Python callable, row at a time on the CPU engine
    (exec/host_exec.py): arguments come as `HostColumn.to_pylist` gives
    them (pyarrow's Python types), results are built into a column of
    the declared type by `columnar/host.column_from_values`, which raises
    where pyarrow's `pa.array(values, type)` raises.

The function (TpuUDF) is pinned for the process's lifetime: the
fingerprint keys on its id, and the whole-plan cache (exec/compiled.py)
keys on the fingerprint, so a dropped function's recycled id must never
find another's graph.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import types as t
from ..columnar.host import HostColumn, column_from_values
from ..ops.kernels import compute_dtype, merge_validity
from .expressions import DevVal, Expression, HostVal


# Pins every UDF function (and hive UDF object) for the process lifetime
# so that id() in plan-cache keys never aliases a collected object's
# recycled address (the cache itself lives as long as the process).
_UDF_PIN: dict = {}

#: input and output types no tensor lane carries
_NO_LANE = (t.StringType, t.BinaryType, t.ArrayType, t.MapType,
            t.StructType)


def lane_reasons(children, return_type, what: str):
    """The reasons a columnar UDF (`what`) cannot take these inputs or
    give this output on the device."""
    out = [f"{what} over {c.dtype.simple_string} input (tensor lanes are "
           "numeric)" for c in children if isinstance(c.dtype, _NO_LANE)]
    if isinstance(return_type, (t.StringType, t.ArrayType, t.MapType,
                                t.StructType)):
        out.append(f"{what} returning {return_type.simple_string}")
    return out


def as_result(out, dtype: t.DataType, like: torch.Tensor, n: int
              ) -> torch.Tensor:
    """A UDF's data result as a lane of the declared type: cast to its
    compute dtype, a scalar broadcast to `n` rows."""
    data = torch.as_tensor(out, device=like.device)
    if data.dim() == 0:
        data = data.expand(n).contiguous()
    return data.to(compute_dtype(dtype))


def cpu_lanes(kids, children):
    """(data tensor, validity bool array) per input column on the CPU
    engine: the lanes the device engine hands the function (null rows
    0, a DECIMAL its unscaled int64 lane, a DATE int32 days)."""
    out = []
    for k, c in zip(kids, children):
        valid = k.valid_mask()
        if k.hi is not None and not np.array_equal(
                np.where(valid, k.hi, 0),
                np.where(valid, k.data.astype(np.int64) >> 63, 0)):
            raise NotImplementedError(
                f"a DECIMAL({c.dtype.precision}) value leaves int64: a "
                "columnar UDF takes one lane")
        data = np.where(valid, k.data, np.zeros((), k.data.dtype))
        out.append((torch.from_numpy(np.ascontiguousarray(data)),
                    valid))
    return out


def cpu_result(data, valid: np.ndarray, dtype: t.DataType) -> HostColumn:
    """A UDF's CPU-engine result tensor as a HostColumn of `dtype`."""
    lane = as_result(data, dtype, torch.empty(0), len(valid)).numpy()
    lane = lane.astype(t.physical_np_dtype(dtype), copy=False)
    valid = np.asarray(valid, bool)
    lane = np.where(valid, lane, np.zeros((), lane.dtype))
    return HostColumn(lane, None if valid.all() else valid, dtype)


class TpuUDF(Expression):
    """Columnar device UDF over torch tensors (the RapidsUDF analogue)."""

    def __init__(self, fn: Callable, return_type: t.DataType,
                 *args: Expression, name: str = None,
                 needs_validity: bool = False):
        self.children = tuple(args)
        self.fn = fn
        _UDF_PIN[id(fn)] = fn
        self.return_type = return_type
        self.udf_name = name or getattr(fn, "__name__", "udf")
        self.needs_validity = needs_validity

    def _resolve(self):
        self.dtype = self.return_type
        self.nullable = True

    def _fp_extra(self):
        # identity-keyed: each distinct function object is its own plan
        return f"{self.udf_name}@{id(self.fn)};{self.needs_validity}"

    def unsupported_reasons(self, conf):
        return lane_reasons(self.children, self.return_type, "TpuUDF")

    def _prepare(self, pctx, kids):
        return HostVal()

    def _call(self, datas, valids, like, n):
        """(data, validity) of the function over input lanes."""
        if self.needs_validity:
            out = self.fn(*zip(datas, valids))
            if isinstance(out, tuple):
                data, valid = out
            else:
                data, valid = out, merge_validity(*valids)
        else:
            data = self.fn(*datas)
            valid = merge_validity(*valids)
        return as_result(data, self.dtype, like, n), valid

    def _eval_dev(self, ctx, kids):
        like = kids[0].data if kids else ctx.full(0, torch.int64)
        valids = [k.validity for k in kids]
        if self.needs_validity:
            valids = [v if v is not None else torch.ones(
                ctx.capacity, dtype=torch.bool, device=ctx.device)
                for v in valids]
        data, valid = self._call([k.data for k in kids], valids, like,
                                 ctx.capacity)
        return DevVal(data, valid, self.dtype)

    def _eval_cpu(self, batch, kids):
        lanes = cpu_lanes(kids, self.children)
        n = batch.num_rows
        like = lanes[0][0] if lanes else torch.zeros(n, dtype=torch.int64)
        data, valid = self._call([d for d, _v in lanes],
                                 [torch.from_numpy(v) for _d, v in lanes],
                                 like, n)
        valid = np.ones(n, bool) if valid is None else \
            np.asarray(torch.as_tensor(valid).numpy(), bool)
        return cpu_result(data, valid, self.dtype)

    def __repr__(self):
        return f"{self.udf_name}({', '.join(map(repr, self.children))})"


class PythonUDF(Expression):
    """Row-at-a-time Python UDF: CPU engine only (the row-based host UDF
    contract, rowBasedHiveUDFs/GpuRowBasedUserDefinedFunction role)."""

    def __init__(self, fn: Callable, return_type: t.DataType,
                 *args: Expression, name: str = None,
                 null_safe: bool = True):
        self.children = tuple(args)
        self.fn = fn
        _UDF_PIN[id(fn)] = fn
        self.return_type = return_type
        self.udf_name = name or getattr(fn, "__name__", "py_udf")
        self.null_safe = null_safe     # any-null input -> null, fn skipped

    def _resolve(self):
        self.dtype = self.return_type
        self.nullable = True

    def _fp_extra(self):
        return f"{self.udf_name}@{id(self.fn)}"

    def unsupported_reasons(self, conf):
        return ["python UDFs run row-at-a-time on the CPU path"]

    def _eval_cpu(self, batch, kids):
        cols = [k.to_pylist() for k in kids]
        rows = zip(*cols) if cols else (() for _ in range(batch.num_rows))
        out = []
        for row in rows:
            if self.null_safe and any(v is None for v in row):
                out.append(None)
            else:
                out.append(self.fn(*row))
        return column_from_values(out, self.dtype)

    def __repr__(self):
        return f"{self.udf_name}({', '.join(map(repr, self.children))})"
