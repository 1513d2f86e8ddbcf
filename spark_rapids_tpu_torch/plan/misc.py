"""The nondeterministic and provenance expressions:
monotonically_increasing_id, spark_partition_id and input_file_name.

Counterpart of spark_rapids_tpu/plan/misc.py (the reference's
GpuMonotonicallyIncreasingID, GpuSparkPartitionID and GpuInputFileName
roles).  The engine's unit of work is the batch where Spark's is the
partition, so the partition-indexed expressions read the batch ordinal,
counted per execution as each batch is prepared: ids are
`(batch_ordinal << 33) | row`, unique and increasing, Spark's
`(partitionId << 33) | rowInPartition` shape.  The ordinal reaches the
device through `runtime/capture.host_constant`, so a captured graph
copies it from its staged host buffer on every replay and is never
built around a baked argument.

input_file_name reads the batch's scan provenance: a device batch's
`origin_file`, which the file scans set (io/parquet.py, io/text.py) and
projections, filters and concatenations carry; on the CPU engine the
file the scan last set (`set_current_input_file`), which the
materializing CPU operators clear.  A source without files gives ""
(Spark's answer), and so does a batch stitched from several files.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .. import types as t
from ..columnar.host import HostColumn
from ..runtime.capture import host_constant
from .expressions import DevVal, Expression, HostVal


# CPU-engine provenance: the scan execs record the current file here;
# within a query the host operators are sequential generators, so the
# file set before a batch is yielded is the batch's
_TL = threading.local()


def set_current_input_file(path: str) -> None:
    _TL.current = path or ""


def current_input_file() -> str:
    return getattr(_TL, "current", "")


class _BatchOrdinal(Expression):
    """Base: counts the batches this (bound) expression prepared since
    its operator last started (`reset_ordinals`)."""
    _batch_no = -1

    def _next_ordinal(self) -> int:
        self._batch_no += 1
        return self._batch_no

    def _prepare(self, pctx, kids):
        self._ordinal = self._next_ordinal()
        return HostVal()


def reset_ordinals(exprs: Sequence[Expression]) -> None:
    """Start the batch count of every ordinal expression in `exprs` again
    (an operator's execution begins: each run counts from batch 0)."""
    stack = list(exprs)
    while stack:
        e = stack.pop()
        if isinstance(e, _BatchOrdinal):
            e._batch_no = -1
        stack.extend(e.children)


class MonotonicallyIncreasingID(_BatchOrdinal):
    """A unique, increasing LONG per row."""

    def __init__(self):
        self.children = ()

    def _resolve(self):
        self.dtype = t.LONG
        self.nullable = False

    def _eval_dev(self, ctx, kids):
        base = host_constant(np.array([self._ordinal << 33], np.int64),
                             ctx.device)
        data = base + torch.arange(ctx.capacity, dtype=torch.int64,
                                   device=ctx.device)
        return DevVal(data, None, t.LONG)

    def _eval_cpu(self, batch, kids):
        base = self._next_ordinal() << 33
        return HostColumn(np.arange(batch.num_rows, dtype=np.int64) + base,
                          None, t.LONG)

    def _fp_extra(self):
        return "mid"


class SparkPartitionID(_BatchOrdinal):
    """The batch ordinal (the engine's partition)."""

    def __init__(self):
        self.children = ()

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = False

    def _eval_dev(self, ctx, kids):
        pid = host_constant(np.array([self._ordinal], np.int32), ctx.device)
        data = torch.zeros(ctx.capacity, dtype=torch.int32,
                           device=ctx.device) + pid
        return DevVal(data, None, t.INT)

    def _eval_cpu(self, batch, kids):
        return HostColumn(np.full(batch.num_rows, self._next_ordinal(),
                                  np.int32), None, t.INT)

    def _fp_extra(self):
        return "pid"


class InputFileName(Expression):
    """Scan provenance of the current batch; "" when unknown.  The file
    is the output's one-entry dictionary (the codes are all 0), so the
    device work holds nothing file-specific."""

    def __init__(self):
        self.children = ()

    def _resolve(self):
        self.dtype = t.STRING
        self.nullable = False

    def _prepare(self, pctx, kids):
        batch = getattr(pctx, "batch", None)
        return HostVal(np.array([str(getattr(batch, "origin_file", "")
                                     or "")], str))

    def _eval_dev(self, ctx, kids):
        codes = torch.zeros(ctx.capacity, dtype=torch.int32,
                            device=ctx.device)
        return DevVal(codes, None, t.STRING, np.array([""], str))

    def _eval_cpu(self, batch, kids):
        return HostColumn(np.zeros(batch.num_rows, np.int32), None,
                          t.STRING, np.array([current_input_file()], str))

    def _fp_extra(self):
        return "ifn"
