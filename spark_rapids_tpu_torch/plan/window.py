"""Window function specs — the frame model of the window operator.

Counterpart of spark_rapids_tpu/plan/window.py, ported whole: the same
specs, frames, result types, support checks and analysis error, which
the JAX package and this port share as the plan-level contract.  A
window is a segmented scan or reduce over the partition-sorted batch
(ops/window.py): running frames are segmented prefix scans, unbounded
frames segment reductions read back at every row, bounded ROWS sums
prefix-sum differences and bounded min/max shift-stacks or a sparse
table.

Frames follow Spark semantics:
  * explicit ROWS BETWEEN a AND b — offsets relative to the current row
    (negative = preceding), None = unbounded in that direction;
  * explicit RANGE supports the UNBOUNDED/CURRENT-ROW shapes AND literal
    value offsets (RANGE BETWEEN x PRECEDING AND y FOLLOWING) over a
    single integer-lane order key — bounds found by a merge-rank sort
    per side, min/max answered from a sparse table;
  * default frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW when order keys
    exist (includes peer rows), else the whole partition.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .. import types as t
from ..config import TpuConf
from . import expressions as E


UNBOUNDED = None      # frame bound sentinel
CURRENT = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """kind: "rows" | "range"; lower/upper: int offset or None (unbounded).
    RANGE offsets are VALUE deltas on the single order key (0 = current
    peer group); ROWS offsets are row counts."""
    kind: str = "range"
    lower: Optional[int] = UNBOUNDED
    upper: Optional[int] = CURRENT

    def fp(self) -> str:
        return f"{self.kind}:{self.lower}:{self.upper}"

    @property
    def is_unbounded_both(self) -> bool:
        return self.lower is None and self.upper is None

    @property
    def is_running(self) -> bool:
        return self.lower is None and self.upper == 0

    @property
    def is_value_offset(self) -> bool:
        """RANGE frame with at least one literal value offset bound."""
        return self.kind == "range" and (
            self.lower not in (None, 0) or self.upper not in (None, 0))


def default_frame(has_order: bool) -> WindowFrame:
    return WindowFrame("range", UNBOUNDED, CURRENT if has_order else UNBOUNDED)


# Shift-stack bound for bounded-frame min/max (each offset is one shifted
# candidate lane at trace time; beyond this the program gets too large).
MINMAX_FRAME_CAP = 256


class WindowFunctionSpec:
    """Base window function.  Subclasses declare their input expression
    (or None), result type, and the kernel kind ops/window.py dispatches on."""
    name = "window_fn"
    kind = None                  # ops/window.py dispatch tag
    needs_order = False

    def __init__(self, child: Optional[E.Expression] = None,
                 frame: Optional[WindowFrame] = None):
        self.child = child
        self.frame = frame       # None -> default frame at exec time

    def bind(self, schema: t.StructType) -> "WindowFunctionSpec":
        import copy
        b = copy.copy(self)
        if self.child is not None:
            b.child = self.child.bind(schema)
        b._resolve()
        return b

    def _resolve(self):
        self.dtype = self.result_type(None)

    def result_type(self, schema) -> t.DataType:
        raise NotImplementedError

    def inputs(self) -> List[E.Expression]:
        return [] if self.child is None else [self.child]

    def fingerprint(self) -> str:
        fr = self.frame.fp() if self.frame is not None else "default"
        kid = self.child.fingerprint() if self.child is not None else ""
        return f"{type(self).__name__}({self._fp_extra()};{fr};{kid})"

    def _fp_extra(self) -> str:
        return ""

    def unsupported_reasons(self, conf: TpuConf) -> List[str]:
        out = []
        if self.child is not None:
            out += self.child.tree_unsupported(conf)
            if isinstance(self.child.dtype, (t.ArrayType, t.StructType,
                                             t.MapType, t.BinaryType)):
                out.append(f"{self.name} over "
                           f"{self.child.dtype.simple_string}")
        if self.frame is not None:
            f = self.frame
            # value-offset RANGE frames are supported on device (merge-
            # rank bounds over the single int-lane order key); the
            # order-key shape check lives in WindowMeta, which sees the
            # order keys
            if f.lower is not None and f.upper is not None and \
                    f.lower > f.upper:
                out.append("frame lower bound above upper bound")
        return out

    def __repr__(self):
        return self.fingerprint()


# ---------------------------------------------------------------------------
# Ranking family (frame-less; operate on partition/peer structure)
# ---------------------------------------------------------------------------

class RowNumber(WindowFunctionSpec):
    name = "row_number"
    kind = "row_number"
    needs_order = True

    def result_type(self, schema):
        return t.INT


class Rank(WindowFunctionSpec):
    name = "rank"
    kind = "rank"
    needs_order = True

    def result_type(self, schema):
        return t.INT


class DenseRank(WindowFunctionSpec):
    name = "dense_rank"
    kind = "dense_rank"
    needs_order = True

    def result_type(self, schema):
        return t.INT


class PercentRank(WindowFunctionSpec):
    name = "percent_rank"
    kind = "percent_rank"
    needs_order = True

    def result_type(self, schema):
        return t.DOUBLE


class CumeDist(WindowFunctionSpec):
    name = "cume_dist"
    kind = "cume_dist"
    needs_order = True

    def result_type(self, schema):
        return t.DOUBLE


class NTile(WindowFunctionSpec):
    name = "ntile"
    kind = "ntile"
    needs_order = True

    def __init__(self, n: int):
        super().__init__(None)
        assert n >= 1
        self.n = n

    def _fp_extra(self):
        return str(self.n)

    def result_type(self, schema):
        return t.INT


# ---------------------------------------------------------------------------
# Offset family
# ---------------------------------------------------------------------------

class Lead(WindowFunctionSpec):
    """lead(expr, offset, default) — value `offset` rows after the current
    row within the partition, `default` (literal) outside it."""
    name = "lead"
    kind = "lead"
    needs_order = True
    _sign = 1

    def __init__(self, child: E.Expression, offset: int = 1, default=None):
        super().__init__(child)
        self.offset = offset
        self.default = default       # python literal or None

    def _fp_extra(self):
        return f"{self.offset};{self.default!r}"

    def result_type(self, schema):
        return self.child.dtype

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        if self.default is not None and \
                isinstance(self.child.dtype, (t.StringType, t.BinaryType)):
            out.append(f"{self.name} default value over "
                       f"{self.child.dtype.simple_string}")
        return out


class Lag(Lead):
    name = "lag"
    kind = "lag"
    _sign = -1


# ---------------------------------------------------------------------------
# Aggregates over frames
# ---------------------------------------------------------------------------

def _win_sum_type(dt: t.DataType) -> t.DataType:
    if t.is_integral(dt):
        return t.LONG
    if isinstance(dt, (t.FloatType, t.DoubleType)):
        return t.DOUBLE
    if isinstance(dt, t.DecimalType):
        return t.DecimalType(min(38, dt.precision + 10), dt.scale)
    raise TypeError(f"window sum over {dt.simple_string}")


class WinSum(WindowFunctionSpec):
    name = "sum"
    kind = "agg_sum"

    def result_type(self, schema):
        return _win_sum_type(self.child.dtype)

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        dt = self.child.dtype
        if not (t.is_numeric(dt) or isinstance(dt, t.DecimalType)):
            out.append(f"sum over {dt.simple_string}")
        elif isinstance(dt, t.DecimalType) and \
                _win_sum_type(dt).is_wide:
            out.append("window sum result beyond decimal(18) "
                       "not yet on device")
        return out


class WinCount(WindowFunctionSpec):
    """count(expr) over frame; child None = count(*)/count(1)."""
    name = "count"
    kind = "agg_count"

    def result_type(self, schema):
        return t.LONG


class WinMin(WindowFunctionSpec):
    name = "min"
    kind = "agg_min"

    def result_type(self, schema):
        return self.child.dtype

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        f = self.frame
        if f is not None and f.kind == "rows" and f.lower is not None \
                and f.upper is not None and \
                (f.upper - f.lower + 1) > MINMAX_FRAME_CAP:
            out.append(f"bounded min/max frame wider than {MINMAX_FRAME_CAP}")
        if isinstance(self.child.dtype, (t.StringType, t.BinaryType)):
            out.append(f"window {self.name} over "
                       f"{self.child.dtype.simple_string} (dictionary codes "
                       "are not value-ordered)")
        return out


class WinMax(WinMin):
    name = "max"
    kind = "agg_max"


class WinAverage(WindowFunctionSpec):
    name = "avg"
    kind = "agg_avg"

    def result_type(self, schema):
        dt = self.child.dtype
        if isinstance(dt, t.DecimalType):
            return t.DecimalType(min(38, dt.precision + 4),
                                 min(38, dt.scale + 4))
        return t.DOUBLE

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        dt = self.child.dtype
        if not (t.is_numeric(dt) or isinstance(dt, t.DecimalType)):
            out.append(f"avg over {dt.simple_string}")
        elif isinstance(dt, t.DecimalType) and self.result_type(None).is_wide:
            out.append("window avg result beyond decimal(18) "
                       "not yet on device")
        return out


class FirstValue(WindowFunctionSpec):
    """first_value(expr) — value at the frame's first row
    (ignoreNulls=False semantics)."""
    name = "first_value"
    kind = "first_value"

    def result_type(self, schema):
        return self.child.dtype


class LastValue(FirstValue):
    name = "last_value"
    kind = "last_value"


RANKING = (RowNumber, Rank, DenseRank, PercentRank, CumeDist, NTile)
OFFSET = (Lead, Lag)
FRAMED = (WinSum, WinCount, WinMin, WinMax, WinAverage, FirstValue, LastValue)


class WindowAnalysisError(ValueError):
    """Spark AnalysisException analogue for invalid window definitions."""


def check_window_analysis(window_exprs, order_keys) -> None:
    """Structural checks every backend shares (raise, don't fall back —
    Spark rejects these at analysis time)."""
    for spec, _name in window_exprs:
        if spec.needs_order and not order_keys:
            raise WindowAnalysisError(
                f"window function {spec.name}() requires a window "
                "ORDER BY")
