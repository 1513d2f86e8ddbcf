"""The port's window operator (plan/window.py, ops/window.py,
exec/window.py) against the JAX package's WindowExec on the CPU (its
device path, run by XLA on the host), on the same input, split into
several batches.

Here every function and frame shape of plan/window.py, with nulls in
the partition and order keys and NaN and ±0.0 in the DOUBLE values;
tests/test_torch_window_edges.py takes NaN and ±0.0 in a DOUBLE order
key, DESC order, RANGE offsets near the int64 extremes, one-row
partitions, no partition keys, and string partition keys whose batches
carry different dictionaries, with the helpers of this file.  Integers,
decimals, strings and ranks compare exactly; DOUBLE results (sums, averages, ranks' ratios)
within rtol 1e-12 — a running or whole-partition sum adds in the
reference's 512-row blocked order (ops/segments), a bounded ROWS sum is
a difference of prefix sums in the reference's blocked order
(ops/kernels.blocked_cumsum), so at these sizes they are bit-equal, but
the tolerance is the README's f64 one.
"""
import decimal as pydec
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.exec.plan import ExecContext as JCtx
from spark_rapids_tpu.exec.plan import HostScanExec as JScan
from spark_rapids_tpu.exec.plan import UnionExec as JUnion
from spark_rapids_tpu.exec.window import WindowExec as JWindow
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import window as JW
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.exec.plan import HostScanExec as PScan
from spark_rapids_tpu_torch.exec.plan import UnionExec as PUnion
from spark_rapids_tpu_torch.exec.window import WindowExec as PWindow
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import window as PW
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)


def _dec(cents, mask=None):
    """decimal(7,2) from integer cents (None where `mask`)."""
    mask = np.zeros(len(cents), bool) if mask is None else mask
    return pa.array([None if k else pydec.Decimal(int(x)).scaleb(-2)
                     for x, k in zip(cents, mask)], pa.decimal128(7, 2))


def make_table(n=600, seed=7):
    """g: INT partition key, o: LONG order key, both with nulls; v:
    DOUBLE with nulls, NaN and ±0.0; i: LONG; m: decimal(7,2) with
    nulls; s: STRING."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 13, n)
    gnull = rng.random(n) < 0.05
    o = rng.integers(0, 50, n)
    onull = rng.random(n) < 0.08
    v = rng.integers(-1000, 1000, n).astype(np.float64)
    v[rng.random(n) < 0.04] = np.nan
    v[rng.random(n) < 0.04] = -0.0
    v[rng.random(n) < 0.04] = 0.0
    vnull = rng.random(n) < 0.12
    m = rng.integers(-99999, 99999, n)
    mnull = rng.random(n) < 0.1
    return pa.table({
        "g": pa.array(g, pa.int32(), mask=gnull),
        "o": pa.array(o, pa.int64(), mask=onull),
        "v": pa.array(v, pa.float64(), mask=vnull),
        "i": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "m": _dec(m, mnull),
        "s": pa.array([f"s{x}" for x in rng.integers(0, 9, n)]),
    })


def _specs(W, E, names, frame_args=None):
    """(spec, name) pairs of one package; `frame_args` (kind, lo, hi)."""
    c = E.ColumnRef
    fr = None if frame_args is None else W.WindowFrame(*frame_args)
    make = {
        "row_number": lambda: W.RowNumber(),
        "rank": lambda: W.Rank(),
        "dense_rank": lambda: W.DenseRank(),
        "percent_rank": lambda: W.PercentRank(),
        "cume_dist": lambda: W.CumeDist(),
        "ntile3": lambda: W.NTile(3),
        "ntile40": lambda: W.NTile(40),
        "lead_v": lambda: W.Lead(c("v")),
        "lead_i2": lambda: W.Lead(c("i"), 2, -1),
        "lag_v": lambda: W.Lag(c("v"), 1, 0.5),
        "lag_s": lambda: W.Lag(c("s"), 2),
        "lag_i3": lambda: W.Lag(c("i"), 3, 7),
        "first_v": lambda: W.FirstValue(c("v"), fr),
        "last_i": lambda: W.LastValue(c("i"), fr),
        "last_s": lambda: W.LastValue(c("s"), fr),
        "sum_v": lambda: W.WinSum(c("v"), fr),
        "sum_i": lambda: W.WinSum(c("i"), fr),
        "sum_m": lambda: W.WinSum(c("m"), fr),
        "count_all": lambda: W.WinCount(None, fr),
        "count_v": lambda: W.WinCount(c("v"), fr),
        "min_v": lambda: W.WinMin(c("v"), fr),
        "max_v": lambda: W.WinMax(c("v"), fr),
        "min_i": lambda: W.WinMin(c("i"), fr),
        "max_m": lambda: W.WinMax(c("m"), fr),
        "avg_v": lambda: W.WinAverage(c("v"), fr),
        "avg_i": lambda: W.WinAverage(c("i"), fr),
        "avg_m": lambda: W.WinAverage(c("m"), fr),
    }
    return [(make[n](), n) for n in names]


RANKING = ["row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
           "ntile3", "ntile40", "lead_v", "lead_i2", "lag_v", "lag_s",
           "lag_i3"]
FRAMED = ["first_v", "last_i", "last_s", "sum_v", "sum_i", "sum_m",
          "count_all", "count_v", "min_v", "max_v", "min_i", "max_m",
          "avg_v", "avg_i", "avg_m"]


def _run(tables, names, parts, orders, frame_args=None, max_rows=128):
    """(port rows, reference rows) of one window over `tables` (a union
    of their scans when there are several)."""
    if isinstance(tables, pa.Table):
        tables = [tables]
    jscans = [JScan.from_table(t, max_rows=max_rows) for t in tables]
    pscans = [PScan(from_arrow(t), max_rows) for t in tables]
    jchild = jscans[0] if len(jscans) == 1 else JUnion(*jscans)
    pchild = pscans[0] if len(pscans) == 1 else PUnion(*pscans)
    want = JWindow(_specs(JW, JE, names, frame_args),
                   [JE.ColumnRef(p) for p in parts],
                   [(JE.ColumnRef(k), a, nf) for k, a, nf in orders],
                   jchild).collect(JCtx()).to_pydict()
    got = PWindow(_specs(PW, PE, names, frame_args),
                  [PE.ColumnRef(p) for p in parts],
                  [(PE.ColumnRef(k), a, nf) for k, a, nf in orders],
                  pchild).collect(PCtx(device="cpu")).to_pydict()
    return got, want


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) and \
            math.copysign(1, a) == math.copysign(1, b)
    return a == b and type(a) is type(b)


def assert_window_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(got[name],
                                                        want[name]))
               if not _same(a, b)]
        assert len(got[name]) == len(want[name]) and not bad, \
            (name, bad[:5])


ORDERS = [("o", True, True), ("i", True, True)]


def test_ranking_and_offset_functions():
    assert_window_equal(*_run(make_table(), RANKING, ["g"], ORDERS))


def test_framed_functions_under_the_default_frames():
    t = make_table()
    # ordered: RANGE UNBOUNDED PRECEDING .. CURRENT ROW (peers included)
    assert_window_equal(*_run(t, FRAMED, ["g"], [("o", True, True)]))
    # unordered: the whole partition
    assert_window_equal(*_run(t, FRAMED, ["g"], []))


@pytest.mark.parametrize("frame", [
    ("rows", None, 0), ("rows", -2, 1), ("rows", None, 3),
    ("rows", -3, None), ("rows", 0, 0), ("rows", 2, 5), ("rows", -4, -1),
    ("range", None, None), ("range", 0, None), ("range", 0, 0),
    ("range", -10, 5), ("range", None, 7), ("range", -5, None),
    ("range", 3, 10)])
def test_framed_functions_over_each_frame_shape(frame):
    assert_window_equal(*_run(make_table(), FRAMED, ["g"],
                              [("o", True, True)], frame))
