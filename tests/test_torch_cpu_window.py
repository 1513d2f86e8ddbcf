"""The port's CPU window operator (exec/host_exec.CpuWindowExec, numpy)
against the reference's CpuWindowExec (pandas) on the same input, and
the placement that sends a window there.

Every function and frame shape of tests/test_torch_window.py runs on
both CPU operators, the input split into 128-row batches.  Where the
two differ by design (README, "The CPU engine"), the port is held to
Spark's answer, computed here row by row from each frame's rows:

  * a DOUBLE sum or average over a frame: the reference's prefix sums
    carry a NaN or an infinity into every later frame of the table; the
    port counts a frame's NaN and infinities apart;
  * a DECIMAL average is exact, HALF_UP at the result scale (the
    reference computes through float64); a DECIMAL sum past 2^53 stays
    exact;
  * MIN and MAX of DOUBLE order -0.0 below 0.0 (Java's order, as the
    device path and the group-by do).

Integers, decimals and strings compare exactly, DOUBLE within the
rtol 1e-12 of tests/test_torch_window.py (`_same`).
"""
import decimal as pydec
import math

import numpy as np
import pyarrow as pa
import pytest

import test_torch_window as TW
from spark_rapids_tpu.exec import host_exec as JH
from spark_rapids_tpu.exec.plan import ExecContext as JCtx
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import window as JW
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.exec import host_exec as PH
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import window as PW
from spark_rapids_tpu_torch.session import TpuSession as PSession
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

#: columns held to Spark's answer (`_spark_frame_values`), not to the
#: reference's CpuWindowExec
DEVIATING = ("sum_v", "avg_v", "avg_m", "min_v", "max_v")


def _both(table, names, parts, orders, frame_args=None):
    """(port rows, reference rows) of one CPU window."""
    want = JH.CpuWindowExec(
        TW._specs(JW, JE, names, frame_args),
        [JE.ColumnRef(p) for p in parts],
        [(JE.ColumnRef(k), a, nf) for k, a, nf in orders],
        JH.HostSourceExec(table, 128)).collect(JCtx()).to_pydict()
    got = PH.CpuWindowExec(
        TW._specs(PW, PE, names, frame_args),
        [PE.ColumnRef(p) for p in parts],
        [(PE.ColumnRef(k), a, nf) for k, a, nf in orders],
        PH.HostSourceExec(from_arrow(table), 128)).collect(
            PCtx(device="cpu")).to_pydict()
    return got, want


def _frame_rows(rows, i, parts, order, frame):
    """Indices of row i's frame among the sorted `rows` (dicts), by
    Spark's rules: the partition, then ROWS offsets, RANGE peers or
    RANGE value offsets (a null order value frames its null peers)."""
    part = [j for j in range(len(rows))
            if all(rows[j][p] == rows[i][p] for p in parts)]
    if frame is None:
        kind, lo, hi = ("range", None, 0) if order else ("range", None, None)
    else:
        kind, lo, hi = frame
    pos = part.index(i)
    if kind == "rows":
        a = 0 if lo is None else max(0, pos + lo)
        b = len(part) - 1 if hi is None else min(len(part) - 1, pos + hi)
        return part[a:b + 1]
    x = rows[i][order] if order else None
    if lo in (None, 0) and hi in (None, 0):
        # CURRENT ROW and UNBOUNDED: the peer group's edges
        peers = [k for k, j in enumerate(part)
                 if order is None or rows[j][order] == x]
        a = 0 if lo is None else peers[0]
        b = len(part) - 1 if hi is None else peers[-1]
        return part[a:b + 1]
    # value offsets: a null order value frames its null peers only
    return [j for j in part
            if (x is None and rows[j][order] is None) or
            (x is not None and rows[j][order] is not None and
             (lo is None or rows[j][order] >= x + lo) and
             (hi is None or rows[j][order] <= x + hi))]


def _spark_frame_values(got, parts, order, frame):
    """{column: Spark's value per row} of the DEVIATING columns, from the
    sorted output rows themselves."""
    n = len(got["g"])
    rows = [{k: got[k][i] for k in ("g", "o", "v", "m")} for i in range(n)]
    out = {c: [] for c in DEVIATING}
    q = pydec.Decimal("0.000001")
    for i in range(n):
        fr = _frame_rows(rows, i, parts, order, frame)
        vs = [rows[j]["v"] for j in fr if rows[j]["v"] is not None]
        ms = [rows[j]["m"] for j in fr if rows[j]["m"] is not None]
        s = math.fsum(vs) if not any(map(math.isnan, vs)) else math.nan
        if any(v == math.inf for v in vs) and \
                any(v == -math.inf for v in vs):
            s = math.nan
        out["sum_v"].append(s if vs else None)
        out["avg_v"].append(s / len(vs) if vs else None)
        out["avg_m"].append((sum(ms) / len(ms)).quantize(
            q, rounding=pydec.ROUND_HALF_UP) if ms else None)
        java = sorted(vs, key=lambda v: (math.isnan(v), v,
                                         math.copysign(1, v)))
        out["min_v"].append(java[0] if vs else None)
        out["max_v"].append(java[-1] if vs else None)
    return out


def _check(got, want, parts, order, frame):
    TW.assert_window_equal({k: v for k, v in got.items()
                            if k not in DEVIATING},
                           {k: v for k, v in want.items()
                            if k not in DEVIATING})
    spark = _spark_frame_values(got, parts, order, frame)
    for name in DEVIATING:
        if name in got:
            bad = [(i, a, b) for i, (a, b) in enumerate(zip(got[name],
                                                            spark[name]))
                   if not TW._same(a, b)]
            assert not bad, (name, bad[:5])


def test_cpu_window_ranking_and_offsets_equal_the_reference():
    got, want = _both(TW.make_table(), TW.RANKING, ["g"], TW.ORDERS)
    TW.assert_window_equal(got, want)


@pytest.mark.parametrize("ordered", [True, False],
                         ids=["ordered", "unordered"])
def test_cpu_window_default_frames(ordered):
    orders = [("o", True, True)] if ordered else []
    got, want = _both(TW.make_table(), TW.FRAMED, ["g"], orders)
    _check(got, want, ["g"], "o" if ordered else None, None)


@pytest.mark.parametrize("frame", [
    ("rows", None, 0), ("rows", -2, 1), ("rows", None, 3),
    ("rows", -3, None), ("rows", 0, 0), ("rows", 2, 5), ("rows", -4, -1),
    ("range", None, None), ("range", 0, None), ("range", 0, 0),
    ("range", -10, 5), ("range", -5, None), ("range", 3, 10)])
def test_cpu_window_each_frame_shape(frame):
    got, want = _both(TW.make_table(), TW.FRAMED, ["g"],
                      [("o", True, True)], frame)
    _check(got, want, ["g"], "o", frame)


def test_cpu_window_descending_and_string_keys():
    t = TW.make_table(n=300, seed=11)
    got, want = _both(t, TW.RANKING + ["count_all", "min_i", "last_s"],
                      ["s"], [("o", False, False), ("i", False, True)])
    TW.assert_window_equal(got, want)


def _wide_table():
    # cents near 2^60: float64 holds them only to about 100 cents
    big = 2 ** 60
    vals = [big + 1, big + 3, None, -big - 7, big + 11, 5, big + 13,
            big + 17]
    return pa.table({
        "g": pa.array([1, 1, 1, 2, 2, 2, 1, 2], pa.int32()),
        "o": pa.array([1, 2, 3, 1, 2, 3, 4, 4], pa.int64()),
        "m": pa.array([None if v is None else pydec.Decimal(v).scaleb(-2)
                       for v in vals], pa.decimal128(20, 2))})


def test_decimal_window_sums_and_averages_are_exact():
    # README deviation: the reference's CpuWindowExec sums and averages
    # a DECIMAL through float64; the port's is exact, as Spark's
    table = _wide_table()
    specs = [(PW.WinSum(PE.ColumnRef("m")), "s"),
             (PW.WinAverage(PE.ColumnRef("m")), "a"),
             (PW.WinMax(PE.ColumnRef("m")), "mx")]
    got = PH.CpuWindowExec(
        specs, [PE.ColumnRef("g")], [(PE.ColumnRef("o"), True, True)],
        PH.HostSourceExec(from_arrow(table), 3)).collect(
            PCtx(device="cpu")).to_pydict()
    want_s, want_a, want_mx = [], [], []
    for g in (1, 2):
        run = []
        for o, m in sorted((o, m) for gg, o, m in zip(
                *[table[c].to_pylist() for c in ("g", "o", "m")])
                if gg == g):
            if m is not None:
                run.append(m)
            want_s.append(sum(run))
            want_a.append((sum(run) / len(run)).quantize(
                pydec.Decimal("0.000001"), rounding=pydec.ROUND_HALF_UP))
            want_mx.append(max(run))
    assert got["s"] == want_s
    assert got["a"] == want_a
    assert got["mx"] == want_mx
    ref = JH.CpuWindowExec(
        [(JW.WinSum(JE.ColumnRef("m")), "s")], [JE.ColumnRef("g")],
        [(JE.ColumnRef("o"), True, True)],
        JH.HostSourceExec(table, 3)).collect(JCtx()).to_pydict()
    assert ref["s"] != want_s


def _placement_table():
    rng = np.random.default_rng(3)
    n = 200
    return pa.table({
        "k": pa.array(rng.integers(0, 7, n), pa.int64()),
        "x": pa.array(rng.integers(-10 ** 6, 10 ** 6, n), pa.int64()),
        "m": pa.array([pydec.Decimal(int(v)).scaleb(-2) for v in
                       rng.integers(-10 ** 9, 10 ** 9, n)],
                      pa.decimal128(12, 2))})


def _window_query(p, e, w, col, s, table, which):
    df = s.from_arrow(table)
    if which == "disabled":
        return df.window([(w.RowNumber(), "rn"), (w.Rank(), "rk")],
                         partition_by=[col("k")], order_by=[("x", True,
                                                             True)])
    rev = df.group_by("k").agg((p.Sum(col("m")), "rev"))
    return rev.window([(w.Rank(), "rk"), (w.DenseRank(), "dr")],
                      order_by=[("rev", False, False)])


@pytest.mark.parametrize("which", ["disabled", "decimal128_order_key"])
def test_a_window_the_reference_runs_on_its_cpu_runs_on_cpu_window_exec(
        which):
    from spark_rapids_tpu.plan import aggregates as JA
    from spark_rapids_tpu.session import col as jcol
    from spark_rapids_tpu_torch.plan import aggregates as PA
    from spark_rapids_tpu_torch.session import col as pcol
    conf = {"spark.rapids.tpu.sql.expression.RowNumber": "false"} \
        if which == "disabled" else {}
    table = _placement_table()
    js = JSession(conf)
    jdf = _window_query(JA, JE, JW, jcol, js, table, which)
    pdf = _window_query(PA, PE, PW, pcol, PSession(conf, device="cpu"),
                        table, which)
    q = pdf.physical()
    assert q.explain() == jdf.physical().explain()
    assert "CpuWindowExec" in q.physical_tree()
    order = ["k", "x"] if which == "disabled" else ["rk", "k"]
    got = pa.Table.from_pydict(q.collect().to_pydict()).sort_by(
        [(c, "ascending") for c in order]).to_pydict()
    want = JDF(jdf._plan, js).collect().sort_by(
        [(c, "ascending") for c in order]).to_pydict()
    assert got == want
