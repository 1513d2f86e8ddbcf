"""percentile / median / approx_percentile in the port
(plan/aggregates.py, exec/percentile.py, ops/percentile.py,
ops/quantile_sketch.py) against the JAX package.

Port copies of tests/test_percentile_device.py and
tests/test_quantile_sketch.py: grouped and global, with NaN (the
greatest), nulls (not counted), all-null and empty groups, integral and
STRING-cast inputs, string keys, several batches.  The port's device
path (CPU tensors) equals the reference's device path and its CPU engine
the reference's CPU oracle, value for value; the sketched multi-batch
approx_percentile is bit for bit the reference's, and its host merge
functions equal the reference's on the same summaries.  Placement and
explain lines equal the reference's; under `sql.compile.wholePlan=ON`
the exec captures whole over a scan and, under a filter, is a host
decision (its concat reads the device row counts); both equal eager.
"""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import quantile_sketch as JQ
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec import compiled as PCOMP
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.ops import quantile_sketch as PQ
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
JT_DOUBLE = __import__("spark_rapids_tpu.types", fromlist=["DOUBLE"]).DOUBLE


def _same(a, b) -> bool:
    """Equal dicts of columns, NaN equal to NaN."""
    if list(a) != list(b):
        return False
    for k in a:
        if len(a[k]) != len(b[k]):
            return False
        for x, y in zip(a[k], b[k]):
            if isinstance(x, float) and isinstance(y, float) and \
                    math.isnan(x) and math.isnan(y):
                continue
            if x != y:
                return False
    return True


def _four(table, build, conf=None):
    """(port device, port CPU engine, reference device, reference
    oracle) results and the two physical queries of `build(A, col, df)`."""
    jdf = build(JA, jcol, JSession(conf).from_arrow(table))
    pdf = build(PA, pcol, PSession(conf, device="cpu").from_arrow(table))
    jq, pq = jdf.physical(), pdf.physical()
    return (pq.collect().to_pydict(),
            PDF(pdf._plan, PSession({**(conf or {}), **ORACLE},
                                    device="cpu")).to_pydict(),
            jq.collect().to_pydict(),
            JDF(jdf._plan, JSession({**(conf or {}), **ORACLE}))
            .collect().to_pydict(), jq, pq)


def _grouped_table():
    rng = np.random.default_rng(23)
    n = 4000
    g = rng.integers(0, 12, n)
    x = rng.standard_normal(n) * 100
    x[rng.random(n) < 0.07] = np.nan
    vals = [None if rng.random() < 0.05 else float(v) for v in x]
    # group 12 all null, group 13 only NaN
    g = np.concatenate([g, [12, 12, 13]])
    vals += [None, None, float("nan")]
    return pa.table({"g": pa.array(g, pa.int64()),
                     "x": pa.array(vals, pa.float64()),
                     "i": pa.array(rng.integers(-9, 9, n + 3), pa.int32())})


def _grouped(A, c, df):
    return (df.group_by("g")
            .agg((A.Percentile(c("x"), 0.25), "p25"), (A.Median(c("x")), "med"),
                 (A.Percentile(c("x"), 0.9), "p90"),
                 (A.Percentile(c("i"), 1.0), "imax"))
            .sort("g"))


@pytest.mark.parametrize("conf", [None, {
    "spark.rapids.tpu.sql.batchSizeRows": "1024"}], ids=["one", "batches"])
def test_grouped_percentile_equals_the_reference(conf):
    dev, cpu, ref, oracle, jq, pq = _four(_grouped_table(), _grouped, conf)
    assert "PercentileAggregateExec" in pq.physical_tree()
    assert pq.explain() == jq.explain()
    assert _same(dev, ref)
    assert _same(cpu, oracle)
    assert dev["med"][12] is None and math.isnan(dev["med"][13])


def test_global_percentile_and_integral_input():
    tbl = pa.table({"v": pa.array([5, 1, 9, 3, None, 7], pa.int64())})

    def build(A, c, df):
        return df.agg((A.Median(c("v")), "med"),
                      (A.Percentile(c("v"), 0.0), "mn"),
                      (A.Percentile(c("v"), 1.0), "mx"))
    dev, cpu, ref, oracle, jq, pq = _four(tbl, build)
    assert "PercentileAggregateExec" in pq.physical_tree()
    assert dev == ref == {"med": [5.0], "mn": [1.0], "mx": [9.0]}
    assert cpu == oracle == dev


def test_empty_input_gives_a_null_row_or_no_group():
    tbl = pa.table({"g": pa.array([], pa.int64()),
                    "x": pa.array([], pa.float64())})

    def glob(A, c, df):
        return df.agg((A.Median(c("x")), "m"))

    def grouped(A, c, df):
        return df.group_by("g").agg((A.Median(c("x")), "m"))
    for build, want in ((glob, {"m": [None]}), (grouped, {"g": [], "m": []})):
        dev, cpu, ref, oracle, _jq, _pq = _four(tbl, build)
        assert dev == ref == cpu == oracle == want


def test_string_keys_and_several_batches():
    rng = np.random.default_rng(24)
    n = 3000
    tbl = pa.table({"k": pa.array(rng.choice(["a", "b", "c", "d"], n)),
                    "x": pa.array(rng.uniform(0, 100, n))})

    def build(A, c, df):
        return df.group_by("k").agg((A.Percentile(c("x"), 0.75), "p")) \
            .sort("k")
    dev, cpu, ref, oracle, _jq, _pq = _four(
        tbl, build, {"spark.rapids.tpu.sql.batchSizeRows": "1024"})
    assert _same(dev, ref) and _same(cpu, oracle)
    for a, b in zip(dev["p"], cpu["p"]):
        assert abs(a - b) <= 1e-9 * max(1.0, abs(b))


def test_approx_on_device_and_mixed_with_count_falls_back():
    tbl = pa.table({"x": pa.array([1.0, 2.0, 3.0, 4.0])})

    def approx(A, c, df):
        return df.agg((A.ApproximatePercentile(c("x"), 0.5), "a"))

    def mixed(A, c, df):
        return df.agg((A.Median(c("x")), "m"), (A.Count(None), "n"))
    dev, cpu, ref, oracle, jq, pq = _four(tbl, approx)
    assert "PercentileAggregateExec" in pq.physical_tree()
    assert dev == ref == cpu == oracle == {"a": [2.5]}
    dev, cpu, ref, oracle, jq, pq = _four(tbl, mixed)
    assert "percentile mixed with other aggregates" in pq.explain()
    assert pq.explain() == jq.explain()
    assert dev == ref == {"m": [2.5], "n": [4]}


def test_a_string_input_goes_to_the_cpu_and_a_cast_one_to_the_device():
    tbl = pa.table({"s": pa.array(["3", "1"])})

    def raw(A, c, df):
        return df.agg((A.Percentile(c("s"), 0.5), "p"))
    jq = raw(JA, jcol, JSession().from_arrow(tbl)).physical()
    pq = raw(PA, pcol, PSession(device="cpu").from_arrow(tbl)).physical()
    assert "percentile over string" in pq.explain().lower()
    assert pq.explain() == jq.explain()
    assert "PercentileAggregateExec" not in pq.physical_tree()
    df = PSession(device="cpu").from_arrow(tbl).agg(
        (PA.Percentile(PE.Cast(pcol("s"), PT.DOUBLE), 0.5), "p"))
    assert "PercentileAggregateExec" in df.physical().physical_tree()
    assert df.to_pydict() == {"p": [2.0]} == JSession().from_arrow(tbl).agg(
        (JA.Percentile(JE.Cast(jcol("s"), JT_DOUBLE), 0.5), "p")) \
        .collect().to_pydict()


def _sketch_of(vals, k=PQ.DEFAULT_K):
    s = np.sort(np.asarray(vals, np.float64))
    idx = np.round(np.linspace(0, len(s) - 1, k)).astype(int)
    return len(s), s[idx]


def _rank_err(data, est, q):
    s = np.sort(data)
    return abs(np.searchsorted(s, est, side="left") / max(len(s) - 1, 1) - q)


def test_the_host_merge_equals_the_reference_and_keeps_its_rank_error():
    rng = np.random.default_rng(7)
    parts = [rng.normal(0, 1, 5000), rng.normal(3, 2, 3000),
             np.append(rng.exponential(2, 2000), [np.nan, np.nan])]
    sks = [_sketch_of(p) for p in parts]
    merged = PQ.merge_sketches(sks)
    want = JQ.merge_sketches(sks)
    assert merged[0] == want[0] and np.array_equal(merged[1], want[1],
                                                   equal_nan=True)
    assert PQ.merge_sketches([]) == (0, pytest.approx(np.zeros(PQ.DEFAULT_K)))
    left = PQ.merge_sketches([PQ.merge_sketches(sks[:2]), sks[2]])
    right = PQ.merge_sketches([sks[0], PQ.merge_sketches(sks[1:])])
    allv = np.concatenate(parts[:2])
    two = PQ.merge_sketches(sks[:2])
    for q in (0.01, 0.25, 0.5, 0.9, 0.99):
        assert PQ.query_sketch(*two, q) == JQ.query_sketch(*two, q)
        assert _rank_err(allv, PQ.query_sketch(*two, q), q) <= \
            2.5 / (PQ.DEFAULT_K - 1)
    assert left[0] == right[0] == sum(len(p) for p in parts)
    assert PQ.query_sketch(0, np.zeros(3), 0.5) is None


def test_the_sketched_multi_batch_path_is_bit_for_bit_the_reference():
    rng = np.random.default_rng(3)
    n = 40_000
    keys = rng.integers(0, 4, n)
    vals = rng.normal(keys * 10.0, 1.0 + keys, n)
    vals[rng.random(n) < 0.01] = np.nan
    tbl = pa.table({"k": pa.array(keys, pa.int64()),
                    "x": pa.array(vals, pa.float64(),
                                  mask=rng.random(n) < 0.02)})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "8192"}

    def grouped(A, c, df):
        return (df.group_by("k")
                .agg((A.ApproximatePercentile(c("x"), 0.5), "p50"),
                     (A.ApproximatePercentile(c("x"), 0.9), "p90"))
                .sort("k"))

    def glob(A, c, df):
        return df.agg((A.ApproximatePercentile(c("x"), 0.5), "p50"))
    out = {}
    for build in (grouped, glob):
        jdf = build(JA, jcol, JSession(conf).from_arrow(tbl))
        pdf = build(PA, pcol, PSession(conf, device="cpu").from_arrow(tbl))
        out[build] = pdf.to_pydict()
        assert _same(out[build], jdf.collect().to_pydict())
    for g in range(4):
        # the rank among the group's non-NaN, non-null values
        data = vals[(keys == g) & ~np.isnan(vals)]
        assert _rank_err(data, out[grouped]["p50"][g], 0.5) <= \
            3.0 / (PQ.DEFAULT_K - 1)


def test_a_single_batch_approx_is_exact():
    tbl = pa.table({"x": pa.array(list(range(101)), pa.int64())})

    def build(A, c, df):
        return df.agg((A.ApproximatePercentile(c("x"), 0.25), "p"))
    dev, _cpu, ref, _o, _jq, _pq = _four(tbl, build)
    assert dev == ref == {"p": [25.0]}


@pytest.mark.parametrize("filtered", [False, True])
def test_whole_plan_on_captures_or_decides_at_the_concat(filtered):
    # over a scan the row counts are host ints and the exec captures
    # whole; under a filter they are device counts, and its concat's read
    # of them is the host decision that runs the plan eager
    PCOMP.clear_caches()
    tbl = _grouped_table()

    def df(conf):
        d = PSession(conf, device="cpu").from_arrow(tbl)
        if filtered:
            d = d.filter(PE.GreaterThan(pcol("i"), PE.Literal(-5)))
        return _grouped(PA, pcol, d)
    q = df({"spark.rapids.tpu.sql.compile.wholePlan": "ON"}).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    if filtered:
        assert PCOMP.decision(q).startswith("fallback: HostDecision")
        assert "exec/percentile.py" in PCOMP.decision(q), PCOMP.decision(q)
    else:
        assert PCOMP.decision(q) == "whole", PCOMP.decision(q)
    assert _same(got, df({}).to_pydict())
