"""collect_list / collect_set in the port (plan/aggregates.py,
exec/collect.py, ops/percentile.collect_trace) against the JAX package.

Port copies of tests/test_collect_device.py: nulls dropped, duplicates
and input order kept by collect_list, duplicates dropped by collect_set
(every NaN one value, -0.0 equal to 0.0), string and double values,
groups spanning several batches, the global form over rows and over no
row, and a mix with SUM on the CPU engine.  The port's device path (CPU
tensors) equals the reference's device path value for value (its sets
come value-sorted, as the reference's do), and its CPU engine the
reference's CPU oracle (first occurrences, in input order); sets compare
sorted across the two engines, as Spark leaves their order open.
Placement and explain lines equal the reference's; with `sql.agg.collect.
enabled=false` the port runs the CPU engine where the reference raises
(a README deviation); under `sql.compile.wholePlan=ON`
the exec captures whole over a scan, equal to the eager run.  The ragged
output then feeds the ARRAY expressions on the device.
"""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import collections as JC
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.exec import compiled as PCOMP
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import collections as PC
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}


def _canon(v):
    """A list element comparable across NaN (NaN equal to NaN)."""
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return v


def _norm(d, sets=()):
    """Columns with NaN made comparable, the `sets` columns sorted."""
    out = {}
    for k, vs in d.items():
        col = []
        for v in vs:
            if isinstance(v, list):
                v = [_canon(x) for x in v]
                if k in sets:
                    v = sorted(v, key=repr)
            col.append(_canon(v))
        out[k] = col
    return out


def _four(table, build, conf=None):
    jdf = build(JA, jcol, JSession(conf).from_arrow(table))
    pdf = build(PA, pcol, PSession(conf, device="cpu").from_arrow(table))
    jq, pq = jdf.physical(), pdf.physical()
    return (pq.collect().to_pydict(),
            PDF(pdf._plan, PSession({**(conf or {}), **ORACLE},
                                    device="cpu")).to_pydict(),
            jq.collect().to_pydict(),
            JDF(jdf._plan, JSession({**(conf or {}), **ORACLE}))
            .collect().to_pydict(), jq, pq)


def _check(table, build, sets=(), conf=None, device=True):
    dev, cpu, ref, oracle, jq, pq = _four(table, build, conf)
    assert ("CollectAggregateExec" in pq.root.tree_string()) == device
    assert pq.explain() == jq.explain()
    assert _norm(dev) == _norm(ref)
    assert _norm(cpu) == _norm(oracle)
    assert _norm(dev, sets) == _norm(cpu, sets)
    return dev


def test_collect_list_drops_nulls_keeps_duplicates_and_order():
    tbl = pa.table({"k": pa.array([1, 2, 1, 2, 1, 3, 1], pa.int64()),
                    "v": pa.array([5, None, 3, 7, 3, None, 5], pa.int64())})

    def build(A, c, df):
        return df.group_by("k").agg((A.CollectList(c("v")), "lst")) \
            .sort("k")
    out = _check(tbl, build)
    assert out["lst"] == [[5, 3, 3, 5], [7], []]


def test_collect_set_dedupes():
    tbl = pa.table({"k": pa.array([1, 1, 1, 2, 2], pa.int64()),
                    "v": pa.array([4, 4, 2, None, 9], pa.int64())})

    def build(A, c, df):
        return df.group_by("k").agg((A.CollectSet(c("v")), "st")).sort("k")
    out = _check(tbl, build, sets=("st",))
    assert [sorted(x) for x in out["st"]] == [[2, 4], [9]]


def test_collect_strings_and_doubles():
    tbl = pa.table({"k": pa.array([1, 1, 2, 2, 2, 1], pa.int64()),
                    "s": pa.array(["b", "a", None, "b", "c", "a"]),
                    "x": pa.array([1.5, np.nan, 2.5, 2.5, -0.0, np.nan])})

    def build(A, c, df):
        return df.group_by("k").agg(
            (A.CollectList(c("s")), "ls"), (A.CollectSet(c("s")), "ss"),
            (A.CollectSet(c("x")), "sx"), (A.CollectList(c("x")), "lx")) \
            .sort("k")
    out = _check(tbl, build, sets=("ss", "sx"))
    assert out["ls"] == [["b", "a", "a"], ["b", "c"]]


@pytest.mark.parametrize("distinct", [False, True])
def test_groups_spanning_several_batches(distinct):
    rng = np.random.default_rng(5)
    n = 30_000
    tbl = pa.table({"k": pa.array(rng.integers(0, 50, n), pa.int64()),
                    "v": pa.array(rng.integers(0, 20, n), pa.int64(),
                                  mask=rng.random(n) < 0.05)})

    def build(A, c, df):
        fn = A.CollectSet if distinct else A.CollectList
        return df.group_by("k").agg((fn(c("v")), "st")).sort("k")
    _check(tbl, build, sets=("st",) if distinct else (),
           conf={"spark.rapids.tpu.sql.batchSizeRows": "8192"})


def test_the_global_form_over_rows_and_over_no_row():
    for vals, want in (([3, 1, None, 3], [[3, 1, 3]]), ([], [[]])):
        tbl = pa.table({"v": pa.array(vals, pa.int64())})

        def build(A, c, df):
            return df.agg((A.CollectList(c("v")), "lst"))
        assert _check(tbl, build)["lst"] == want


def test_a_mix_with_sum_and_the_disabled_key_keep_the_cpu_engine():
    tbl = pa.table({"k": pa.array([1, 1, 2], pa.int64()),
                    "v": pa.array([2, 3, 4], pa.int64())})

    def mixed(A, c, df):
        return df.group_by("k").agg((A.CollectList(c("v")), "lst"),
                                    (A.Sum(c("v")), "sv")).sort("k")

    def alone(A, c, df):
        return df.group_by("k").agg((A.CollectList(c("v")), "lst")) \
            .sort("k")
    _check(tbl, mixed, device=False)
    # with the device collect off the reference hands the aggregation to
    # its hash aggregate, which has no collect buffers and raises; the
    # port runs it on the CPU engine, equal to the oracle (README)
    off = {"spark.rapids.tpu.sql.agg.collect.enabled": "false"}
    with pytest.raises(NotImplementedError):
        alone(JA, jcol, JSession(off).from_arrow(tbl)).collect()
    pq = alone(PA, pcol, PSession(off, device="cpu").from_arrow(tbl)) \
        .physical()
    assert "CpuAggregateExec" in pq.root.tree_string()
    assert "disabled by spark.rapids.tpu.sql.agg.collect.enabled" in \
        pq.explain()
    assert pq.collect().to_pydict() == JDF(
        alone(JA, jcol, JSession(ORACLE).from_arrow(tbl))._plan,
        JSession(ORACLE)).collect().to_pydict() == \
        {"k": [1, 2], "lst": [[2, 3], [4]]}


def test_the_ragged_output_feeds_the_array_expressions():
    rng = np.random.default_rng(9)
    n = 2000
    tbl = pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                    "v": pa.array(rng.integers(-50, 50, n), pa.int64(),
                                  mask=rng.random(n) < 0.1)})

    def build(A, c, df):
        C = PC if A is PA else JC
        g = df.group_by("k").agg((A.CollectList(c("v")), "l"))
        return g.select(c("k"), C.Size(c("l")), C.ArrayMax(c("l")),
                        C.ElementAt(c("l"), 1), C.SortArray(c("l")),
                        C.ArrayContains(c("l"), 7),
                        names=["k", "n", "mx", "first", "sorted", "has7"]) \
            .sort("k")
    _check(tbl, build)


def test_whole_plan_on_captures_the_collect_and_equals_eager():
    PCOMP.clear_caches()
    tbl = pa.table({"k": pa.array([1, 2, 1, 2, 1, 3], pa.int64()),
                    "v": pa.array([5, None, 3, 7, 3, 1], pa.int64())})

    def df(conf):
        return PSession(conf, device="cpu").from_arrow(tbl).group_by("k") \
            .agg((PA.CollectList(pcol("v")), "l"),
                 (PA.CollectSet(pcol("v")), "s"))
    q = df({"spark.rapids.tpu.sql.compile.wholePlan": "ON"}).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert PCOMP.decision(q) == "whole", PCOMP.decision(q)
    assert got == df({}).to_pydict()
