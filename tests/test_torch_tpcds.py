"""The port's TPC-DS generator and the first half of its 23 queries
(q3 .. q43, the rollup queries q27 and q36 among them) against the JAX
package, plus the grouping-id semantics of rollup / cube / grouping
sets.  The other half is tests/test_torch_tpcds_channels.py; the shared
comparison and its tolerances are tests/torch_tpcds_parity.py.

`gen_tables` must equal the reference's Arrow tables value for value,
nulls included, at scales 0.0005 and 0.01.
"""
import pyarrow as pa
import pytest

import chip_smoke
import torch_tpcds_parity as TP

from spark_rapids_tpu import tpcds as JDS
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import tpcds as PDS
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.exec.plan import ExpandExec
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.session import (GROUPING_ID_COLUMN,
                                            TpuSession as PSession, col)
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

QUERIES = ("q3", "q7", "q12", "q19", "q20", "q26", "q27", "q33", "q36",
           "q42", "q43")


@pytest.fixture(scope="module")
def jtables():
    return JDS.gen_tables(scale=TP.SCALE)


@pytest.fixture(scope="module")
def ptables():
    return PDS.gen_tables(scale=TP.SCALE)


@pytest.fixture(scope="module")
def reference(jtables):
    return TP.reference_results(QUERIES, jtables)


def test_ports_the_twenty_three_queries():
    assert sorted(PDS.QUERIES) == sorted(JDS.QUERIES)
    assert len(PDS.QUERIES) == 23


@pytest.mark.parametrize("scale", [0.0005, 0.01])
def test_gen_tables_equal_the_reference(scale):
    jt, pt = JDS.gen_tables(scale), PDS.gen_tables(scale)
    assert list(pt) == list(jt)
    for name, table in jt.items():
        want, got = from_arrow(table), pt[name]
        assert got.names == want.names, name
        for cname, w, g in zip(want.names, want.columns, got.columns):
            assert g.dtype == w.dtype and g.data.dtype == w.data.dtype, \
                (name, cname)
            assert g.to_pylist() == w.to_pylist(), (name, cname)
            # null rows carry a zero payload, as from_arrow leaves them
            assert (g.validity is None) == (w.validity is None), cname
            assert (g.data == w.data).all(), (name, cname)
            if w.dictionary is not None:
                assert (g.dictionary == w.dictionary).all(), (name, cname)


@pytest.mark.parametrize("query", QUERIES)
def test_query_equals_reference_and_cpu_oracle(reference, ptables, query):
    got = PDS.QUERIES[query](PSession(device="cpu"), ptables).to_pydict()
    dev, cpu = reference[query]
    TP.assert_same(got, dev, ulps=TP.DEVICE_ULPS)
    TP.assert_same(got, cpu)
    assert len(next(iter(got.values()))) > 0


@pytest.mark.parametrize("query", TP.ROLLUP)
def test_rollup_queries_run_expand(ptables, query):
    q = PDS.QUERIES[query](PSession(device="cpu"), ptables).physical()
    assert any(isinstance(n, ExpandExec) for n in TP.plan_nodes(q.root))


@pytest.mark.parametrize("query", sorted(PDS.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_tpcds_query_runs_its_path_kernels(ptables, query, monkeypatch):
    # the wrappers chip_smoke.PATH_KERNELS holds each query's run on the
    # card to (there, from the launch counts)
    from spark_rapids_tpu_torch.ops.hopper import compact as PC
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
    from spark_rapids_tpu_torch.ops.hopper import segagg as PS
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for name in ("build_table", "probe_first", "probe_counts",
                 "expand_pairs"):
        spy(PHJ, name)
    spy(PC, "compaction_order")
    spy(PS, "seg_sums")
    spy(PS, "seg_reduce")
    PDS.QUERIES[query](PSession(device="cpu"), ptables).collect()
    want = chip_smoke.PATH_KERNELS[f"ds_{query}"]
    assert want and set(want) <= set(calls), (want, calls)


# -- grouping ids (the reference's tests/test_tpcds.py cases) ---------------

def test_grouping_id_spark_semantics():
    tbl = pa.table({"a": ["x", "x", "y"], "b": [1, 2, 1],
                    "v": [10, 20, 30]})
    df = PSession(device="cpu").from_arrow(tbl)
    r = df.rollup("a", "b")
    out = (r.agg((Sum(col("v")), "sv"))
           .sort(GROUPING_ID_COLUMN, "a", "b").collect().to_pydict())
    rows = list(zip(out["a"], out["b"], out[GROUPING_ID_COLUMN], out["sv"]))
    assert rows == [("x", 1, 0, 10), ("x", 2, 0, 20), ("y", 1, 0, 30),
                    ("x", None, 1, 30), ("y", None, 1, 30),
                    (None, None, 3, 60)]
    c = df.cube("a", "b")
    out = (c.agg((Count(None), "n"))
           .sort(GROUPING_ID_COLUMN, "a", "b").collect().to_pydict())
    gids = out[GROUPING_ID_COLUMN]
    # cube emits all four sets: (a,b)=0, (a)=1, (b)=2, ()=3
    assert sorted(set(gids)) == [0, 1, 2, 3]
    rows = {(a, b, g): n for a, b, g, n in zip(out["a"], out["b"], gids,
                                                 out["n"])}
    assert rows[(None, 1, 2)] == 2 and rows[(None, 2, 2)] == 1
    assert rows[(None, None, 3)] == 3
    g = df.grouping_sets([("a",), ()], keys=["a", "b"])
    out = g.agg((Count(None), "n")).sort(GROUPING_ID_COLUMN, "a") \
        .collect().to_pydict()
    assert out[GROUPING_ID_COLUMN] == [1, 1, 3]


def _grouping_select(s, col_, tbl, sum_):
    r = s.from_arrow(tbl).rollup("a", "b")
    return (r.agg((sum_(col_("v")), "sv"))
            .select(col_("a"), col_("b"), r.grouping("a"), r.grouping("b"),
                    r.grouping_id(), col_("sv"),
                    names=["a", "b", "ga", "gb", "gid", "sv"])
            .sort("gid", "a", "b"))


def test_grouping_expr_equals_reference_and_cpu_oracle():
    from spark_rapids_tpu.plan.aggregates import Sum as JSum
    from spark_rapids_tpu.session import DataFrame as JDF
    from spark_rapids_tpu.session import col as jcol
    tbl = pa.table({"a": ["x", None, "y"], "b": [1, 1, 2],
                    "v": [1, 2, 3]})
    jdf = _grouping_select(JSession(TP.PALLAS_ON), jcol, tbl, JSum)
    dev = jdf.collect().to_pydict()
    cpu = JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    got = _grouping_select(PSession(device="cpu"), col, tbl, Sum) \
        .collect().to_pydict()
    assert got == dev == cpu
    # a data-null key row stays distinct from the rollup's subtotal null:
    # grouping() is 0 for the former, 1 for the latter
    per_row = list(zip(got["a"], got["gid"], got["ga"]))
    assert (None, 0, 0) in per_row     # real null key, not aggregated
    assert (None, 3, 1) in per_row     # grand total


def test_aggregating_grouping_key_rejected():
    tbl = pa.table({"a": ["x"], "v": [1]})
    r = PSession(device="cpu").from_arrow(tbl).rollup("a")
    with pytest.raises(NotImplementedError, match="grouping key"):
        r.agg((Sum(col("a")), "bad"))
