"""The port's wrap -> tag -> convert (plan/overrides.py) against the JAX
package's: port copies of tests/test_overrides.py (placement, `q.kind`,
the transitions' positions, the explain markers, the reasons' key
phrases, the sql.exec.* / sql.expression.* disables, sql.enabled,
explainOnly), the three mixed plans of chip_smoke_fallback.py at TPC-H
scale 0.001 (placement and values against the reference's same plan),
and the device plans of the 22 TPC-H and 23 TPC-DS queries, which this
slice leaves unchanged (tests/torch_device_plans.json holds their
`tree_string`s before it).
"""
import json
import logging
import os

import pyarrow as pa
import pytest

import chip_smoke_fallback as F

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import strings as JS
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import tpcds as PDS
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.exec import host_exec as H
from spark_rapids_tpu_torch.exec.plan import FilterExec, HashAggregateExec
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.aggregates import (Average, Count, Max, Min,
                                                    Sum)
from spark_rapids_tpu_torch.session import DataFrame, TpuSession, col, lit
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
PLANS = os.path.join(os.path.dirname(__file__), "torch_device_plans.json")


@pytest.fixture
def session():
    return TpuSession(device="cpu")


@pytest.fixture
def table():
    return pa.table({
        "a": pa.array([1, 2, 3, 4, 5, None], pa.int64()),
        "b": pa.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0]),
        "s": pa.array(["x", "y", "x", "z", "y", "x"]),
    })


def _cpu(conf=None):
    return TpuSession({**ORACLE, **(conf or {})}, device="cpu")


def test_all_device_plan(session, table):
    df = session.from_arrow(table).filter(E.GreaterThan(col("a"), lit(1))) \
        .group_by("s").agg((Sum(col("b")), "sb")).sort("s")
    q = df.physical()
    assert q.kind == "device"
    assert isinstance(q.root.child, HashAggregateExec)
    out = q.collect().to_pydict()
    assert out["s"] == ["x", "y", "z"]
    assert out["sb"] == [30.0, 70.0, 40.0]


def test_explain_marks_device(session, table):
    text = session.from_arrow(table).filter(
        E.GreaterThan(col("a"), lit(1))).explain()
    assert "*Exec <Filter> will run on TPU" in text
    assert "!" not in text.split("Physical plan")[0]


class _Unsupported(E.Expression):
    """An expression with no device rule: it runs on the CPU engine."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = self.children[0].dtype
        self.nullable = True

    def _eval_cpu(self, batch, kids):
        return kids[0]


def test_unsupported_expr_falls_back_to_cpu(session, table):
    df = session.from_arrow(table).select(
        E.Alias(_Unsupported(col("a")), "ua"), col("b"))
    q = df.physical()
    assert q.kind == "host"
    assert isinstance(q.root, H.CpuProjectExec)
    assert "expression _Unsupported has no TPU rule" in q.meta.reasons
    assert "!Exec <Project> cannot run on TPU" in q.explain()
    assert q.collect().to_pydict()["ua"] == table.column("a").to_pylist()


def test_partial_fallback_inserts_transitions(session, table):
    # project(unsupported) -> filter(supported): the filter runs on the
    # device above a host project, through a HostToDeviceExec
    df = session.from_arrow(table).select(
        E.Alias(_Unsupported(col("a")), "ua")).filter(
        E.GreaterThan(col("ua"), lit(2)))
    q = df.physical()
    assert q.kind == "device"
    assert isinstance(q.root, FilterExec)
    assert isinstance(q.root.child, H.HostToDeviceExec)
    assert isinstance(q.root.child.host_child, H.CpuProjectExec)
    assert isinstance(q.root.child.host_child.child, H.DeviceToHostExec)
    assert q.collect().to_pydict()["ua"] == [3, 4, 5]


def test_conf_disable_exec_forces_cpu(table):
    s = TpuSession({"spark.rapids.tpu.sql.exec.FilterExec": "false"},
                   device="cpu")
    q = s.from_arrow(table).filter(E.GreaterThan(col("a"), lit(2))) \
        .physical()
    assert q.kind == "host"
    assert q.meta.reasons == ["exec FilterExec disabled by "
                              "spark.rapids.tpu.sql.exec.FilterExec"]
    assert q.collect().to_pydict()["a"] == [3, 4, 5]


def test_conf_disable_expression_forces_cpu(table):
    s = TpuSession({"spark.rapids.tpu.sql.expression.GreaterThan": "false"},
                   device="cpu")
    q = s.from_arrow(table).filter(E.GreaterThan(col("a"), lit(2))) \
        .physical()
    assert q.kind == "host"
    assert q.meta.reasons == [
        "expression GreaterThan disabled by "
        "spark.rapids.tpu.sql.expression.GreaterThan"]
    assert q.collect().to_pydict()["a"] == [3, 4, 5]


def test_sql_enabled_kill_switch(table):
    q = _cpu().from_arrow(table).filter(E.GreaterThan(col("a"), lit(2))) \
        .physical()
    assert q.kind == "host"
    assert q.fallback_reasons() == ["spark.rapids.tpu.sql.enabled is false"]
    assert q.collect().to_pydict()["a"] == [3, 4, 5]


def test_explain_only_mode(table):
    s = TpuSession({"spark.rapids.tpu.sql.mode": "explainOnly"},
                   device="cpu")
    q = s.from_arrow(table).filter(E.GreaterThan(col("a"), lit(2))) \
        .physical()
    assert q.kind == "host"                  # executes fully on the CPU
    assert "*Exec <Filter> will run on TPU" in q.explain()   # tags device
    assert q.collect().to_pydict()["a"] == [3, 4, 5]


@pytest.mark.parametrize("mode,logged", [("NONE", 0), ("ALL", 3),
                                         ("NOT_ON_TPU", 1)])
def test_explain_logging(table, caplog, mode, logged):
    s = TpuSession({"spark.rapids.tpu.sql.explain": mode}, device="cpu")
    df = s.from_arrow(table).select(E.Alias(_Unsupported(col("a")), "u")) \
        .filter(E.GreaterThan(col("u"), lit(1)))
    with caplog.at_level(logging.INFO,
                         logger="spark_rapids_tpu_torch.plan.overrides"):
        df.physical()
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == logged
    if mode == "NOT_ON_TPU":
        assert lines[0].lstrip().startswith("!Exec <Project>")


def test_cpu_aggregate_matches_device(session, table):
    df = session.from_arrow(table).group_by("s").agg(
        (Sum(col("a")), "sa"), (Count(col("a")), "ca"),
        (Min(col("b")), "mn"), (Max(col("b")), "mx"),
        (Average(col("b")), "av")).sort("s")
    dev = df.collect().to_pydict()
    cpu = DataFrame(df._plan, _cpu()).collect().to_pydict()
    assert dev == cpu


def test_join_device_and_cpu_match(session):
    left = pa.table({"k": [1, 2, 3, 4], "v": [10, 20, 30, 40]})
    right = pa.table({"k": [2, 3, 5], "w": [200, 300, 500]})
    for how in ("inner", "left_outer", "left_semi", "left_anti"):
        rdf = session.from_arrow(right).select(E.Alias(col("k"), "k2"),
                                               col("w"))
        df = session.from_arrow(left).join(rdf, how=how, left_on=["k"],
                                           right_on=["k2"]).sort("k")
        dev = df.collect().to_pydict()
        cpu = DataFrame(df._plan, _cpu()).collect().to_pydict()
        assert dev == cpu, how


def test_sort_device_cpu_match(session, table):
    df = session.from_arrow(table).sort(("a", False, False))
    assert df.collect().to_pydict()["a"] == DataFrame(
        df._plan, _cpu()).collect().to_pydict()["a"]


def test_limit_union_range(session, table):
    assert session.from_arrow(table).limit(3).collect().num_rows == 3
    u = session.from_arrow(table).union(session.from_arrow(table))
    assert u.collect().num_rows == 12
    assert session.range(10).collect().to_pydict()["id"] == list(range(10))
    assert _cpu().range(100).count() == 100


def test_with_column_and_count(session, table):
    df = session.from_arrow(table).with_column(
        "c", E.Add(col("a"), lit(100)))
    assert df.collect().to_pydict()["c"] == [101, 102, 103, 104, 105, None]
    assert df.count() == 6
    assert DataFrame(df._plan, _cpu()).count() == 6


def test_expand_grouping_sets(session, table):
    plan = L.LogicalExpand(
        [[col("s"), col("a")], [col("s"), lit(None, t.LONG)]],
        ["s", "a"], session.from_arrow(table)._plan)
    assert DataFrame(plan, session).collect().num_rows == 12
    assert DataFrame(plan, _cpu()).collect().num_rows == 12


def test_a_window_the_cpu_would_run_raises_naming_its_slice(table):
    # since CpuWindowExec ports, such a window runs there instead of
    # raising (tests/test_torch_cpu_window.py holds its results)
    from spark_rapids_tpu_torch.plan.window import RowNumber
    s = TpuSession({"spark.rapids.tpu.sql.expression.RowNumber": "false"},
                   device="cpu")
    df = s.from_arrow(table).window([(RowNumber(), "rn")],
                                    partition_by=["s"], order_by=["a"])
    q = df.physical()
    assert "CpuWindowExec" in q.physical_tree()
    assert df.collect().num_rows == table.num_rows


def test_unported_device_forms_raise_instead_of_falling_back(table):
    # the reference runs these on its device: the port refuses, naming the
    # slice, and sends nothing to the CPU engine...
    s = TpuSession(device="cpu")
    stamps = pa.table({"ts": pa.array([0, 86_400_000_000],
                                      pa.timestamp("us", tz="UTC"))})
    from spark_rapids_tpu_torch.plan import datetime as DT
    from spark_rapids_tpu_torch.plan import strings as S
    # (a TIMESTAMP's date fields no longer refuse: they run on the
    # device under the session zone)
    assert s.from_arrow(stamps).select(
        E.Alias(DT.Year(col("ts")), "y")).physical().kind == "device"
    # (RLIKE no longer refuses: the regex transpiler's automaton runs on
    # the device)
    assert s.from_arrow(table).select(E.Alias(S.RLike(col("s"), "x+"),
                                              "r")).physical().kind == "device"
    with pytest.raises(NotImplementedError, match="cast them to one"):
        s.from_arrow(table).select(E.Alias(E.Greatest(col("b"), col("a")),
                                           "g")).physical()
    # ...unless another reason already puts the operator on the CPU
    off = TpuSession({"spark.rapids.tpu.sql.exec.ProjectExec": "false"},
                     device="cpu")
    q = off.from_arrow(table).select(E.Alias(E.Greatest(col("b"), col("a")),
                                             "g")).physical()
    assert q.kind == "host"
    assert q.collect().to_pydict()["g"] == [10.0, 20.0, 30.0, 40.0, 50.0,
                                             60.0]


# ---------------------------------------------------------------------------
# The fallback phase's plans at scale 0.001
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return JTPCH.gen_tables(0.001)


@pytest.mark.parametrize("name", F.FB_QUERIES)
def test_fallback_plans_place_and_equal_the_reference(tables, name):
    jq = F.frame(name, JSession(), tables,
                 (JT, JE, JS, JA, jcol)).physical()
    pq = F.frame(name, TpuSession(device="cpu"), tables).physical()
    # the same explain lines, marker for marker, reason for reason
    assert pq.explain() == jq.explain()
    assert not F.placement_errors(name, pq.explain(), pq.physical_tree())
    got = pq.collect().to_pydict()
    want = jq.collect().to_pydict()
    oracle = F.frame(name, JSession(ORACLE), tables,
                     (JT, JE, JS, JA, jcol)).collect().to_pydict()
    assert got == want == oracle


@pytest.mark.parametrize("name", F.FB_QUERIES)
def test_fallback_plan_runs_its_path_kernels(tpch_tables, name,
                                             monkeypatch):
    # the wrappers chip_smoke.PATH_KERNELS holds each fb_* query's run on
    # the card to (there, from the launch counts); statistics pass
    # through the transitions, so the uploaded customer projection's
    # unique keys take probe_first
    import chip_smoke
    from spark_rapids_tpu_torch.ops.hopper import compact as PC
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
    from spark_rapids_tpu_torch.ops.hopper import segagg as PSA
    calls = {}

    def spy(mod, fn):
        real = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[fn] = calls.get(fn, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)
    for fn in ("build_table", "probe_first", "probe_counts",
               "expand_pairs"):
        spy(PHJ, fn)
    spy(PC, "compaction_order")
    spy(PSA, "seg_sums")
    spy(PSA, "seg_reduce")
    F.frame(name, TpuSession(device="cpu"), tpch_tables).collect()
    want = chip_smoke.PATH_KERNELS[name]
    assert set(want) <= set(calls), (want, calls)
    assert "probe_counts" not in calls


# ---------------------------------------------------------------------------
# The device plans this slice leaves unchanged
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def device_plans():
    with open(PLANS) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tpch_tables():
    return PTPCH.gen_tables(0.001)


@pytest.fixture(scope="module")
def tpcds_tables():
    return PDS.gen_tables(0.0005)


@pytest.mark.parametrize("name", sorted(PTPCH.QUERIES))
def test_tpch_device_plan_is_unchanged(device_plans, tpch_tables, name):
    q = PTPCH.QUERIES[name](TpuSession(device="cpu"), tpch_tables) \
        .physical()
    assert q.kind == "device" and not q.fallback_reasons()
    assert q.root.tree_string() == device_plans[f"tpch/{name}"]


@pytest.mark.parametrize("name", sorted(PDS.QUERIES))
def test_tpcds_device_plan_is_unchanged(device_plans, tpcds_tables, name):
    q = PDS.QUERIES[name](TpuSession(device="cpu"), tpcds_tables).physical()
    assert q.kind == "device" and not q.fallback_reasons()
    assert q.root.tree_string() == device_plans[f"tpcds/{name}"]
