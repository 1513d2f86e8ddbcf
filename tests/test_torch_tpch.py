"""The port's 22 TPC-H queries (`tpch.QUERIES`; q18 also at TPC-H's
validation bound 300 as `q18_300`, q21 also for VIETNAM as `q21_vn`) and
the chip smoke's three join-path queries (`m2m`, `outer`, `semi`),
through the PyTorch/CUDA port against the JAX package.

At scale 0.001 (q2 and q20 at 0.01, where they carry rows) the port (CPU
tensors, kernels' plain versions) must equal both the JAX package with
its kernel tier on (segagg ON, Pallas in interpret mode; for q3, q5, q10
and q12 also with `denseReplace: ON`, so their joins take the hash-table
kernels as the port's do) and the JAX package's CPU oracle
(sql.enabled=false).  Decimals and integers compare exactly, as unscaled
integers.  The DOUBLE results of q8, q11, q14, q15, q17 and q22
(`DOUBLES`) compare within rtol 1e-12: the reference's decimal -> DOUBLE
cast is 1 ulp off for some values (ROADMAP Queue 3 item 1), and f64 sums
may add in another order.
"""
import datetime as pydt
import decimal as pydec
import functools
import warnings

import numpy as np
import pyarrow as pa
import pytest

import chip_smoke

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec.plan import HashAggregateExec as PHashAgg
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import datetime as PDT
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON"}


@pytest.fixture(scope="module")
def jtables():
    return JTPCH.gen_tables(0.001)


@pytest.fixture(scope="module")
def ptables():
    return PTPCH.gen_tables(0.001)


# q2 and q20 keep no row at scale 0.001: they run at 0.01
@pytest.fixture(scope="module")
def jtables_01():
    return JTPCH.gen_tables(0.01)


@pytest.fixture(scope="module")
def ptables_01():
    return PTPCH.gen_tables(0.01)


def _unscaled(d: dict) -> dict:
    """Decimals as unscaled integers (exact comparison), else as is."""
    out = {}
    for k, vs in d.items():
        out[k] = [(int(v.scaleb(-v.as_tuple().exponent)),
                   -v.as_tuple().exponent)
                  if isinstance(v, pydec.Decimal) else v for v in vs]
    return out


def _reference(jdf):
    dev = jdf.collect().to_pydict()
    cpu = JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    return dev, cpu


HASH_JOINS = {"spark.rapids.tpu.sql.kernels.pallas.join.denseReplace": "ON"}
#: the DOUBLE result columns, compared within rtol 1e-12
DOUBLES = {"q8": ("mkt_share",), "q11": ("value",), "q14": ("promo_revenue",),
           "q15": ("total_revenue",), "q17": ("avg_yearly",),
           "q22": ("totacctbal",)}
NEW_QUERIES = ("q4", "q5", "q7", "q8", "q10", "q11", "q12", "q15", "q17",
               "q18", "q18_300", "q19")
#: the queries of the strings and COUNT(DISTINCT) slice; q21 (the
#: reference's SAUDI ARABIA has no supplier at these scales) beside q21_vn
STRING_QUERIES = ("q2", "q9", "q13", "q14", "q16", "q20", "q21", "q21_vn",
                  "q22")
AT_0_01 = ("q2", "q20")


def _jax_q18(s, t, bound):
    """The reference's q18 text with its HAVING bound as a parameter."""
    big = (s.from_arrow(t["lineitem"]).group_by("l_orderkey")
           .agg((JA.Sum(jcol("l_quantity")), "total_qty"))
           .filter(JE.GreaterThan(JE.Cast(jcol("total_qty"), JT.DOUBLE),
                                  JE.Literal(bound))))
    big = big.select(jcol("l_orderkey"), jcol("total_qty"),
                     names=["big_orderkey", "total_qty"])
    j = (s.from_arrow(t["orders"])
         .join(big, left_on=["o_orderkey"], right_on=["big_orderkey"])
         .join(s.from_arrow(t["customer"]), left_on=["o_custkey"],
               right_on=["c_custkey"]))
    return (j.select(jcol("c_custkey"), jcol("o_orderkey"),
                     jcol("o_orderdate"), jcol("o_totalprice"),
                     jcol("total_qty"))
            .sort(("o_totalprice", False, False), ("o_orderdate", True, True))
            .limit(100))


def _jax_q21(s, t, nation):
    """The reference's q21 text with its nation as a parameter."""
    li = s.from_arrow(t["lineitem"])
    late = li.filter(JE.GreaterThan(jcol("l_receiptdate"),
                                    jcol("l_commitdate")))
    total_supp = (li.group_by("l_orderkey")
                  .agg((JA.CountDistinct(jcol("l_suppkey")), "n_supp"))
                  .select(jcol("l_orderkey"), jcol("n_supp"),
                          names=["ts_orderkey", "n_supp"]))
    late_supp = (late.group_by("l_orderkey")
                 .agg((JA.CountDistinct(jcol("l_suppkey")), "n_late"))
                 .select(jcol("l_orderkey"), jcol("n_late"),
                         names=["ls_orderkey", "n_late"]))
    fails = s.from_arrow(t["orders"]).filter(
        JE.EqualTo(jcol("o_orderstatus"), JE.Literal("F")))
    supp = (s.from_arrow(t["supplier"])
            .join(s.from_arrow(t["nation"]).filter(
                JE.EqualTo(jcol("n_name"), JE.Literal(nation))),
                left_on=["s_nationkey"], right_on=["n_nationkey"]))
    j = (late.join(supp, left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(fails, left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(total_supp, left_on=["l_orderkey"], right_on=["ts_orderkey"])
         .join(late_supp, left_on=["l_orderkey"], right_on=["ls_orderkey"])
         .filter(JE.And(JE.GreaterThan(jcol("n_supp"), JE.Literal(1)),
                        JE.EqualTo(jcol("n_late"), JE.Literal(1)))))
    return (j.group_by("s_name")
            .agg((JA.Count(None), "numwait"))
            .sort(("numwait", False, False), ("s_name", True, True))
            .limit(100))


def _queries(name):
    """(the JAX package's query function, the port's) of a query name."""
    if name == "q18_300":
        return (functools.partial(_jax_q18, bound=300.0),
                functools.partial(PTPCH.q18, bound=300.0))
    if name == "q21_vn":
        return (functools.partial(_jax_q21, nation="VIETNAM"),
                functools.partial(PTPCH.q21, nation="VIETNAM"))
    return JTPCH.QUERIES[name], PTPCH.QUERIES[name]


def _assert_same(got, want, doubles=()):
    """Equal column by column; the named DOUBLE columns within rtol
    1e-12, everything else exactly (decimals unscaled)."""
    assert list(got) == list(want)
    got, want = _unscaled(got), _unscaled(want)
    for name in got:
        if name in doubles:
            np.testing.assert_allclose(np.array(got[name], float),
                                       np.array(want[name], float),
                                       rtol=1e-12, atol=0, err_msg=name)
        else:
            assert got[name] == want[name], name


def test_ports_the_twenty_two_queries():
    assert sorted(PTPCH.QUERIES) == sorted(JTPCH.QUERIES) == sorted(
        ["q1", "q3", "q6"] + [q for q in NEW_QUERIES if q != "q18_300"] +
        [q for q in STRING_QUERIES if q != "q21_vn"])


@pytest.mark.parametrize("query,extra", [
    ("q1", {}), ("q6", {}), ("q3", {}), ("q3", HASH_JOINS)] +
    [(q, {}) for q in NEW_QUERIES] +
    [(q, HASH_JOINS) for q in ("q5", "q10", "q12")])
def test_query_equals_reference_and_cpu_oracle(jtables, ptables, query,
                                               extra):
    jquery, pquery = _queries(query)
    dev, cpu = _reference(jquery(JSession({**PALLAS_ON, **extra}), jtables))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # denseReplace: resolved
        session = PSession(extra, device="cpu")
    got = pquery(session, ptables).to_pydict()
    doubles = DOUBLES.get(query, ())
    _assert_same(got, dev, doubles)
    _assert_same(got, cpu, doubles)


@pytest.mark.parametrize("query", STRING_QUERIES)
def test_string_and_distinct_query_equals_reference_and_cpu_oracle(
        request, query):
    # q2 and q20 at scale 0.01 (6 and 1 rows), the others at 0.001; q21's
    # SAUDI ARABIA keeps no row at either, q21_vn does
    suffix = "_01" if query in AT_0_01 else ""
    jt = request.getfixturevalue("jtables" + suffix)
    pt = request.getfixturevalue("ptables" + suffix)
    jquery, pquery = _queries(query)
    dev, cpu = _reference(jquery(JSession(PALLAS_ON), jt))
    got = pquery(PSession(device="cpu"), pt).to_pydict()
    doubles = DOUBLES.get(query, ())
    _assert_same(got, dev, doubles)
    _assert_same(got, cpu, doubles)
    rows = len(next(iter(got.values())))
    assert rows == 0 if query == "q21" else rows > 0


#: selection vectors, late materialization and encoded execution off
KEYS_OFF = {"spark.rapids.tpu.sql.join.lazySelection": "false",
            "spark.rapids.tpu.sql.join.lateMaterialization.enabled": "false",
            "spark.rapids.tpu.sql.encoded.execution.enabled": "false"}


@pytest.mark.parametrize("query", sorted(PTPCH.QUERIES))
def test_query_with_the_three_keys_off_equals_the_defaults(request, query):
    """The port alone, under its defaults and with the three keys off:
    the same rows in the same order, query by query (the parity tests
    above hold the defaults to the reference)."""
    suffix = "_01" if query in AT_0_01 else ""
    pt = request.getfixturevalue("ptables" + suffix)
    pquery = PTPCH.QUERIES[query]
    got = pquery(PSession(KEYS_OFF, device="cpu"), pt).to_pydict()
    want = pquery(PSession(device="cpu"), pt).to_pydict()
    _assert_same(got, want, DOUBLES.get(query, ()))


def test_q18_at_300_carries_rows_and_7200_none(ptables):
    # the reference's bound keeps no order at any scale of the generator
    s = PSession(device="cpu")
    assert PTPCH.q18(s, ptables).collect().num_rows == 0
    assert PTPCH.q18(s, ptables, bound=300.0).collect().num_rows > 0


def test_a_compacted_build_is_rebucketed_to_its_rows(ptables):
    # q18's build is its HAVING's few orders in a batch of every order's
    # capacity (at SF10: 15,000,000 groups, over join.maxBuildRows); the
    # join tables it at its rows' bucket.  The same shape at scale 0.001:
    # 1,500 groups in a bucket of 2,048, maxBuildRows 1,024
    small = {"spark.rapids.tpu.sql.batchSizeRows": "256",
             "spark.rapids.tpu.sql.kernels.pallas.join.maxBuildRows": "1024"}
    want = PTPCH.q18(PSession(device="cpu"), ptables, bound=300.0)
    got = PTPCH.q18(PSession(small, device="cpu"), ptables, bound=300.0)
    assert got.to_pydict() == want.to_pydict()
    assert len(got.to_pydict()["o_orderkey"]) > 0


@pytest.mark.parametrize("query", NEW_QUERIES + STRING_QUERIES)
def test_new_query_runs_its_path_kernels(request, query, monkeypatch):
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
    tables = request.getfixturevalue(
        "ptables_01" if query in AT_0_01 else "ptables")
    _queries(query)[1](PSession(device="cpu"), tables).collect()
    want = chip_smoke.PATH_KERNELS[query]
    assert want and set(want) <= set(calls), (want, calls)


def test_q3_runs_the_join_kernels_and_the_sorted_group_by(ptables,
                                                          monkeypatch):
    from spark_rapids_tpu_torch.ops import groupby as PG
    from spark_rapids_tpu_torch.ops.hopper import compact as PC
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
    calls = {"build_table": 0, "probe_first": 0, "compaction_order": 0,
             "groupby_trace": 0}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    spy(PHJ, "build_table")
    spy(PHJ, "probe_first")
    spy(PC, "compaction_order")
    spy(PG, "groupby_trace")
    small = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}
    off = {"spark.rapids.tpu.sql.join.lazySelection": "false",
           "spark.rapids.tpu.sql.join.lateMaterialization.enabled": "false",
           "spark.rapids.tpu.sql.encoded.execution.enabled": "false"}
    # one table per join and one probe per probe batch (2 orders
    # batches, 6 lineitem batches of 1024 rows).  With selection vectors
    # and thin batches off, one compaction per probe batch; under the
    # defaults the lineitem join's six outputs reach the aggregation as
    # selection vectors, and only the orders join's two outputs compact,
    # into the lineitem join's build
    for conf, compactions in ((off, 8), ({}, 2)):
        for k in calls:
            calls[k] = 0
        PTPCH.q3(PSession({**small, **conf}, device="cpu"),
                 ptables).collect()
        assert calls == {"build_table": 2, "probe_first": 8,
                         "compaction_order": compactions,
                         "groupby_trace": calls["groupby_trace"]}
        assert calls["groupby_trace"] > 0


def _join_query(name, m, e, t, c, s, tables):
    """The JAX package's side of the port's tpch.JOIN_QUERIES."""
    def days(y, mo, d):
        return (pydt.date(y, mo, d) - pydt.date(1970, 1, 1)).days

    def between(col_name, lo, hi):
        return e.And(e.GreaterThanOrEqual(c(col_name), e.Literal(
            days(*lo), t.DATE)), e.LessThan(c(col_name), e.Literal(
                days(*hi), t.DATE)))
    li, ps = s.from_arrow(tables["lineitem"]), s.from_arrow(tables["partsupp"])
    if name == "m2m":
        return (li.filter(between("l_shipdate", (1994, 1, 1), (1995, 1, 1)))
                .join(ps, left_on=["l_partkey"], right_on=["ps_partkey"])
                .group_by("l_shipmode")
                .agg((m.Sum(e.Multiply(c("ps_supplycost"),
                                       c("l_quantity"))), "cost"),
                     (m.Count(None), "n"))
                .sort("l_shipmode"))
    if name == "outer":
        week = li.filter(between("l_shipdate", (1995, 3, 1), (1995, 3, 8)))
        return (ps.join(week, left_on=["ps_partkey"], right_on=["l_partkey"],
                        how="left_outer")
                .group_by("ps_partkey", "ps_suppkey")
                .agg((m.Count(c("l_orderkey")), "c_count"))
                .group_by("c_count").agg((m.Count(None), "n"))
                .sort(("n", False, False), ("c_count", False, False)))
    return (li.join(ps, left_on=["l_partkey", "l_suppkey"],
                    right_on=["ps_partkey", "ps_suppkey"], how="left_semi")
            .agg((m.Count(None), "n"), (m.Sum(c("l_quantity")), "qty")))


@pytest.mark.parametrize("conf", [{}, {"spark.rapids.tpu.sql.batchSizeRows":
                                       "1024"}])
@pytest.mark.parametrize("name", ["m2m", "outer", "semi"])
def test_join_query_equals_reference_and_cpu_oracle(jtables, ptables, name,
                                                    conf):
    dev, cpu = _reference(_join_query(name, JA, JE, JT, jcol, JSession(
        {**PALLAS_ON, **HASH_JOINS, **conf}), jtables))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # denseReplace: resolved
        session = PSession({**HASH_JOINS, **conf}, device="cpu")
    got = PTPCH.JOIN_QUERIES[name](session, ptables).to_pydict()
    assert list(got) == list(dev)
    assert _unscaled(got) == _unscaled(dev) == _unscaled(cpu)
    assert len(next(iter(got.values()))) > 0


def test_join_queries_run_the_counted_probe_and_expansion(ptables,
                                                          monkeypatch):
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
    from spark_rapids_tpu_torch.ops.hopper import segagg as PS
    names = ("build_table", "probe_counts", "expand_pairs",
             "build_matched_flags", "probe_matched", "probe_first")
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for name in names:
        spy(PHJ, name)
    spy(PS, "seg_sums")
    small = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}
    seen = {}
    for query in ("m2m", "outer", "semi"):
        calls.clear()
        PTPCH.JOIN_QUERIES[query](PSession(small, device="cpu"),
                                  ptables).collect()
        seen[query] = dict(calls)
    # one table per join; one counted probe and one expansion per probe
    # batch that matched (6 lineitem batches of 1024 rows)
    for query in ("m2m", "outer"):
        assert seen[query]["build_table"] == 1
        assert 0 < seen[query]["expand_pairs"] <= \
            seen[query]["probe_counts"] == 6
        assert "probe_first" not in seen[query]
    assert seen["m2m"]["seg_sums"] > 0
    assert "build_matched_flags" not in seen["m2m"]
    # the mirrored right outer join marks matched partsupp rows per batch
    assert seen["outer"]["build_matched_flags"] == \
        seen["outer"]["expand_pairs"]
    assert seen["semi"]["probe_matched"] == 6
    assert "probe_counts" not in seen["semi"]


def _minmax(m, e, t, c, s, table):
    return (s.from_arrow(table).group_by("l_returnflag", "l_linestatus")
            .agg((m.Min(c("l_extendedprice")), "min_price"),
                 (m.Max(c("l_extendedprice")), "max_price"),
                 (m.Min(c("l_shipdate")), "min_ship"),
                 (m.Max(c("l_shipdate")), "max_ship"),
                 (m.Min(e.Cast(c("l_discount"), t.DOUBLE)), "min_disc"),
                 (m.Max(e.Cast(c("l_tax"), t.DOUBLE)), "max_tax"),
                 (m.First(c("l_orderkey")), "first_order"),
                 (m.Last(c("l_orderkey")), "last_order"),
                 (m.Average(c("l_quantity")), "avg_qty"),
                 (m.Count(None), "n"))
            .sort("l_returnflag", "l_linestatus"))


def test_minmax_first_last_groupby_equals_reference(jtables):
    li = jtables["lineitem"]
    dev, cpu = _reference(_minmax(JA, JE, JT, jcol, JSession(PALLAS_ON), li))
    got = _minmax(PA, PE, PT, pcol, PSession(device="cpu"), li).to_pydict()
    assert _unscaled(got) == _unscaled(dev) == _unscaled(cpu)


def test_multi_batch_merge_equals_reference(jtables, ptables):
    # 1024-row batches: six partials per query, merged on the way
    small = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}
    dev, cpu = _reference(JTPCH.q1(JSession({**PALLAS_ON, **small}),
                                   jtables))
    got = PTPCH.q1(PSession(small, device="cpu"), ptables).to_pydict()
    assert _unscaled(got) == _unscaled(dev) == _unscaled(cpu)
    q6 = PTPCH.q6(PSession(small, device="cpu"), ptables).to_pydict()
    assert _unscaled(q6) == _unscaled(_reference(JTPCH.q6(
        JSession(PALLAS_ON), jtables))[0])


def test_project_then_aggregate_equals_reference(jtables):
    # ProjectExec feeding the aggregate: computed decimal and double
    # columns, renamed keys
    li = jtables["lineitem"]

    def build(m, e, t, c, s):
        return (s.from_arrow(li)
                .select(c("l_returnflag"), e.Alias(c("l_linestatus"), "ls"),
                        e.Alias(e.Multiply(c("l_extendedprice"),
                                           c("l_discount")), "rev"),
                        e.Alias(e.Cast(c("l_quantity"), t.DOUBLE), "q"))
                .group_by("l_returnflag", "ls")
                .agg((m.Sum(c("rev")), "rev"), (m.Average(c("q")), "q"),
                     (m.Max(c("q")), "qmax"))
                .sort("l_returnflag", "ls"))
    dev, cpu = _reference(build(JA, JE, JT, jcol, JSession(PALLAS_ON)))
    got = build(PA, PE, PT, pcol, PSession(device="cpu")).to_pydict()
    assert _unscaled(got) == _unscaled(dev) == _unscaled(cpu)


def test_sort_orders_like_reference():
    table = pa.table({
        "k": pa.array([3, None, 1, 3, 2, None, 1], pa.int64()),
        "s": pa.array(["b", "a", None, "a", "c", "b", "a"]),
        "x": pa.array([1.0, float("nan"), -0.0, 0.0, None, -1.0, 2.0])})
    for orders in ([("k", True, True), ("s", False, False)],
                   [("x", True, True)], [("x", False, False), ("k",)],
                   [("s", True, False), ("x", False, True)]):
        want = JSession().from_arrow(table).sort(*orders).collect()
        got = PSession(device="cpu").from_arrow(table).sort(*orders) \
            .collect().to_pydict()
        assert {k: [repr(v) for v in vs] for k, vs in got.items()} == \
            {k: [repr(v) for v in vs]
             for k, vs in want.to_pydict().items()}, orders


def test_string_ordering_and_sql_disabled_run_the_cpu_engine(
        ptables, jtables):
    # a string ordering between two columns is the reference's CPU
    # engine's, and so is every operator with sql.enabled=false
    def ordering(e, c, s, t):
        return s.from_arrow(t["lineitem"]).filter(
            e.LessThan(c("l_shipmode"), c("l_returnflag"))).select(
            c("l_orderkey"), c("l_shipmode")).sort("l_orderkey",
                                                   "l_shipmode")
    want = ordering(JE, jcol, JSession(), jtables).collect().to_pydict()
    q = ordering(PE, pcol, PSession(device="cpu"), jtables).physical()
    assert q.kind == "device"            # the sort above runs on the device
    assert q.fallback_reasons() == [
        "expression LessThan: string ordering comparison not yet on device"]
    assert "HostToDeviceExec" in q.physical_tree()
    assert q.collect().to_pydict() == want
    off = PSession({"spark.rapids.tpu.sql.enabled": "false"}, device="cpu")
    q = off.from_host(ptables["lineitem"]).agg(
        (PA.Count(None), "n")).physical()
    assert q.kind == "host" and "!Exec <Aggregate>" in q.explain()
    assert q.collect().to_pydict() == {"n": [ptables["lineitem"].num_rows]}


def test_unported_operators_refuse_instead_of_falling_back(ptables,
                                                           jtables):
    s = PSession(device="cpu")
    # a composite key of strings runs the multi-lane sorted tier, with
    # the reference's rows: orders against its (priority, status) counts
    def build(s, t, port):
        read = s.from_host if port else s.from_arrow
        A, c = (PA, pcol) if port else (JA, jcol)
        keys = ["o_orderpriority", "o_orderstatus"]
        E = PE if port else JE
        counts = read(t["orders"]).group_by(*keys).agg(
            (A.Count(None), "cnt")).select(
            E.Alias(c("o_orderpriority"), "p"),
            E.Alias(c("o_orderstatus"), "st"), c("cnt"))
        return read(t["orders"]).join(counts, left_on=keys,
                                      right_on=["p", "st"]).agg(
            (A.Count(None), "n"), (A.Sum(c("cnt")), "pairs"))
    want, cpu = _reference(build(JSession(PALLAS_ON), jtables, False))
    got = build(s, ptables, True).collect().to_pydict()
    assert got == want == cpu and got["n"] == [ptables["orders"].num_rows]
    stamps = pa.table({"ts": pa.array([0, 86_400_000_000],
                                      pa.timestamp("us", tz="UTC"))})
    # a TIMESTAMP's date fields run under the session zone (UTC here)
    assert s.from_arrow(stamps).select(PE.Alias(PDT.Year(pcol("ts")), "y")) \
        .to_pydict() == {"y": [1970, 1970]}


def _q2_join(m, e, c, s, t):
    """q2's join shape without its string filter: partsupp joined to the
    MIN(ps_supplycost) of its part on (part, cost)."""
    eps = s.from_arrow(t["partsupp"]).join(
        s.from_arrow(t["part"]).filter(e.EqualTo(c("p_size"), e.Literal(15))),
        left_on=["ps_partkey"], right_on=["p_partkey"])
    mins = (eps.group_by("ps_partkey")
            .agg((m.Min(c("ps_supplycost")), "min_cost"),
                 (m.Max(c("ps_supplycost")), "max_cost"))
            .select(c("ps_partkey"), c("min_cost"), c("max_cost"),
                    names=["mc_partkey", "min_cost", "max_cost"]))
    return (eps.join(mins, left_on=["ps_partkey", "ps_supplycost"],
                     right_on=["mc_partkey", "min_cost"])
            .select(c("ps_partkey"), c("ps_suppkey"), c("min_cost"),
                    c("max_cost"))
            .sort("ps_partkey", "ps_suppkey"))


def test_min_max_outputs_carry_their_column_range_so_q2_packs(
        jtables, monkeypatch):
    from spark_rapids_tpu_torch.exec import join as PJ
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
    dev, cpu = _reference(_q2_join(JA, JE, jcol, JSession(PALLAS_ON),
                                   jtables))
    packs, tables = [], []

    def spy(real, seen):
        def wrapped(*a, **k):
            out = real(*a, **k)
            seen.append(out)
            return out
        return wrapped
    monkeypatch.setattr(PJ, "range_pack_spec",
                        spy(PJ.range_pack_spec, packs))
    monkeypatch.setattr(PHJ, "build_table", spy(PHJ.build_table, tables))
    df = _q2_join(PA, PE, pcol, PSession(device="cpu"), jtables)
    got = df.to_pydict()
    assert _unscaled(got) == _unscaled(dev) == _unscaled(cpu)
    assert len(got["ps_partkey"]) > 0
    # the (part, cost) key packs into one lane and takes the hash table
    # (a table for each of the two partsupp-part joins, one for it)
    assert any(p is not None for p in packs) and len(tables) == 3
    cost = jtables["partsupp"].column("ps_supplycost").to_pylist()
    unscaled = [int(v.scaleb(2)) for v in cost]

    def aggregates(node):
        found = [node] if isinstance(node, PHashAgg) else []
        return found + [a for c in node.children for a in aggregates(c)]
    (agg,) = aggregates(df.physical().root)
    assert agg.column_range("min_cost") == agg.column_range("max_cost") == \
        agg.child.column_range("ps_supplycost") == (min(unscaled),
                                                     max(unscaled))


#: the queries that sub-partition a join at scale 0.01 with 4,096-row
#: batches, as at SF10 with the default 4,194,304: the seven whose build
#: exceeds 2 x sql.batchSizeRows (orders, q21's orders under its fused
#: status filter, q22's o_custkey, q4's late lineitem), and q18, whose
#: adaptive join builds on orders once its group-by runs out of core
#: (the reference's choice too: tests/test_torch_ooc_tpch.py)
SUB_PARTITIONED = ("q4", "q7", "q8", "q9", "q12", "q18", "q21", "q22")


@pytest.mark.parametrize("query", sorted(PTPCH.QUERIES))
def test_cut_scales_foresee_the_build_gate(ptables_01, query):
    # the build gate is 2 x sql.batchSizeRows; at scale 0.01 with
    # 4,096-row batches a query meets it as at SF10 with the default
    # 4,194,304.  The queries that meet it sub-partition their joins
    # instead of refusing, so every query runs at its full scale on the
    # card: chip_smoke.CUT_SCALES is empty
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    assert chip_smoke.CUT_SCALES == {}
    gate = {"spark.rapids.tpu.sql.batchSizeRows": "4096"}
    q = PTPCH.QUERIES[query](PSession(gate, device="cpu"),
                             ptables_01).physical()
    ctx = ExecContext(q.conf, q.device)
    q.collect(ctx)
    fallbacks = ctx.metrics.get("join_subpartition_fallbacks", 0)
    assert (fallbacks > 0) == (query in SUB_PARTITIONED), fallbacks
