"""The port's COUNT(DISTINCT) (plan/aggregates.py CountDistinct,
exec/distinct.py, ops/distinct.py, the minor lanes of ops/segments.py)
against the JAX package's DistinctAggregateExec and its CPU oracle.

Values come from a numpy seed: DOUBLE with nulls, NaN, -0.0, 0.0 and
±inf, LONG and DECIMAL with nulls, STRING with nulls; grouped and
global; in one batch and in 64-row batches; and over no row.  The port
runs on CPU tensors, and every count compares exactly.  The CPU oracle
counts every NaN row as a value of its own (a Python set of floats;
ROADMAP Queue 3 item 4), so DOUBLE values with NaN are held to the
reference's device path, and to the oracle with the NaNs made null.
"""
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec.distinct import DistinctAggregateExec
from spark_rapids_tpu_torch.ops import segments as PSEG
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
SMALL = {"spark.rapids.tpu.sql.batchSizeRows": "64"}


def _table(seed: int, n: int = 500) -> pa.Table:
    rng = np.random.default_rng(seed)
    null = rng.random((4, n)) < 0.08
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25])
    dbl = np.where(rng.random(n) < 0.5, specials[rng.integers(0, 7, n)],
                   rng.integers(0, 6, n) / 4.0)
    words = np.array(["", "ab", "b", "日本", "é", "ab "])
    return pa.table({
        "k": pa.array(rng.integers(0, 6, n), pa.int64()),
        "k2": pa.array(rng.integers(0, 2, n), pa.int64(), mask=null[3]),
        "d": pa.array(dbl, pa.float64(), mask=null[0]),
        "l": pa.array(rng.integers(-3, 9, n), pa.int64(), mask=null[1]),
        "m": pa.array([pydec.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(-300, 300, n)],
                      pa.decimal128(12, 2), mask=null[2]),
        "s": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                      pa.string(), mask=null[3])})


def _run(table, build, conf=None):
    """(port, reference, oracle) of `build(E, A, col, df)`."""
    jdf = build(JE, JA, jcol, JSession(conf).from_arrow(table))
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession({**(conf or {}), **ORACLE})) \
        .collect().to_pydict()
    got = build(PE, PA, pcol, PSession(conf, device="cpu").from_arrow(
        table)).to_pydict()
    return got, ref, oracle


def _without_nan(table: pa.Table) -> pa.Table:
    d = table.column("d").to_pylist()
    return table.set_column(table.schema.get_field_index("d"), "d", pa.array(
        [None if v is not None and v != v else v for v in d], pa.float64()))


def _grouped(value, keys=("k",)):
    def build(E, A, c, df):
        return (df.group_by(*keys)
                .agg((A.CountDistinct(c(value)), "n")).sort(*keys))
    return build


def _global(value):
    return lambda E, A, c, df: df.agg((A.CountDistinct(c(value)), "n"))


@pytest.mark.parametrize("conf", [None, SMALL], ids=["one_batch", "batches"])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("value", ["d", "l", "m", "s"])
def test_count_distinct_equals_reference_and_cpu_oracle(value, grouped,
                                                        conf):
    build = _grouped(value) if grouped else _global(value)
    got, ref, oracle = _run(_table(1), build, conf)
    if value == "d":
        assert got == ref
        got, ref, oracle = _run(_without_nan(_table(1)), build, conf)
    assert got == ref == oracle
    assert len(got["n"]) == (6 if grouped else 1)


def test_count_distinct_canonicalises_nan_and_signed_zero():
    table = pa.table({"k": pa.array([1] * 8 + [2] * 3, pa.int64()),
                      "d": pa.array([np.nan, -np.nan, -0.0, 0.0, np.inf,
                                     -np.inf, None, 1.0, None, None, -0.0],
                                    pa.float64())})
    got, ref, oracle = _run(table, _grouped("d"))
    assert got == ref == {"k": [1, 2], "n": [5, 1]}
    # the oracle's set of Python floats holds each NaN apart
    assert oracle == {"k": [1, 2], "n": [6, 1]}


@pytest.mark.parametrize("keys", [("k", "k2"), ("s",), ("k2", "s"),
                                  ("kk",), ("kk", "s")])
def test_count_distinct_by_nullable_and_string_keys(keys):
    # kk is computed, so it has no range and sorts by its own lanes
    def build(E, A, c, df):
        df = df.select(c("k"), c("k2"), c("s"), c("l"),
                       E.Alias(E.Add(c("k"), c("k2")), "kk"))
        return _grouped("l", keys)(E, A, c, df)
    got, ref, oracle = _run(_table(2), build, SMALL)
    assert got == ref == oracle


def test_several_count_distincts_share_one_sort_per_value():
    def build(E, A, c, df):
        return (df.group_by("k")
                .agg((A.CountDistinct(c("l")), "nl"),
                     (A.CountDistinct(c("s")), "ns"),
                     (A.CountDistinct(c("l")), "nl2")).sort("k"))
    got, ref, oracle = _run(_table(3), build)
    assert got == ref == oracle
    assert got["nl"] == got["nl2"]


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_count_distinct_over_no_row(grouped):
    def build(E, A, c, df):
        df = df.filter(E.GreaterThan(c("k"), E.Literal(100)))
        return _grouped("l")(E, A, c, df) if grouped \
            else _global("l")(E, A, c, df)
    got, ref, oracle = _run(_table(4), build)
    assert got == ref == oracle == ({"k": [], "n": []} if grouped
                                    else {"n": [0]})
    empty = _table(4).slice(0, 0)
    got, ref, oracle = _run(empty, _global("s"))
    assert got == ref == oracle == {"n": [0]}


def test_count_distinct_beside_another_aggregate_falls_back():
    # the reference's holistic split: the mix runs its CPU engine, and
    # the port's (NaN-free DOUBLE: the reference's CPU engine counts each
    # NaN apart)
    table = _without_nan(_table(5))

    def build(E, A, c, df):
        return (df.group_by("k")
                .agg((A.CountDistinct(c("l")), "n"), (A.Count(None), "c"),
                     (A.CountDistinct(c("d")), "nd"), (A.Sum(c("m")), "sm"))
                .sort("k"))
    got, ref, oracle = _run(table, build)
    assert got == ref == oracle
    q = build(PE, PA, pcol, PSession(device="cpu").from_arrow(table)) \
        .physical()
    assert q.fallback_reasons() == [
        "count(DISTINCT) mixed with other aggregates (device path requires "
        "a uniform aggregation)"]
    assert "!Exec <Aggregate> cannot run on TPU" in q.explain()


def test_count_distinct_refuses_a_wide_decimal():
    # decimal(12, 2) x decimal(12, 2) is decimal(25, 4): no single device
    # lane, so the aggregate is tagged for the CPU engine, as in the
    # reference, which counts it exactly (its oracle's answer)
    def build(E, A, c, df):
        wide = E.Multiply(c("m"), c("m"))
        return df.group_by("k").agg((A.CountDistinct(wide), "n")).sort("k")
    got, _ref, oracle = _run(_table(300), build)
    assert got == oracle
    q = PSession(device="cpu").from_arrow(_table(5)).agg(
        (PA.CountDistinct(PE.Multiply(pcol("m"), pcol("m"))), "n")) \
        .physical()
    assert q.kind == "host"
    assert any("count(DISTINCT) over decimal128" in r
               for r in q.fallback_reasons())


def test_distinct_exec_plan_statistics():
    table = _table(6)
    df = PSession(device="cpu").from_arrow(table)
    root = df.group_by("k").agg(
        (PA.CountDistinct(pcol("l")), "n")).physical().root
    assert isinstance(root, DistinctAggregateExec)
    assert root.output_schema.names == ["k", "n"]
    assert root.output_schema["n"].data_type == PT.LONG
    assert not root.output_schema["n"].nullable
    assert root.keys_unique(["k"]) and not root.keys_unique(["n"])
    assert root.static_row_count() is None
    ks = table.column("k").to_numpy()
    assert root.column_range("k") == (int(ks.min()), int(ks.max()))
    assert root.column_range("n") is None
    glob = df.agg((PA.CountDistinct(pcol("l")), "n")).physical().root
    assert glob.static_row_count() == 1 and glob.keys_unique([])


@pytest.mark.parametrize("seed", [7, 8])
def test_packed_minor_lanes_order_as_the_lexsort(seed):
    # one fused sort lane (every key packed, the minor lanes bounded)
    # gives the order and runs of the lexsort chain over the same lanes
    g = torch.Generator().manual_seed(seed)
    cap = 3000
    key = torch.randint(0, 40, (cap,), generator=g)
    kvalid = torch.rand(cap, generator=g) > 0.1
    val = torch.randint(5, 90, (cap,), generator=g)
    null = (torch.rand(cap, generator=g) < 0.2).to(torch.int8)
    live = torch.arange(cap) < 2900
    info = [(PT.LONG, True, torch.int64)]
    args = (info, [key], [kvalid], live, cap, cap)
    fused = PSEG.sorted_segments(*args, pack_spec=[(0, 41)],
                                 minor_lanes=[val, null],
                                 minor_spec=[(5, 85), (0, 2)])
    chain = PSEG.sorted_segments(*args, pack_spec=[(0, 41)],
                                 minor_lanes=[val, null])
    # the live rows (the dead ones sort last in either, in another order)
    assert torch.equal(fused.perm[:2900], chain.perm[:2900])
    assert torch.equal(fused.boundary[:2901], chain.boundary[:2901])
    assert int(fused.num_groups) == int(chain.num_groups)
    for (a, av), (b, bv) in zip(fused.out_keys, chain.out_keys):
        assert torch.equal(a[av], b[bv]) and torch.equal(av, bv)
    packed, span = PSEG.pack_minor_spec([val, null], [(5, 85), (0, 2)])
    assert span == 170
    assert torch.equal(packed, (val - 5) + 85 * null.to(torch.int64))
    assert PSEG.pack_minor_spec([val], [None]) == (None, 1)
    assert PSEG.pack_minor_spec([val], [(0, 1 << 31)]) == (None, 1)
