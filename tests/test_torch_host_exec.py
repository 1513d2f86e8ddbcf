"""The port's CPU engine (exec/host_exec.py, `eval_cpu`, `cpu_agg`)
against the JAX package's CPU engine (its pyarrow oracle) on the same
inputs: every expression family of tests/test_torch_expressions.py and
tests/test_torch_scalars.py, and every CPU operator (project, filter,
sample, aggregate, sort, limit, every join type, union, range, expand)
over nulls, NaN, ±0.0, ±inf and empty inputs, each with
`spark.rapids.tpu.sql.enabled=false` on both sides.

Where the reference's CPU engine is wrong by Spark's rules the port gives
Spark's answer, pinned here and listed in README "Deviations": COUNT
(DISTINCT) of DOUBLE values counts every NaN as one value (the reference
counts each NaN apart), and a sort, a group and a join key treat every
NaN as one value and -0.0 as 0.0.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

import test_torch_expressions as TE
import test_torch_scalars as TS

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.host import from_pydict
from spark_rapids_tpu_torch.exec import host_exec as H
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
J = (JE, jcol, JT, JA)
P = (PE, pcol, PT, PA)


def _both(table, build):
    """(port CPU engine, reference CPU engine) results of `build(E, col,
    T, A, df)`; the port's plan must run on the host."""
    want = build(*J, JSession(ORACLE).from_arrow(table)).collect() \
        .to_pydict()
    q = build(*P, PSession(ORACLE, device="cpu").from_arrow(table)) \
        .physical()
    assert q.kind == "host"
    return q.collect().to_pydict(), want


def _bits(v):
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else \
            ("f", int(np.float64(v).view(np.int64)))
    return v


def _rows(d: dict) -> list:
    return sorted(zip(*d.values()), key=lambda r: [repr(_bits(v))
                                                  for v in r])


def _close(a, b, rtol=1e-12) -> bool:
    """Equal, DOUBLEs within rtol (sums in another order), NaN = NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b)) or \
            abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b and type(a) is type(b)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(TE.CASES))
def test_conditional_on_the_cpu_engine_equals_the_reference(case):
    fn = TE.CASES[case]
    got, want = _both(TE.NUMS, lambda E, c, T, A, df: df.select(
        E.Alias(fn(E, c, T, None), "r")))
    assert repr(got) == repr(want)


@pytest.mark.parametrize("column,items", [
    ("x", [1, 4]), ("x", [1, None]), ("x", []), ("s1", ["MAIL", None]),
    ("s1", ["TRUCK"])])
def test_in_on_the_cpu_engine_equals_the_reference(column, items):
    got, want = _both(TE.NUMS, lambda E, c, T, A, df: df.select(
        E.Alias(E.In(c(column), items), "r")))
    assert got == want


@pytest.fixture(scope="module")
def scalars():
    """(port CPU engine, port device path, reference CPU engine or None
    where it raises) of every scalar family of test_torch_scalars."""
    cases = {**TS.EXACT, **TS.TRANSCENDENTAL, **TS.REFERENCE_FAULTS}
    cpu = TS._select((PE, pcol, PT, PSession(ORACLE, device="cpu")),
                     cases).to_pydict()
    dev = TS._select((PE, pcol, PT, PSession(device="cpu")),
                     cases).to_pydict()
    oracle = {}
    for name, fn in cases.items():
        try:
            oracle[name] = TS._select((JE, jcol, JT, JSession(ORACLE)),
                                      {name: fn}).collect().to_pydict()[name]
        except (ValueError, OverflowError, pa.ArrowInvalid):
            oracle[name] = None
    return cpu, dev, oracle


@pytest.mark.parametrize("name", sorted({**TS.EXACT, **TS.TRANSCENDENTAL,
                                         **TS.REFERENCE_FAULTS}))
def test_scalar_family_on_the_cpu_engine(scalars, name):
    """Held to the reference's CPU engine; where that raises or is wrong
    by Java's rules (ORACLE_RAISES, ORACLE_DIFFERS) to the port's device
    path, which tests/test_torch_scalars.py holds to the reference."""
    cpu, dev, oracle = scalars
    want = dev[name] if oracle[name] is None or \
        name in TS.ORACLE_DIFFERS else oracle[name]
    if name in TS.TRANSCENDENTAL or isinstance(cpu[name][0], float):
        assert TS._within_ulps(cpu[name], want, TS.ULPS), (cpu[name], want)
    else:
        assert TS._same(cpu[name], want), (cpu[name], want)


@pytest.mark.parametrize("field", sorted(TE.FIELDS))
def test_date_field_on_the_cpu_engine_equals_the_reference(field):
    days = [-719_528, -1, 0, 59, 365, 10_956, 11_016, 18_992, None, 2_932_896]
    table = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32())})
    JDTm = __import__("spark_rapids_tpu.plan.datetime", fromlist=["x"])
    PDTm = __import__("spark_rapids_tpu_torch.plan.datetime",
                      fromlist=["x"])
    want = JSession(ORACLE).from_arrow(table).select(
        JE.Alias(getattr(JDTm, field)(jcol("d")), "r")).collect()
    got = PSession(ORACLE, device="cpu").from_arrow(table).select(
        PE.Alias(getattr(PDTm, field)(pcol("d")), "r")).collect()
    assert got.to_pydict() == want.to_pydict()


def _dec(unscaled, precision: int, scale: int = 2):
    import decimal as pydec
    return pa.array([None if u is None else pydec.Decimal(u).scaleb(-scale)
                     for u in unscaled], pa.decimal128(precision, scale))


# the casts the CPU engine alone runs: every type to STRING
CAST_TABLE = pa.table({
    "l": pa.array([0, -7, 2 ** 63 - 1, None, -2 ** 63], pa.int64()),
    "i": pa.array([1, None, -3, 2 ** 31 - 1, 0], pa.int32()),
    "f": pa.array([1.5, float("nan"), -0.0, float("inf"), 1e-7]),
    "g": pa.array([100.0, 1e15, 123456789.0, None, 2.5e-5]),
    "b": pa.array([True, False, None, True, False]),
    "m": _dec([None, 0, -150, 99999, 5], 7),
    "d": pa.array([0, 9131, None, -1, 2_932_896], pa.int32()).cast(
        pa.date32())})


@pytest.mark.parametrize("column", CAST_TABLE.column_names)
def test_cast_to_string_equals_the_reference(column):
    build = lambda E, c, T, A, df: df.select(     # noqa: E731
        E.Alias(E.Cast(c(column), T.STRING), "r"))
    if column == "m":
        # the reference's CPU engine cannot build a DECIMAL's text (its
        # decimal cast path makes integers); the port writes Arrow's
        with pytest.raises(pa.ArrowTypeError):
            JSession(ORACLE).from_arrow(CAST_TABLE).select(
                JE.Alias(JE.Cast(jcol("m"), JT.STRING), "r")).collect()
        got = build(*P, PSession(ORACLE, device="cpu").from_arrow(
            CAST_TABLE)).to_pydict()
        assert got == {"r": CAST_TABLE.column("m").cast(pa.string())
                       .to_pylist()}
        return
    got, want = _both(CAST_TABLE, build)
    assert got == want


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def _edge_table(n=400, seed=3):
    rng = np.random.default_rng(seed)
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25])
    x = np.where(rng.random(n) < 0.4, specials[rng.integers(0, 7, n)],
                 rng.integers(-5, 5, n) / 2.0)
    null = rng.random((4, n)) < 0.1
    words = np.array(["", "b", "a", "日本", "é", "a "])
    return pa.table({
        "k": pa.array(rng.integers(0, 7, n), pa.int64(), mask=null[0]),
        "x": pa.array(x, pa.float64(), mask=null[1]),
        "v": pa.array(rng.integers(-1000, 1000, n), pa.int64(), mask=null[2]),
        "m": _dec(rng.integers(-10 ** 6, 10 ** 6, n).tolist(), 12),
        "s": pa.array(words[rng.integers(0, 6, n)].tolist(), pa.string(),
                      mask=null[3])})


EDGE = _edge_table()
EMPTY = EDGE.slice(0, 0)

AGGS = {
    "count_star": lambda A, c: A.Count(None),
    "count": lambda A, c: A.Count(c("x")),
    "sum_long": lambda A, c: A.Sum(c("v")),
    "sum_decimal": lambda A, c: A.Sum(c("m")),
    "min_double": lambda A, c: A.Min(c("x")),
    "max_double": lambda A, c: A.Max(c("x")),
    "min_long": lambda A, c: A.Min(c("v")),
    "max_string": lambda A, c: A.Max(c("s")),
    "min_string": lambda A, c: A.Min(c("s")),
    "avg_long": lambda A, c: A.Average(c("v")),
    "avg_decimal": lambda A, c: A.Average(c("m")),
    "first_ignore_nulls": lambda A, c: A.First(c("v"), True),
    "last_ignore_nulls": lambda A, c: A.Last(c("v"), True),
    "count_distinct_string": lambda A, c: A.CountDistinct(c("s")),
    "count_distinct_long": lambda A, c: A.CountDistinct(c("v")),
    "var_samp": lambda A, c: A.VarianceSamp(c("v")),
    "stddev_pop": lambda A, c: A.StddevPop(c("v")),
    "covar_pop": lambda A, c: A.CovarPop(c("v"), c("k")),
    "corr": lambda A, c: A.Corr(c("v"), c("k")),
}
#: aggregates whose DOUBLE results sum in another order than the
#: reference's python loops
INEXACT = {"avg_long", "var_samp", "stddev_pop", "covar_pop", "corr"}


@pytest.mark.parametrize("keys", [(), ("k",), ("s", "k")],
                         ids=["global", "long_key", "string_and_long"])
@pytest.mark.parametrize("table", [EDGE, EMPTY], ids=["edges", "empty"])
def test_aggregate_on_the_cpu_engine_equals_the_reference(keys, table):
    def build(E, c, T, A, df):
        return df.group_by(*keys).agg(*[(fn(A, c), n)
                                        for n, fn in AGGS.items()])
    got, want = _both(table, build)
    assert list(got) == list(want)
    rows_got, rows_want = _rows(got), _rows(want)
    assert len(rows_got) == len(rows_want)
    names = list(got)
    for rg, rw in zip(rows_got, rows_want):
        for n, a, b in zip(names, rg, rw):
            if n in INEXACT:
                assert _close(a, b, 1e-9) or (a is None and b is None), \
                    (n, a, b)
            else:
                assert _bits(a) == _bits(b), (n, a, b)


def test_min_max_order_nan_and_signed_zero_as_java():
    table = pa.table({"k": [1, 1, 1, 2, 2, 3], "x": [
        float("nan"), 1.0, -0.0, 0.0, -0.0, None]})
    got, want = _both(table, lambda E, c, T, A, df: df.group_by("k").agg(
        (A.Min(c("x")), "mn"), (A.Max(c("x")), "mx")).sort("k"))
    assert repr(got) == repr(want)
    assert repr(got["mx"][:2]) == "[nan, 0.0]" and \
        repr(got["mn"][:2]) == "[-0.0, -0.0]"


def test_first_keeps_a_leading_null_unlike_the_reference():
    # Spark's first(x) (and the reference's device path) is a group's
    # first value, null or not; the reference's CPU engine keeps the
    # null on its arrow path, but skips it on its python path, which a
    # variance beside it selects
    table = pa.table({"k": [1, 1, 2], "v": [None, 5, 7]})
    for extra in ((), ((lambda A, c: A.VarianceSamp(c("v"))), )):
        def build(E, c, T, A, df, extra=extra):
            aggs = [(A.First(c("v")), "f"), (A.Last(c("v")), "l")]
            aggs += [(fn(A, c), "var") for fn in extra]
            return df.group_by("k").agg(*aggs).sort("k")
        got, want = _both(table, build)
        dev = build(*P, PSession(device="cpu").from_arrow(table)) \
            .to_pydict()
        assert got["f"] == dev["f"] == [None, 7]
        assert got["l"] == dev["l"] == [5, 7]
        assert want["f"] == ([5, 7] if extra else [None, 7])


def test_count_distinct_counts_nan_once_unlike_the_reference():
    table = pa.table({"x": [float("nan"), float("nan"), 0.0, -0.0, None]})
    got, want = _both(table, lambda E, c, T, A, df: df.agg(
        (A.CountDistinct(c("x")), "n")))
    assert got == {"n": [2]} and want == {"n": [3]}


@pytest.mark.parametrize("orders", [
    [("k", True, True), ("s", False, False)], [("x", True, True)],
    [("x", False, False), ("v", True, False)], [("s", True, False),
                                                ("m", False, True)]])
def test_sort_on_the_cpu_engine_equals_the_reference(orders):
    table = EDGE.drop_columns(["x"]) if any(o[0] == "x" and not o[1]
                                            for o in orders) else EDGE
    if any(o[0] == "x" for o in orders):
        # NaN and -0.0 sort otherwise in the reference's pyarrow engine:
        # hold the port to the same order without them
        x = [None if v is not None and (v != v or v == 0.0) else v
             for v in EDGE.column("x").to_pylist()]
        table = EDGE.set_column(1, "x", pa.array(x, pa.float64()))
    got, want = _both(table, lambda E, c, T, A, df: df.sort(*orders))
    keys = [o[0] for o in orders]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_sort_orders_nan_greatest_and_signed_zeros_equal():
    hb = from_pydict({"x": [float("nan"), 1.0, -0.0, 0.0, None, -1.0],
                      "i": [0, 1, 2, 3, 4, 5]})
    idx = H.sort_indices_per_key([(hb.columns[0], True, False)])
    assert idx.tolist() == [5, 2, 3, 1, 0, 4]
    idx = H.sort_indices_per_key([(hb.columns[0], False, True)])
    assert idx.tolist() == [4, 0, 1, 2, 3, 5]


def test_sort_on_an_expression_key_falls_back():
    table = pa.table({"a": pa.array([1, 2, 3, 4, 5, None], pa.int64())})
    q = PSession(device="cpu").from_arrow(table).sort(
        (PE.Multiply(pcol("a"), PE.Literal(-1)), True, True)).physical()
    assert q.kind == "host"
    assert "not a column reference" in " ".join(q.fallback_reasons())
    assert q.collect().to_pydict() == {"a": [None, 5, 4, 3, 2, 1]}


@pytest.mark.parametrize("how", ["inner", "left_outer", "right_outer",
                                 "full_outer", "left_semi", "left_anti",
                                 "cross"])
@pytest.mark.parametrize("sides", ["both", "empty_left", "empty_right"])
def test_join_on_the_cpu_engine_equals_the_reference(how, sides):
    left = EDGE.slice(0, 60).select(["k", "v", "s"])
    right = EDGE.slice(60, 40).select(["k", "m"]).rename_columns(
        ["rk", "m"])
    if sides == "empty_left":
        left = left.slice(0, 0)
    elif sides == "empty_right":
        right = right.slice(0, 0)

    def build(E, c, T, A, df):
        s = df._session
        keys = {} if how == "cross" else {"left_on": ["k"],
                                          "right_on": ["rk"]}
        return s.from_arrow(left).join(s.from_arrow(right), how=how, **keys)
    got, want = _both(left, build)
    assert _rows(got) == _rows(want)


def test_join_keys_of_several_types_and_columns():
    left = pa.table({"a": [1, 2, None, 2], "b": ["x", "y", "x", None],
                     "f": [0.0, float("nan"), 1.5, -0.0]})
    right = pa.table({"ra": [2, 1, 2, None], "rb": ["y", "x", "z", "x"],
                      "rf": [-0.0, 1.5, float("nan"), 0.0]})
    for lk, rk in ((["a", "b"], ["ra", "rb"]), (["f"], ["rf"])):
        def build(E, c, T, A, df, lk=lk, rk=rk):
            s = df._session
            return s.from_arrow(left).join(s.from_arrow(right),
                                           left_on=lk, right_on=rk)
        got, want = _both(left, build)
        if lk == ["f"]:
            # Spark's key equality (-0.0 = 0.0, NaN = NaN): 2 + 1 + 1 + 2
            # pairs; the reference's pyarrow join matches otherwise
            assert len(got["f"]) == 6 and len(want["f"]) != 6
        else:
            assert repr(_rows(got)) == repr(_rows(want))


def test_project_filter_limit_union_range_expand():
    def build(E, c, T, A, df):
        s = df._session
        u = df.filter(E.GreaterThan(c("v"), E.Literal(0))).select(
            c("k"), E.Alias(E.Add(c("v"), E.Literal(1)), "w")).union(
            s.range(3, 12, 2).select(E.Alias(c("id"), "k"),
                                     E.Alias(c("id"), "w")))
        return u.limit(1000)
    got, want = _both(EDGE, build)
    assert _rows(got) == _rows(want)

    def expand(E, c, T, A, df):
        plan = (JL if E is JE else PL).LogicalExpand(
            [[c("s"), c("k")], [c("s"), E.Literal(None, T.LONG)]],
            ["s", "k"], df._plan)
        return (JDF if E is JE else PDF)(plan, df._session)
    got, want = _both(EDGE, expand)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("fraction", [0.0, 0.3, 1.0])
def test_sample_keeps_the_reference_rows(fraction):
    got, want = _both(EDGE, lambda E, c, T, A, df: df.sample(fraction, 7)
                      .select(c("v"), c("s")))
    assert got == want


def test_every_operator_streams_an_empty_input():
    def build(E, c, T, A, df):
        return (df.filter(E.IsNotNull(c("k"))).select(c("k"), c("s"))
                .sort("k").limit(5))
    got, want = _both(EMPTY, build)
    assert got == want == {"k": [], "s": []}


def test_host_profile_times_operators_and_transitions():
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    s = PSession(device="cpu")
    df = s.from_arrow(EDGE).select(
        pcol("k"), PE.Alias(PE.Cast(pcol("v"), PT.STRING), "t")) \
        .group_by("t").agg((PA.Count(None), "n"))
    q = df.physical()
    assert [n for n in q.physical_tree().split() if "To" in n] == [
        "HostToDeviceExec", "DeviceToHostExec"]
    ctx = ExecContext(q.conf, q.device)
    q.collect(ctx)
    prof = H.host_profile(ctx)
    assert prof["h2d_bytes"] > 0 and prof["d2h_bytes"] > 0
    assert any(k.startswith("CpuProjectExec") for k in prof)
    assert all(v >= 0 for v in prof.values())
