"""The wide decimal lane: DECIMAL wider than 18 digits on both engines.

  * host and device columns carry a high word (`HostColumn.hi`,
    `DeviceColumn.hi`, value hi * 2^64 + unsigned lo): round trips
    through Arrow, numpy and the device at +-(10^38 - 1) and around
    +-2^63;
  * SUM and AVG whose result type passes 18 digits are exact on both
    engines (ROADMAP Queue 3 item 13): two 32-bit half lanes on the
    device through every group-by tier, the global reduction, several
    batches and the out-of-core aggregation; Python ints on the CPU
    engine.  Held to the reference's CPU oracle, which is exact, where
    the reference's device path wraps;
  * the CPU engine's + - * / %, casts, comparisons, sorts and
    COUNT(DISTINCT) over values past int64, against the oracle;
  * an operator that reads a wide decimal column is placed on the CPU
    engine with the reference's reason; a device consumer without a
    two-lane form raises naming the slice once a value leaves int64.

Every comparison is exact (Python Decimal values), apart from a wide
DECIMAL cast to DOUBLE on the device: within 2 ulp of the oracle.
"""
import decimal as pydec
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import host as PHOST
from spark_rapids_tpu_torch.columnar.device import to_device, to_host
from spark_rapids_tpu_torch.exec import aggregate as PAGG
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
BIG = 999999999999999999                     # 18 nines: DECIMAL(18,0)
EXACT = pydec.Context(prec=100)


def _dec(unscaled: int, scale: int = 0) -> pydec.Decimal:
    return pydec.Decimal(unscaled).scaleb(-scale, EXACT)


def _oracle(build, table, conf=None):
    s = JSession({**ORACLE, **(conf or {})})
    return JDF(build(JA, JE, JT, jcol, s, table)._plan, s).collect() \
        .to_pydict()


def _reference_device(build, table, conf=None):
    s = JSession(conf or {})
    return build(JA, JE, JT, jcol, s, table).collect().to_pydict()


def _port(build, table, conf=None):
    return build(PA, PE, PT, pcol, PSession(conf, device="cpu"),
                 table).to_pydict()


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

EDGES = [10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 63, 2 ** 63 - 1, -2 ** 63,
         -2 ** 63 - 1, 2 ** 64, -(2 ** 64), 0, -1, None, 12345]


def _edge_table(scale=0):
    return pa.table({"d": pa.array(
        [None if v is None else _dec(v, scale) for v in EDGES],
        pa.decimal128(38, scale)),
        "i": pa.array(range(len(EDGES)), pa.int64())})


@pytest.mark.parametrize("scale", [0, 10])
def test_decimal128_round_trips_through_arrow_numpy_and_the_device(scale):
    table = _edge_table(scale)
    hb = PHOST.from_arrow(table)
    col = hb.column_by_name("d")
    assert col.hi is not None and col.data.dtype == np.int64
    assert PHOST.to_arrow(hb).equals(table)
    # numpy in: Python ints, or [lo, hi] word pairs
    ints = [0 if v is None else v for v in EDGES]
    valid = np.array([v is not None for v in EDGES])
    dt = PT.DecimalType(38, scale)
    a = PHOST.from_numpy({"d": (np.array(ints, object), valid)},
                         PT.StructType([PT.StructField("d", dt)]))
    words = np.stack([col.data, col.hi], axis=1)
    b = PHOST.from_numpy({"d": (words, valid)},
                         PT.StructType([PT.StructField("d", dt)]))
    assert a.to_pydict() == b.to_pydict() == {"d": table["d"].to_pylist()}
    # host -> device -> host, sliced and concatenated
    db = to_device(hb, capacity=32, device="cpu")
    assert db.column_by_name("d").hi is not None
    back = to_host(db, hb.num_rows)
    assert back.to_pydict() == hb.to_pydict()
    halves = PHOST.concat_host([hb.slice(0, 5), hb.slice(5, 7)])
    assert halves.to_pydict() == hb.to_pydict()


def test_wide_values_pass_through_device_operators():
    # a wide column moves through a filter, a sort and a join on the
    # device with its high word, and sorts by its exact value
    table = _edge_table(2)
    keys = pa.table({"k": pa.array(range(len(EDGES)), pa.int64()),
                     "w": pa.array(range(len(EDGES)), pa.int64())})

    def build(a, e, t, c, s, tbl):
        return (s.from_arrow(tbl).filter(e.GreaterThan(c("i"),
                                                       e.Literal(0)))
                .join(s.from_arrow(keys), left_on=["i"], right_on=["k"])
                .select(c("i"), c("d")).sort(("d", True, True)))
    for conf in (None, {"spark.rapids.tpu.sql.batchSizeRows": "4"}):
        assert _port(build, table, conf) == _oracle(build, table)


# ---------------------------------------------------------------------------
# exact sums and averages (ROADMAP Queue 3 item 13)
# ---------------------------------------------------------------------------

def _sum_table(n=20, value=BIG, precision=18, scale=0):
    rng = np.random.default_rng(5)
    return pa.table({
        "k": pa.array(np.arange(n) % 2, pa.int64()),
        "s": pa.array(np.where(np.arange(n) % 2 == 0, "even", "odd")
                      .tolist()),
        "f": pa.array(np.arange(n) % 2 + 0.5, pa.float64()),
        "d": pa.array([pydec.Decimal(value - int(x)).scaleb(-scale)
                       for x in rng.integers(0, 3, n)],
                      pa.decimal128(precision, scale))})


def _sums(key):
    def build(a, e, t, c, s, tbl):
        df = s.from_arrow(tbl)
        aggs = [(a.Sum(c("d")), "sum"), (a.Average(c("d")), "avg"),
                (a.Count(c("d")), "n")]
        if key is None:
            return df.agg(*aggs)
        return df.group_by(key).agg(*aggs).sort(key)
    return build


#: the dense tier takes dictionary keys when segagg is off
NO_SEGAGG = {"spark.rapids.tpu.sql.kernels.pallas.segagg": "OFF"}


@pytest.mark.parametrize("key,tier", [("k", "segagg"), ("s", "dense"),
                                      ("f", "sort"), (None, None)],
                         ids=["segagg", "dense", "sort", "global"])
@pytest.mark.parametrize("batch_rows", [None, "7"], ids=["one", "batches"])
def test_wide_decimal_sums_are_exact_on_every_tier(key, tier, batch_rows):
    table = _sum_table()
    conf = {} if batch_rows is None else \
        {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    if tier == "dense":
        conf.update(NO_SEGAGG)
    want = _oracle(_sums(key), table)
    if key is None:
        assert want["sum"] == [pydec.Decimal(sum(
            int(v) for v in table["d"].to_pylist()))]
    PAGG.reset_groupby_tiers()
    assert _port(_sums(key), table, conf) == want
    if tier is not None:
        assert PAGG.GROUPBY_TIERS[tier] >= 1
    assert _port(_sums(key), table, {**(conf or {}), **ORACLE}) == want


def test_the_issue_example_sums_to_the_exact_value_where_the_reference_wraps():
    # twenty 999999999999999999 as DECIMAL(18,0), grouped by k % 2
    table = pa.table({
        "k": pa.array(np.arange(20) % 2, pa.int64()),
        "d": pa.array([pydec.Decimal(BIG)] * 20, pa.decimal128(18, 0))})

    def build(a, e, t, c, s, tbl):
        return s.from_arrow(tbl).group_by("k").agg(
            (a.Sum(c("d")), "sum")).sort("k")
    want = _oracle(build, table)
    assert want["sum"] == [pydec.Decimal(9999999999999999990)] * 2
    assert _reference_device(build, table)["sum"] != want["sum"]
    assert _port(build, table) == want
    assert _port(build, table, ORACLE) == want

    def total(a, e, t, c, s, tbl):
        return s.from_arrow(tbl).agg((a.Sum(c("d")), "sum"))
    assert _port(total, table)["sum"] == [
        pydec.Decimal(19999999999999999980)]


def test_a_wide_sum_past_its_precision_is_null_not_wrapped():
    # SUM of DECIMAL(38,0) is DECIMAL(38,0): twenty 10^37 pass its 38
    # digits, so the sum is null, as Spark's non-ANSI sum is
    table = pa.table({"d": pa.array([_dec(10 ** 37)] * 20,
                                    pa.decimal128(38, 0))})

    def build(a, e, t, c, s, tbl):
        return s.from_arrow(tbl).agg((a.Sum(c("d")), "sum"))
    # (the reference's oracle raises building its 39-digit result)
    assert _port(build, table, ORACLE) == {"sum": [None]}
    assert _port(build, table) == {"sum": [None]}


def test_out_of_core_wide_sums_merge_their_half_lanes():
    rng = np.random.default_rng(9)
    n = 3000
    table = pa.table({
        "k": pa.array(rng.integers(0, 400, n), pa.int64()),
        "d": pa.array([pydec.Decimal(BIG - int(x)) for x in
                       rng.integers(0, 1000, n)], pa.decimal128(18, 0))})

    def build(a, e, t, c, s, tbl):
        return s.from_arrow(tbl).group_by("k").agg(
            (a.Sum(c("d")), "sum"), (a.Average(c("d")), "avg")).sort("k")
    conf = {"spark.rapids.tpu.sql.ooc.force": "true",
            "spark.rapids.tpu.sql.batchSizeRows": "512"}
    df = build(PA, PE, PT, pcol, PSession(conf, device="cpu"), table)
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("ooc.agg_elections", 0) >= 1
    assert got == _oracle(build, table)


# ---------------------------------------------------------------------------
# the CPU engine past int64
# ---------------------------------------------------------------------------

def _wide_operands():
    rng = np.random.default_rng(17)
    n = 40
    a = [int(x) * 10 ** 17 + int(y) for x, y in
         zip(rng.integers(-10 ** 9, 10 ** 9, n), rng.integers(0, 99, n))]
    b = [int(x) for x in rng.integers(-10 ** 6, 10 ** 6, n)]
    b[3] = 0
    return pa.table({
        "a": pa.array([pydec.Decimal(v).scaleb(-2) for v in a],
                      pa.decimal128(30, 2)),
        "b": pa.array([pydec.Decimal(v).scaleb(-3) for v in b],
                      pa.decimal128(9, 3)),
        "m": pa.array([pydec.Decimal("99999999999.99")] * n,
                      pa.decimal128(13, 2)),
        "i": pa.array(range(n), pa.int64())})


@pytest.mark.parametrize("op", ["Add", "Subtract", "Multiply", "Divide"])
def test_cpu_engine_arithmetic_past_int64_equals_the_oracle(op):
    table = _wide_operands()

    def build(a, e, t, c, s, tbl):
        f = getattr(e, op)
        return s.from_arrow(tbl).select(
            c("i"), e.Alias(f(c("a"), c("b")), "ab"),
            e.Alias(f(c("b"), c("a")), "ba"),
            e.Alias(f(c("m"), c("m")), "mm"))
    want = _oracle(build, table)
    if op == "Multiply":
        # the issue's example: exact where the int64 step leaves int64
        assert want["mm"][0] == pydec.Decimal("9999999999998000000000.0001")
    assert _port(build, table, ORACLE) == want


def test_cpu_engine_remainder_of_decimals_is_spark_s():
    # the reference's CPU engine cannot take a decimal %: the port gives
    # Spark's answer, the dividend's sign, at max(scale) and null for 0
    table = _wide_operands()

    def build(a, e, t, c, s, tbl):
        return s.from_arrow(tbl).select(
            c("i"), e.Alias(e.Remainder(c("a"), c("b")), "r"))
    got = _port(build, table, ORACLE)
    for a, b, r in zip(table["a"].to_pylist(), table["b"].to_pylist(),
                       got["r"]):
        if b == 0:
            assert r is None
        else:
            want = abs(a) % abs(b)
            assert r == (-want if a < 0 else want)


@pytest.mark.parametrize("to", ["decimal", "double", "long", "narrow"])
def test_cpu_engine_casts_of_wide_values_equal_the_oracle(to):
    table = _wide_operands()

    def build(a, e, t, c, s, tbl):
        dst = {"decimal": t.DecimalType(38, 4), "double": t.DOUBLE,
               "long": t.LONG, "narrow": t.DecimalType(18, 1)}[to]
        return s.from_arrow(tbl).select(
            c("i"), e.Alias(e.Cast(c("a"), dst), "x"),
            e.Alias(e.Cast(e.Multiply(c("m"), c("m")), dst), "y"))
    assert _port(build, table, ORACLE) == _oracle(build, table)


def test_cpu_engine_casts_wide_values_to_string_as_spark():
    # the reference's CPU engine gives null for a DECIMAL cast to STRING;
    # the port writes the exact value, as Spark does
    table = _wide_operands()

    def build(a, e, t, c, s, tbl):
        return s.from_arrow(tbl).select(
            e.Alias(e.Cast(c("a"), t.STRING), "x"),
            e.Alias(e.Cast(e.Multiply(c("m"), c("m")), t.STRING), "y"))
    got = _port(build, table, ORACLE)
    assert got["x"] == [format(v, "f") for v in table["a"].to_pylist()]
    assert set(got["y"]) == {"9999999999998000000000.0001"}


def test_cpu_engine_compares_sorts_groups_and_counts_distinct_wide_values():
    table = _wide_operands()

    def build(a, e, t, c, s, tbl):
        df = s.from_arrow(tbl)
        big = df.filter(e.GreaterThan(c("a"), c("m"))).select(
            e.Alias(e.Multiply(c("b"), e.Literal(10)), "g"), c("a"))
        return big.group_by("g").agg(
            (a.CountDistinct(c("a")), "n"), (a.Max(c("a")), "mx"),
            (a.Min(c("a")), "mn"), (a.Sum(c("a")), "s")).sort(
                ("mx", False, False))
    assert _port(build, table, ORACLE) == _oracle(build, table)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _placements():
    return {
        "filter": lambda a, e, t, c, df: df.filter(
            e.GreaterThan(c("a"), e.Literal(pydec.Decimal(0)))),
        "project": lambda a, e, t, c, df: df.select(
            e.Alias(e.Add(c("a"), c("a")), "x")),
        "cast_double": lambda a, e, t, c, df: df.select(
            e.Alias(e.Cast(c("a"), t.DOUBLE), "x")),
        "cast_long": lambda a, e, t, c, df: df.select(
            e.Alias(e.Cast(c("a"), t.LONG), "x")),
        "aggregate": lambda a, e, t, c, df: df.group_by("i").agg(
            (a.Max(c("a")), "x")),
        "count_distinct": lambda a, e, t, c, df: df.agg(
            (a.CountDistinct(e.Multiply(c("m"), c("m"))), "x")),
        "greatest": lambda a, e, t, c, df: df.select(
            e.Alias(e.Greatest(c("a"), c("a")), "x")),
    }


@pytest.mark.parametrize("case", sorted(_placements()))
def test_wide_host_placement_equals_the_reference(case):
    table = _wide_operands()
    make = _placements()[case]
    jdf = make(JA, JE, JT, jcol, JSession().from_arrow(table))
    pdf = make(PA, PE, PT, pcol, PSession(device="cpu").from_arrow(table))
    q = pdf.physical()
    assert q.explain() == jdf.physical().explain()
    want = JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict()
    got = q.collect().to_pydict()
    if case == "cast_double":
        # the device combines the two lanes in float64, as the
        # reference's device path does (then divides exactly): within
        # 2 ulp of the oracle's once-rounded quotient
        assert all(math.isclose(x, y, rel_tol=4.5e-16, abs_tol=0.0)
                   for x, y in zip(got["x"], want["x"]))
        return
    assert got == want


def test_a_device_consumer_without_a_two_lane_form_raises_past_int64():
    # UnaryMinus reads one int64 lane: over a finished wide sum that
    # stays inside int64 it runs; past it, it raises naming the slice
    def build(rows):
        table = pa.table({"d": pa.array([pydec.Decimal(BIG)] * rows,
                                        pa.decimal128(18, 0))})
        return PSession(device="cpu").from_arrow(table).agg(
            (PA.Sum(pcol("d")), "s")).select(
                PE.Alias(PE.UnaryMinus(pcol("s")), "neg"))
    assert build(5).to_pydict() == {"neg": [pydec.Decimal(-5 * BIG)]}
    with pytest.raises(NotImplementedError, match="two-lane device decimal forms"):
        build(20).to_pydict()


def test_two_lane_device_sum_lanes_match_python_ints():
    # the device's half-lane combination at the int64 edges, against
    # Python ints (CPU tensors: the plain path of the card's lanes)
    vals = torch.tensor([2 ** 63 - 1, -2 ** 63, -1, 0, 2 ** 32, -(2 ** 32),
                         123456789012345678], dtype=torch.int64)
    lo = vals & 0xFFFFFFFF
    hi = vals >> 32
    reps = 1000
    expr = PA._WideSumEvaluate(PE.Literal(0, PT.LONG),
                               PE.Literal(0, PT.LONG),
                               PT.DecimalType(38, 0))
    dv = expr._eval_dev(None, [PE.DevVal(lo * reps, None, PT.LONG),
                               PE.DevVal(hi * reps, None, PT.LONG)])
    got = [(h << 64) + (x & (2 ** 64 - 1)) for h, x in
           zip(dv.hi.tolist(), dv.data.tolist())]
    assert got == [v * reps for v in vals.tolist()]
    assert bool(dv.validity.all())


def _lanes(*xs):
    return [PE.DevVal(torch.tensor(x, dtype=torch.int64), None, PT.LONG)
            for x in xs]


def _literals(n):
    return [PE.Literal(0, PT.LONG) for _ in range(n)]


def test_the_half_lanes_are_exact_up_to_their_row_bound_and_raise_past_it():
    # the low lane's sum is read as unsigned: 2^32 - 1 rows of the
    # largest low half wrap int64 and still finish exactly
    n = PA.ROWS_EXACT
    lo = (2 ** 32 - 1) * n                       # past 2^63: wraps int64
    lo_wrapped = lo - 2 ** 64 if lo >= 2 ** 63 else lo
    hi = -(2 ** 31) * n
    expr = PA._WideSumEvaluate(*_literals(2), PT.DecimalType(38, 0))
    dv = expr._eval_dev(None, _lanes([lo_wrapped], [hi]))
    want = hi * 2 ** 32 + lo
    assert (dv.hi.item() << 64) + (dv.data.item() & (2 ** 64 - 1)) == want
    host = [PHOST.HostColumn(np.array(x, np.int64), None, PT.LONG)
            for x in ([lo_wrapped], [hi])]
    assert int(expr._eval_cpu(None, host).to_pylist()[0]) == want
    # an aggregation with a wide sum raises once its input rows pass the
    # bound (a forced count: the rows it has read so far); a narrow one
    # does not
    from spark_rapids_tpu_torch.config import TpuConf
    schema = PT.StructType([PT.StructField("d", PT.DecimalType(18, 0)),
                            PT.StructField("n", PT.DecimalType(8, 0))])
    batch = to_device(PHOST.from_numpy(
        {"d": np.arange(4), "n": np.arange(4)}, schema), capacity=4,
        device="cpu")
    for name, want_raise in (("d", True), ("n", False)):
        core = PAGG.HashAggregate(
            [], [], [(PA.Sum(pcol(name)).bind(schema), "s")], TpuConf({}))
        core.rows_read = n - 3
        if want_raise:
            with pytest.raises(NotImplementedError,
                               match="two-lane device decimal forms"):
                core.partial_fused(batch, [], raw=True)
        else:
            core.partial_fused(batch, [], raw=True)


def _avg_expected(total, count, shift, precision):
    """total * 10^shift / count, HALF_UP, in Python ints; None for an
    empty group and past the precision."""
    if count <= 0:
        return None
    num = total * 10 ** shift
    mag = (2 * abs(num) + count) // (2 * count)
    q = -mag if num < 0 else mag
    return q if abs(q) <= 10 ** precision - 1 else None


@pytest.mark.parametrize("wide", [True, False])
def test_decimal_average_finish_is_exact_where_the_upscaled_sum_leaves_int64(
        wide):
    # one finish for every DECIMAL average: groups whose sum, upscaled by
    # 10^4, fits int64 divide in one vectorised step, the others (sums
    # near and past 2^63) in Python ints; device lanes (CPU tensors) and
    # the CPU engine against Python ints, exactly
    rng = np.random.default_rng(7)
    if wide:
        totals = [0, 1, -1, 10 ** 14, -(10 ** 14), 2 ** 63 - 1, -2 ** 63,
                  2 ** 70 + 12345, -(2 ** 70) - 99, 10 ** 24 + 5]
        totals += [int(x) for x in rng.integers(-2 ** 62, 2 ** 62, 6)]
        out_t = PT.DecimalType(26, 6)       # AVG of a DECIMAL(22, 2)
    else:
        totals = [0, 1, -1, 10 ** 14, -(10 ** 14), 10 ** 17 - 3,
                  -(10 ** 17) + 3, 922337203685478, -922337203685478]
        totals += [int(x) for x in rng.integers(-10 ** 17, 10 ** 17, 6)]
        out_t = PT.DecimalType(12, 6)       # AVG of a DECIMAL(8, 2)
    counts = [3, 7, 0, 2, 9, 1, 1, 5, 11, 13, 4, 6, 8, 10, 12, 14][
        :len(totals)]
    if wide:
        lo = [x & 0xFFFFFFFF for x in totals]   # one row's half lanes
        hi = [x >> 32 for x in totals]
        assert all(-2 ** 63 <= h < 2 ** 63 for h in hi)
        sums, lanes = _literals(2), [lo, hi, counts]
    else:
        sums, lanes = _literals(1), [totals, counts]
    expr = PA._DecimalAvgEvaluate(sums, PE.Literal(0, PT.LONG), out_t, 4)
    want = [_avg_expected(s, c, 4, out_t.precision)
            for s, c in zip(totals, counts)]
    dv = expr._eval_dev(None, _lanes(*lanes))
    hi_words = dv.hi.tolist() if dv.hi is not None else \
        (dv.data >> 63).tolist()
    got = [(h << 64) + (x & (2 ** 64 - 1)) if ok else None
           for h, x, ok in zip(hi_words, dv.data.tolist(),
                               dv.validity.tolist())]
    assert got == want
    host = [PHOST.HostColumn(np.array(x, np.int64), None, PT.LONG)
            for x in lanes]
    col = expr._eval_cpu(None, host)
    assert [None if v is None else int(v.scaleb(out_t.scale))
            for v in col.to_pylist()] == want


def test_wide_column_builds_int64_rows_in_numpy_and_the_rest_exactly():
    # the CPU engine's column builder: an object array whose values all
    # fit int64 takes the numpy path; one past it keeps its high word;
    # past the precision is null
    dt = PT.DecimalType(20, 0)
    vals = [0, -1, 2 ** 63 - 1, -2 ** 63, 10 ** 19, -(10 ** 20)]
    from spark_rapids_tpu_torch.ops import host as H
    narrow = H.wide_column(np.array(vals[:4], object), None, dt)
    assert narrow.hi is None and narrow.data.dtype == np.int64
    wide = H.wide_column(np.array(vals, object), None, dt)
    assert [None if v is None else int(v) for v in wide.to_pylist()] == \
        vals[:5] + [None]
    h = np.array([x >> 32 for x in vals[:5]], np.int64)
    a_lo = np.array([x & 0xFFFFFFFF for x in vals[:5]], np.int64)
    words = H.words_column(h, a_lo, None, dt)
    assert [int(v) for v in words.to_pylist()] == vals[:5]


def test_an_average_projects_each_input_once_and_counts_from_it():
    # an AVG's count reads its sum's input object (a wide AVG's high
    # half): the aggregate projects two inputs for a wide SUM, two for a
    # wide AVG and one for a narrow DECIMAL AVG, and the group-by tiers
    # sum each count and its input's valid count as one lane
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import groupby as G
    schema = PT.StructType([PT.StructField("d", PT.DecimalType(18, 0)),
                            PT.StructField("n", PT.DecimalType(8, 2))])
    aggs = [(PA.Sum(pcol("d")).bind(schema), "s"),
            (PA.Average(pcol("d")).bind(schema), "a"),
            (PA.Average(pcol("n")).bind(schema), "b")]
    core = PAGG.HashAggregate([], [], aggs, TpuConf({}))
    assert len(core.input_exprs) == 5
    assert [s.input_idx for s in core.update_specs] == [0, 1, 2, 3, 3, 4, 4]
    live = torch.ones(4, dtype=torch.bool)
    lanes = [(torch.arange(4), live)] * len(core.update_specs)
    int_lanes, slots, _f, _fs = G._queue_sum_lanes(core.update_specs,
                                                   lanes, live)
    # a sum and a valid count per input; the COUNTs of inputs 3 and 4
    # are their valid counts
    assert len(int_lanes) == 10
    assert G.sum_lane_key(core.update_specs[4], 4) == ("vc", 3)
