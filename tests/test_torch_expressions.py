"""The port's conditional, null, IN, cast, date-field and string-equality
expressions and its cross join, against the JAX package.

Each case feeds the same Arrow table (made here from fixed values or a
numpy seed) to both packages; the port runs on CPU tensors.  Results
must equal the JAX package's device path exactly, and its CPU oracle
(sql.enabled=false) where the oracle agrees with it: the floating to
LONG cast of values at or past 2^63 is the one case where it does not
(the oracle's numpy cast wraps to Long.MIN; the reference saturates at
the double below 2^63, and the port does as the reference).
"""
import datetime as pydt

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import datetime as JDK
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import datetime as JDT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.ops import datetime as PDK
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import datetime as PDT
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

J = (JE, jcol, JT, JDT, JA)
P = (PE, pcol, PT, PDT, PA)
ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}


def _run(table, build, conf=None):
    """(port, reference, oracle) results of `build(E, col, T, DT, A,
    df)` over `table` in each package."""
    jdf = build(*J, JSession(conf).from_arrow(table))
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession({**(conf or {}), **ORACLE})) \
        .collect().to_pydict()
    got = build(*P, PSession(conf, device="cpu").from_arrow(table)) \
        .to_pydict()
    return got, ref, oracle


def _select(fn):
    """A build that projects `fn(E, col, T, DT)` aliased as r."""
    return lambda E, c, T, DT, A, df: df.select(E.Alias(fn(E, c, T, DT), "r"))


NUMS = pa.table({
    "x": pa.array([1, 2, None, 4, 5, 3, None], pa.int64()),
    "f": pa.array([0.5, None, 2.0, -1.0, 3.5, float("nan"), 1.0]),
    "s1": pa.array(["MAIL", None, "SHIP", "AIR", "MAIL", "RAIL", "SHIP"]),
    "s2": pa.array(["zeta", "alpha", None, "beta", "alpha", "beta", "gamma"]),
})


@pytest.mark.parametrize("column,items", [
    ("x", [1, 4]), ("x", [1, None]), ("x", [None]), ("x", []),
    ("s1", ["MAIL", "SHIP"]), ("s1", ["MAIL", None]), ("s1", ["TRUCK"]),
    ("s1", [None]), ("s1", ["TRUCK", None])])
def test_in_matches_reference_with_spark_null_semantics(column, items):
    got, ref, oracle = _run(NUMS, _select(
        lambda E, c, T, DT: E.In(c(column), items)))
    assert got == ref == oracle


CASES = {
    "no_else": lambda E, c, T, DT: E.CaseWhen(
        [(E.GreaterThan(c("x"), E.Literal(2)), E.Literal(10))]),
    "null_predicate_falls_through": lambda E, c, T, DT: E.CaseWhen(
        [(E.GreaterThan(c("x"), E.Literal(2)), c("x")),
         (E.IsNull(c("x")), E.Literal(-7))], E.Literal(-1)),
    "double_values": lambda E, c, T, DT: E.CaseWhen(
        [(E.EqualTo(c("s1"), E.Literal("MAIL")), c("f"))], E.Literal(0.0)),
    "null_first_value_types_by_the_next": lambda E, c, T, DT: E.CaseWhen(
        [(E.LessThan(c("x"), E.Literal(2)), E.Literal(None)),
         (E.GreaterThan(c("x"), E.Literal(3)), c("f"))]),
    "strings_from_two_dictionaries": lambda E, c, T, DT: E.CaseWhen(
        [(E.GreaterThan(c("x"), E.Literal(2)), c("s1")),
         (E.IsNull(c("x")), c("s2"))], E.Literal("other")),
    "strings_no_else": lambda E, c, T, DT: E.CaseWhen(
        [(E.In(c("s1"), ["MAIL", "AIR"]), c("s2"))]),
    "if": lambda E, c, T, DT: E.If(
        E.GreaterThan(c("x"), E.Literal(2)), c("f"), E.Literal(-1.0)),
    "if_null_predicate_takes_else": lambda E, c, T, DT: E.If(
        E.EqualTo(c("x"), E.Literal(None, T.LONG)), c("x"), E.Literal(0)),
    "is_null": lambda E, c, T, DT: E.IsNull(c("x")),
    "is_not_null": lambda E, c, T, DT: E.IsNotNull(c("s2")),
    "is_null_of_a_comparison": lambda E, c, T, DT: E.IsNull(
        E.LessThan(c("f"), E.Literal(1.0))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conditionals_match_reference_and_cpu_oracle(case):
    got, ref, oracle = _run(NUMS, _select(CASES[case]))
    assert repr(got) == repr(ref) == repr(oracle)


def test_string_if_refuses():
    # no longer refused: a string-valued IF runs on the CPU engine, where
    # the reference's tagging puts it, and equals the reference
    df = PSession(device="cpu").from_arrow(NUMS).select(PE.Alias(PE.If(
        PE.IsNull(pcol("x")), pcol("s1"), pcol("s2")), "r"))
    q = df.physical()
    assert q.kind == "host"
    assert q.fallback_reasons() == [
        "expression If: string-valued if not yet on device"]
    want = JSession().from_arrow(NUMS).select(JE.Alias(JE.If(
        JE.IsNull(jcol("x")), jcol("s1"), jcol("s2")), "r")).collect()
    assert q.collect().to_pydict() == want.to_pydict()


FLOATS = [float("nan"), float("inf"), float("-inf"), 0.5, -0.5, 1.5, -1.5,
          -0.0, 127.9, 128.0, -129.0, 40000.0, 3e9, -3e9, 9.3e18, 1e19,
          -1e19, None]


@pytest.mark.parametrize("src", ["double", "float"])
@pytest.mark.parametrize("dst", ["BYTE", "INT", "LONG"])
def test_floating_to_integral_cast_truncates_and_clamps_as_reference(src,
                                                                     dst):
    table = pa.table({"f": pa.array(FLOATS, pa.float64()
                                    if src == "double" else pa.float32())})
    got, ref, oracle = _run(table, _select(
        lambda E, c, T, DT: E.Cast(c("f"), getattr(T, dst))))
    assert got == ref
    if dst != "LONG":
        assert got == oracle
    else:
        # NaN -> 0, truncation toward zero, saturation below 2^63
        assert got["r"][:7] == [0, 2 ** 63 - 1024, -2 ** 63, 0, 0, 1, -1]


# days -1,000,000 .. 1,000,000 (years -768 to 4707), the days around a
# few centuries' February 29ths, and the int32 ends
LEAP_DAYS = [(pydt.date(y, 2, 29) - pydt.date(1970, 1, 1)).days + k
             for y in (1600, 1904, 1968, 1972, 2000, 2024, 2400)
             for k in (-1, 0, 1)]
DAYS = np.concatenate([np.arange(-1_000_000, 1_000_001, dtype=np.int64),
                       LEAP_DAYS,
                       [-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 2, 2 ** 31 - 1]]
                      ).astype(np.int32)
#: 0000-03-01: the reference's calendar holds from this day on
ERA0 = -719_468


def _numpy_calendar(days: np.ndarray) -> dict:
    """The proleptic Gregorian fields of numpy's datetime64 (year 0
    exists, as in java.time), the yardstick independent of both
    packages."""
    d64 = days.astype(np.int64)
    d = d64.astype("datetime64[D]")
    year = d.astype("datetime64[Y]")
    month = d.astype("datetime64[M]")
    y = year.astype(np.int64) + 1970
    m = month.astype(np.int64) - year.astype("datetime64[M]").astype(
        np.int64) + 1
    wd = (d64 + 3) % 7
    thursday = d64 + 3 - wd
    jan1 = thursday.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype("datetime64[D]").astype(np.int64)
    day = (d - month.astype("datetime64[D]")).astype(np.int64) + 1
    return {"civil_from_days": (y, m, day),
            "day_of_year": (d - year.astype("datetime64[D]")).astype(
                np.int64) + 1,
            "day_of_week_sunday1": (d64 + 4) % 7 + 1,
            "weekday_monday0": wd,
            "iso_week": (thursday - jan1) // 7 + 1}


CALENDAR = _numpy_calendar(DAYS)


@pytest.mark.parametrize("fn", sorted(CALENDAR))
def test_calendar_functions_match_numpy_and_reference(fn):
    want = getattr(JDK, fn)(jnp.asarray(DAYS))
    got = getattr(PDK, fn)(torch.from_numpy(DAYS))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    cal = CALENDAR[fn] if isinstance(CALENDAR[fn], tuple) else (CALENDAR[fn],)
    # the reference's int32 Thursday wraps within 3 days of the top end
    same = (DAYS >= ERA0) & ((DAYS < 2 ** 31 - 3) | (fn != "iso_week"))
    for g, w, c in zip(got, want, cal):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), c)
        np.testing.assert_array_equal(g.numpy()[same], np.asarray(w)[same])


def test_reference_calendar_deviates_before_year_zero():
    # pins README's deviation: the reference's era is one too few for
    # days before 0000-03-01 whose era does not start them; the port
    # follows the calendar
    early = DAYS[DAYS < ERA0]
    y_ref = np.asarray(JDK.civil_from_days(jnp.asarray(early))[0])
    y_cal = CALENDAR["civil_from_days"][0][DAYS < ERA0]
    assert (y_ref != y_cal).any()
    np.testing.assert_array_equal(
        PDK.civil_from_days(torch.from_numpy(early))[0].numpy(), y_cal)


def test_days_from_civil_inverts_and_matches_reference():
    y, m, d = PDK.civil_from_days(torch.from_numpy(DAYS))
    back = PDK.days_from_civil(y, m, d)
    np.testing.assert_array_equal(back.numpy(), DAYS)
    same = DAYS >= ERA0
    np.testing.assert_array_equal(back.numpy()[same], np.asarray(
        JDK.days_from_civil(jnp.asarray(y.numpy()), jnp.asarray(m.numpy()),
                            jnp.asarray(d.numpy())))[same])
    np.testing.assert_array_equal(
        PDK.is_leap(y).numpy(), np.asarray(JDK.is_leap(jnp.asarray(
            y.numpy()))))
    np.testing.assert_array_equal(
        PDK.days_in_month(y, m).numpy(), np.asarray(JDK.days_in_month(
            jnp.asarray(y.numpy()), jnp.asarray(m.numpy()))))


FIELDS = {"Year": lambda c: c["civil_from_days"][0],
          "Month": lambda c: c["civil_from_days"][1],
          "DayOfMonth": lambda c: c["civil_from_days"][2],
          "DayOfWeek": lambda c: c["day_of_week_sunday1"],
          "WeekDay": lambda c: c["weekday_monday0"],
          "DayOfYear": lambda c: c["day_of_year"],
          "Quarter": lambda c: (c["civil_from_days"][1] - 1) // 3 + 1,
          "WeekOfYear": lambda c: c["iso_week"]}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_date_fields_match_reference_and_calendar(field):
    days = np.concatenate([DAYS[:-4][::97], DAYS[-4:]])
    valid = np.arange(len(days)) % 11 != 5
    table = pa.table({"d": pa.array(days, pa.int32(),
                                    mask=~valid).cast(pa.date32())})
    got, ref, _ = _run(table, _select(
        lambda E, c, T, DT: getattr(DT, field)(c("d"))))
    want = FIELDS[field](_numpy_calendar(days))
    assert got["r"] == [int(w) if v else None for w, v in zip(want, valid)]
    same = (days >= ERA0) & (days < 2 ** 31 - 3)
    assert [g for g, k in zip(got["r"], same) if k] == \
        [r for r, k in zip(ref["r"], same) if k]
    # the CPU oracle's calendar holds years 1 to 9999
    civil = pa.table({"d": table["d"].filter(pa.array(
        (days > -719_000) & (days < 2_900_000)))})
    got, ref, oracle = _run(civil, _select(
        lambda E, c, T, DT: getattr(DT, field)(c("d"))))
    assert got == ref == oracle


def test_timestamp_fields_refuse():
    # the DATE fields of a TIMESTAMP take its local day in the session
    # zone (tests/test_torch_timezone.py): no longer refused
    table = pa.table({"ts": pa.array([0, 86_400_000_000, -1],
                                     pa.timestamp("us", tz="UTC"))})
    got, ref, oracle = _run(table, _select(
        lambda E, c, T, DT: DT.Year(c("ts"))))
    assert got == ref == oracle
    assert got["r"] == [1970, 1970, 1969]


DICTS = {"disjoint": (["a", "b", "c"], ["x", "y"]),
         "overlapping": (["a", "b", "c"], ["b", "c", "d"]),
         "repeating": (["b", "a", "b", "c"], ["c", "a", "c"])}


@pytest.mark.parametrize("dicts", sorted(DICTS))
@pytest.mark.parametrize("op", ["EqualTo", "NotEqual"])
def test_string_column_equality_matches_reference(dicts, op):
    da, db = DICTS[dicts]
    rng = np.random.default_rng(len(dicts) * 7 + len(op))
    n = 300
    ca = rng.integers(0, len(da), n).astype(np.int32)
    cb = rng.integers(0, len(db), n).astype(np.int32)
    va, vb = rng.random(n) > 0.1, rng.random(n) > 0.1
    table = pa.table({
        "a": pa.DictionaryArray.from_arrays(pa.array(ca, mask=~va),
                                            pa.array(da)),
        "b": pa.DictionaryArray.from_arrays(pa.array(cb, mask=~vb),
                                            pa.array(db))})
    jdf = JSession().from_arrow(table).select(
        JE.Alias(getattr(JE, op)(jcol("a"), jcol("b")), "r"))
    ref = jdf.collect().to_pydict()["r"]
    # the port's batch keeps the dictionaries as they are, repeats
    # included (a computed dictionary may repeat; a scanned one does not)
    batch = HostBatch([HostColumn(np.where(va, ca, 0), va, PT.STRING,
                                  np.array(da, str)),
                       HostColumn(np.where(vb, cb, 0), vb, PT.STRING,
                                  np.array(db, str))], ["a", "b"])
    got = PSession(device="cpu").from_host(batch).select(
        PE.Alias(getattr(PE, op)(pcol("a"), pcol("b")), "r")) \
        .to_pydict()["r"]
    plain = [None if not (x and y) else (da[i] == db[j]) == (op == "EqualTo")
             for i, j, x, y in zip(ca, cb, va, vb)]
    assert got == ref == plain
    assert None in got and True in got or dicts == "disjoint"


LEFT = pa.table({"k": pa.array(np.arange(2500), pa.int64()),
                 "x": pa.array(np.linspace(-1, 1, 2500))})
RIGHT = pa.table({"r": pa.array([3, 1, 2], pa.int64()),
                  "s": pa.array(["u", None, "w"])})
CROSS = {
    "one_row_build": lambda E, c, T, A, l, r: l.join(
        r.agg((A.Sum(c("r")), "tot"), (A.Count(None), "n")), how="cross"),
    "one_row_build_through_a_projection": lambda E, c, T, A, l, r: l.join(
        r.agg((A.Max(c("r")), "m")).select(
            E.Multiply(c("m"), E.Literal(2)), names=["m2"]), how="cross"),
    "multi_row_build": lambda E, c, T, A, l, r: l.join(r, how="cross"),
    "empty_build": lambda E, c, T, A, l, r: l.join(
        r.filter(E.LessThan(c("r"), E.Literal(0))), how="cross"),
    "empty_probe": lambda E, c, T, A, l, r: l.filter(
        E.LessThan(c("k"), E.Literal(0))).join(r, how="cross"),
    "filtered_probe": lambda E, c, T, A, l, r: l.filter(
        E.GreaterThan(c("x"), E.Literal(0.5))).join(r, how="cross"),
}


@pytest.mark.parametrize("batch_rows", [None, "1024"])
@pytest.mark.parametrize("case", sorted(CROSS))
def test_cross_join_matches_reference(case, batch_rows, monkeypatch):
    conf = {} if batch_rows is None else \
        {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}

    def build(E, c, T, DT, A, df, s):
        return CROSS[case](E, c, T, A, df, s.from_arrow(RIGHT))
    js = JSession(conf)
    jdf = build(*J, js.from_arrow(LEFT), js)
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession({**conf, **ORACLE})).collect()
    if case.startswith("one_row"):
        # a scalar build is broadcast: nothing materializes the build
        from spark_rapids_tpu_torch.exec import join as PJ

        def refuse(*a, **k):
            raise AssertionError("the one-row build was materialized")
        monkeypatch.setattr(PJ, "concat_batches", refuse)
    ps = PSession(conf, device="cpu")
    got = build(*P, ps.from_arrow(LEFT), ps).to_pydict()
    assert got == ref
    rows = sorted(zip(*got.values()), key=repr)
    assert rows == sorted(zip(*oracle.to_pydict().values()), key=repr)
    n_left = {"empty_probe": 0, "filtered_probe": 625}.get(case, 2500)
    n_right = {"empty_build": 0, "multi_row_build": 3,
               "empty_probe": 3, "filtered_probe": 3}.get(case, 1)
    assert len(rows) == n_left * n_right
