"""Session timezones and the TIMESTAMP fields (ops/timezone.py,
plan/datetime.py, the DATE <-> TIMESTAMP casts) against the JAX package
and an independent zoneinfo oracle.

The eleven cases of tests/test_timezone.py run through the port (its
device path on CPU tensors, and its CPU engine) and are held to
zoneinfo; the transition tables are held bit for bit to the reference's.
Then every datetime class this slice adds, the DATE fields of a
TIMESTAMP and both casts run over TPC-H 0.001's l_shipdate (and a
TIMESTAMP built from it) under UTC, America/Los_Angeles and
Africa/Casablanca, and equal the reference's device path and its CPU
oracle row for row.
"""
import datetime as dt
from zoneinfo import ZoneInfo

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import timezone as JTZ
from spark_rapids_tpu.plan import datetime as JDT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops import timezone as PTZ
from spark_rapids_tpu_torch.plan import datetime as PDT
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

LA = "America/Los_Angeles"
TZCONF = {"spark.sql.session.timeZone": LA}
CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false"}
UTC = dt.timezone.utc
ZONES = ["UTC", LA, "Africa/Casablanca"]


def _sessions(conf):
    """The port's device path (CPU tensors) and its CPU engine."""
    return (PSession(dict(conf), device="cpu"),
            PSession({**conf, **CPU_ENGINE}, device="cpu"))


def _ts_table():
    base = [
        dt.datetime(2024, 3, 10, 9, 59, 0),     # just before spring-forward
        dt.datetime(2024, 3, 10, 10, 1, 0),     # just after (PST -> PDT)
        dt.datetime(2024, 11, 3, 8, 30, 0),     # inside the fall-back overlap
        dt.datetime(2024, 7, 4, 0, 0, 0),
        dt.datetime(2023, 12, 25, 23, 59, 59),
        dt.datetime(1999, 1, 1, 12, 0, 0),
        dt.datetime(1969, 12, 31, 23, 59, 59),  # before the epoch
    ]
    return pa.table({"ts": pa.array([b.replace(tzinfo=UTC) for b in base],
                                    pa.timestamp("us", tz="UTC"))}), base


def _oracle_local(base, zone=LA):
    return [b.replace(tzinfo=UTC).astimezone(ZoneInfo(zone)) for b in base]


def _both(conf, build):
    return [build(s).to_pydict() for s in _sessions(conf)]


def test_hour_minute_la():
    tbl, base = _ts_table()
    loc = _oracle_local(base)
    for s in _sessions(TZCONF):
        q = s.from_arrow(tbl).select(
            PE.Alias(PDT.Hour(pcol("ts")), "h"),
            PE.Alias(PDT.Minute(pcol("ts")), "m"),
            PE.Alias(PDT.Second(pcol("ts")), "sec")).physical()
        assert q.kind == ("host" if s.conf.get_raw(
            "spark.rapids.tpu.sql.enabled") == "false" else "device")
        out = q.collect().to_pydict()
        assert out["h"] == [x.hour for x in loc]
        assert out["m"] == [x.minute for x in loc]
        assert out["sec"] == [x.second for x in loc]


def test_date_fields_la():
    tbl, base = _ts_table()
    loc = _oracle_local(base)
    for out in _both(TZCONF, lambda s: s.from_arrow(tbl).select(
            PE.Alias(PDT.Year(pcol("ts")), "y"),
            PE.Alias(PDT.Month(pcol("ts")), "mo"),
            PE.Alias(PDT.DayOfMonth(pcol("ts")), "d"))):
        assert out["y"] == [x.year for x in loc]
        assert out["mo"] == [x.month for x in loc]
        assert out["d"] == [x.day for x in loc]


def test_cpu_engine_agrees():
    tbl, _ = _ts_table()
    a, b = _both(TZCONF, lambda s: s.from_arrow(tbl).select(
        PE.Alias(PDT.Hour(pcol("ts")), "h"),
        PE.Alias(PDT.DayOfMonth(pcol("ts")), "d")))
    assert a == b


def test_utc_default_unchanged():
    tbl, base = _ts_table()
    for out in _both({}, lambda s: s.from_arrow(tbl).select(
            PE.Alias(PDT.Hour(pcol("ts")), "h"))):
        assert out["h"] == [b.hour for b in base]


def test_ts_to_date_la():
    tbl, base = _ts_table()
    loc = _oracle_local(base)
    for out in _both(TZCONF, lambda s: s.from_arrow(tbl).select(
            PE.Alias(PE.Cast(pcol("ts"), PT.DATE), "d"))):
        assert out["d"] == [x.date() for x in loc]


def test_date_to_ts_is_local_midnight():
    dates = [dt.date(2024, 3, 10), dt.date(2024, 11, 3), dt.date(2024, 7, 4),
             dt.date(1999, 1, 1), dt.date(1969, 12, 31)]
    tbl = pa.table({"d": pa.array(dates, pa.date32())})
    z = ZoneInfo(LA)
    for out in _both(TZCONF, lambda s: s.from_arrow(tbl).select(
            PE.Alias(PE.Cast(pcol("d"), PT.TIMESTAMP), "ts"))):
        for g, d in zip(out["ts"], dates):
            exp = dt.datetime(d.year, d.month, d.day, tzinfo=z)
            assert g.replace(tzinfo=UTC) == exp.astimezone(UTC), (g, d)


def test_to_unix_timestamp_of_date_la():
    dates = [dt.date(2024, 7, 4), dt.date(2023, 12, 25), dt.date(1960, 5, 1)]
    tbl = pa.table({"d": pa.array(dates, pa.date32())})
    z = ZoneInfo(LA)
    exp = [int(dt.datetime(d.year, d.month, d.day, tzinfo=z).timestamp())
           for d in dates]
    for out in _both(TZCONF, lambda s: s.from_arrow(tbl).select(
            PE.Alias(PDT.ToUnixTimestamp(pcol("d")), "u"))):
        assert out["u"] == exp


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_random_instants_vs_zoneinfo(lib):
    rng = np.random.default_rng(5)
    lo = int(dt.datetime(1971, 1, 1, tzinfo=UTC).timestamp())
    hi = int(dt.datetime(2037, 1, 1, tzinfo=UTC).timestamp())
    us = rng.integers(lo, hi, 3000) * 1_000_000
    for zone in (LA, "Europe/Berlin", "Asia/Kolkata", "Australia/Sydney",
                 "Australia/Lord_Howe"):
        # the reference's bisection stops within a second of each
        # transition, the port's at its microsecond (README "Deviations")
        pts, offs = PTZ.transition_table(zone)
        jpts, joffs = JTZ.transition_table(zone)
        assert np.array_equal(offs, joffs)
        assert ((jpts - pts >= 0) & (jpts - pts < 1_000_000)).all()
        wp, wo = PTZ.wall_table(zone)
        jwp, jwo = JTZ.wall_table(zone)
        assert np.array_equal(wo, jwo)
        assert ((jwp - wp >= 0) & (jwp - wp < 1_000_000)).all()
        if lib == "torch":
            pts, offs = PTZ.device_table(zone, torch.device("cpu"))
            loc = PTZ.utc_to_local(torch.from_numpy(us), pts, offs).numpy()
        else:
            loc = PTZ.utc_to_local(us, pts, offs)
        z = ZoneInfo(zone)
        for u, got in zip(us[:500].tolist(), loc[:500].tolist()):
            d = dt.datetime.fromtimestamp(u / 1e6, UTC).astimezone(z)
            assert d.replace(tzinfo=UTC).timestamp() * 1e6 == got, (zone, u)


@pytest.mark.parametrize("zone", [LA, "Australia/Lord_Howe",
                                  "Africa/Casablanca"])
def test_instants_on_a_transition_take_its_new_offset(zone):
    """An instant on a transition's first second, and a second either
    side, takes zoneinfo's offset (the reference's table switches up to
    a second late and reads the old offset there)."""
    pts, offs = PTZ.transition_table(zone)
    z = ZoneInfo(zone)
    us = np.array([int(p) + d for p in pts[1:] for d in (-1_000_000, 0,
                                                         1_000_000)
                   if int(p) < 4_000_000_000_000_000])
    got = PTZ.utc_to_local(us, pts, offs)
    want = [u + int(dt.datetime.fromtimestamp(u / 1e6, UTC).astimezone(z)
                    .utcoffset().total_seconds()) * 1_000_000
            for u in us.tolist()]
    assert got.tolist() == want
    loc = _sessions({"spark.sql.session.timeZone": zone})
    table = pa.table({"ts": pa.array(us).cast(pa.timestamp("us",
                                                           tz="UTC"))})
    for s in loc:
        out = s.from_arrow(table).select(
            PE.Alias(PDT.Hour(pcol("ts")), "h"),
            PE.Alias(PDT.Minute(pcol("ts")), "m")).to_pydict()
        assert [(h * 60 + m) * 60_000_000 for h, m in
                zip(out["h"], out["m"])] == \
            [(w % 86_400_000_000) // 60_000_000 * 60_000_000 for w in want]


def _wall(y, mo, d, h, mi):
    return int((dt.datetime(y, mo, d, h, mi) - dt.datetime(1970, 1, 1))
               .total_seconds()) * 10 ** 6


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_skipped_wall_shifts_forward(lib):
    """java.time and Spark: a wall time inside the spring-forward gap
    shifts forward by the gap (02:30 in New York's gap -> 07:30 UTC)."""
    wp, wo = PTZ.wall_table("America/New_York")
    wall = np.array([_wall(2024, 3, 10, 2, 30)])
    if lib == "torch":
        wp, wo, wall = (torch.from_numpy(a) for a in (wp, wo, wall))
    got = int(PTZ.local_to_utc(wall, wp, wo)[0])
    assert dt.datetime.fromtimestamp(got / 1e6, UTC) == \
        dt.datetime(2024, 3, 10, 7, 30, tzinfo=UTC)


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_ambiguous_wall_takes_earlier_offset(lib):
    wp, wo = PTZ.wall_table("America/New_York")
    wall = np.array([_wall(2024, 11, 3, 1, 30)])
    if lib == "torch":
        wp, wo, wall = (torch.from_numpy(a) for a in (wp, wo, wall))
    got = int(PTZ.local_to_utc(wall, wp, wo)[0])
    assert dt.datetime.fromtimestamp(got / 1e6, UTC) == \
        dt.datetime(2024, 11, 3, 5, 30, tzinfo=UTC)


def test_paired_transitions_casablanca():
    """Morocco suspends DST for Ramadan: paired transitions weeks apart
    that a coarse probe window would cancel out."""
    pts, offs = PTZ.transition_table("Africa/Casablanca")
    z = ZoneInfo("Africa/Casablanca")
    for probe in (dt.datetime(2023, 4, 1, 12, tzinfo=UTC),
                  dt.datetime(2023, 6, 1, 12, tzinfo=UTC),
                  dt.datetime(2024, 3, 20, 12, tzinfo=UTC)):
        us = np.array([int(probe.timestamp()) * 10 ** 6])
        loc = int(PTZ.utc_to_local(us, pts, offs)[0])
        exp = probe.astimezone(z)
        got = dt.datetime.fromtimestamp(loc / 1e6, UTC)
        assert (got.hour, got.minute) == (exp.hour, exp.minute), probe


# ---------------------------------------------------------------------------
# every class and cast over TPC-H 0.001's l_shipdate, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shipdates():
    li = JTPCH.gen_tables(0.001)["lineitem"]
    ship = li.column("l_shipdate")
    okey = np.asarray(li.column("l_orderkey").to_numpy(), np.int64)
    days = np.asarray(ship.cast(pa.int32()).to_numpy(), np.int64)
    # a TIMESTAMP lane: the ship day plus a time of day from the order key
    us = (days * 86_400 + okey * 7919 % 86_400) * 1_000_000
    n = len(days)
    rng = np.random.default_rng(9)
    return pa.table({
        "d": ship, "d2": pa.array(np.roll(days, 7).astype(np.int32),
                                  mask=rng.random(n) < 0.03).cast(
            pa.date32()),
        "ts": pa.array(us, mask=rng.random(n) < 0.03).cast(
            pa.timestamp("us", tz="UTC")),
        "n": pa.array(rng.integers(-30, 30, n).astype(np.int32)),
        "m": pa.array(rng.integers(-40, 40, n).astype(np.int32),
                      mask=rng.random(n) < 0.03)})


def _exprs(m, dtm, c):
    T = PT if m is PE else JT
    return [
        m.Alias(dtm.Hour(c("ts")), "hour"),
        m.Alias(dtm.Minute(c("ts")), "minute"),
        m.Alias(dtm.Second(c("ts")), "second"),
        m.Alias(dtm.Year(c("ts")), "year"),
        m.Alias(dtm.Month(c("ts")), "month"),
        m.Alias(dtm.DayOfMonth(c("ts")), "day"),
        m.Alias(dtm.DayOfWeek(c("ts")), "dow"),
        m.Alias(dtm.DayOfYear(c("ts")), "doy"),
        m.Alias(dtm.WeekOfYear(c("ts")), "woy"),
        m.Alias(m.Cast(c("ts"), T.DATE), "ts_date"),
        m.Alias(m.Cast(c("d"), T.TIMESTAMP), "d_ts"),
        m.Alias(dtm.ToUnixTimestamp(c("ts")), "unix_ts"),
        m.Alias(dtm.ToUnixTimestamp(c("d")), "unix_d"),
        m.Alias(dtm.DateAdd(c("d"), c("n")), "add"),
        m.Alias(dtm.DateSub(c("d"), 45), "sub"),
        m.Alias(dtm.DateDiff(c("d"), c("d2")), "diff"),
        m.Alias(dtm.AddMonths(c("d"), c("m")), "add_m"),
        m.Alias(dtm.LastDay(c("d")), "last"),
        m.Alias(dtm.TruncDate(c("d"), "year"), "t_year"),
        m.Alias(dtm.TruncDate(c("d"), "quarter"), "t_quarter"),
        m.Alias(dtm.TruncDate(c("d"), "mm"), "t_month"),
        m.Alias(dtm.TruncDate(c("d"), "week"), "t_week")]


@pytest.mark.parametrize("zone", ZONES)
def test_new_classes_and_casts_equal_reference(shipdates, zone):
    conf = {"spark.sql.session.timeZone": zone}

    def jbuild(s):
        return s.from_arrow(shipdates).select(*_exprs(JE, JDT, jcol))
    want = jbuild(JSession(conf)).collect().to_pydict()
    oracle = JDF(jbuild(JSession(conf))._plan, JSession(
        {**conf, **CPU_ENGINE})).collect().to_pydict()
    assert want == oracle
    for got in _both(conf, lambda s: s.from_arrow(shipdates).select(
            *_exprs(PE, PDT, pcol))):
        for name in want:
            assert got[name] == want[name], (zone, name)
