"""The joins phase of chip_smoke.py: the join tiers, the bloom runtime
filter and Spark's hashes on the card, at SF10 on the data phase's TPC-H
columns.

  * dense_* — q3, q4, q19, q22, m2m, outer and semi under
    `sql.kernels.pallas.join.denseReplace` AUTO and OFF (the port's
    default is ON, which phase 5 ran), each equal to phase 5's numpy
    result and printed beside phase 5's ON walls with the join tier
    counters (`join_dense_domain`, `join_pallas_hash`) and the kernel
    fallbacks; some join of the seven must run the dense tier under AUTO,
    and again under OFF.
  * bloom_q3, bloom_sel — q3, and lineitem ⋈ the orders of March 1995
    (about 1.3 % of 15,000,000, every one of the 60,012,150 lineitem rows
    probing), each with the runtime filter on (the default) and off, and
    full-width scan lanes (`encoded.narrow.lanes=OFF`: narrowed, the
    stages' bytes put bloom_sel's probe under 4 x its build); equal to
    numpy both ways; bloom_sel must filter rows.
  * ck_str2, ck_str_int, ck_wide — composite keys on the multi-lane
    sorted tier: orders ⋈ its 15-row (o_orderpriority, o_orderstatus)
    counts on both strings; lineitem ⋈ its (l_shipmode, l_tax) average
    quantity (63 rows; the port's generator, the reference's, has no
    l_linenumber), kept where l_quantity exceeds it (q17's shape);
    lineitem ⋈ its rows of l_discount <= 0.02 (3 of its 11 values: about
    16,400,000) on (l_orderkey, l_partkey, l_suppkey, l_extendedprice),
    whose span product passes 2^62 (the generator's dense keys pack the
    first three alone) and whose build runs the sub-partition join.
    Each must count a `multi_lane` fallback of the hash-table election.
  * hash_murmur3, hash_xxhash64 — hash(l_orderkey, l_shipmode,
    l_extendedprice, l_shipdate) and xxhash64 of the same over every
    lineitem row: SUM(CAST(h AS BIGINT)) and COUNT grouped by
    (l_returnflag, l_linestatus), and the first 1,000,000 values fetched.
  * tz_<zone> — a TIMESTAMP lane over lineitem's first TZ_ROWS rows
    (15,000,000), built on the
    host as l_shipdate's day plus (l_orderkey x 7919 mod 86,400) seconds
    and uploaded, under the session zones UTC, America/Los_Angeles and
    Australia/Lord_Howe (a 30-minute DST): its Hour, Minute, Second, the
    date fields of it, its CAST to DATE and ToUnixTimestamp, and
    DateAdd, DateSub, DateDiff, AddMonths, LastDay, TruncDate and
    ToUnixTimestamp over l_shipdate, each summed by the local hour with
    the rows counted.  numpy's truth reads each zone's offset from
    zoneinfo at every quarter hour of UTC 1992-1999 (np.searchsorted)
    and each local midnight from zoneinfo.  The card's host may lack
    tzdata: the phase prints the zones it found, and without them runs
    UTC and holds the device conversion against a hand-built table with
    a gap and an overlap (`tz_handbuilt`).

The numpy results (`expected`, in the data phase's fork pool) are
independent of the port: joins by index arrays over the dense primary
keys, exact int64 decimal arithmetic with Spark's HALF_UP average, and a
numpy murmur3 and XXH64 written here in uint32 and uint64 arithmetic,
each string's bytes taken per dictionary entry in Python.  Each case
prints its cold wall, the median of 3 warm walls, the peak device
memory, its launches and its tier counters; the phase prints its
seconds.  Imports numpy and torch only at module level.
"""
from __future__ import annotations

import datetime as pydt
import time

import numpy as np
import torch

#: the TPC-H columns the phase reads (chip_smoke keeps them from the data
#: phase)
TABLE_COLUMNS = {
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_tax",
                 "l_quantity", "l_extendedprice", "l_discount",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipmode"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
               "o_orderstatus", "o_shippriority"),
    "customer": ("c_custkey", "c_mktsegment", "c_acctbal", "c_phone"),
    "part": ("p_partkey", "p_brand", "p_container", "p_size"),
    "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
}
#: phase 5's numpy results the dense cases and bloom_q3 compare with
PATH_WANTS = ("q3", "q4", "q19", "q22", "m2m", "outer", "semi")
#: the numpy results this phase adds to the data phase's pool
TZ_ZONES = ("UTC", "America/Los_Angeles", "Australia/Lord_Howe")
WANTS = ("bloom_sel", "ck_str2", "ck_str_int", "ck_wide", "hash_murmur3",
         "hash_xxhash64") + tuple(f"tz_{z}" for z in TZ_ZONES)
DENSE = "spark.rapids.tpu.sql.kernels.pallas.join.denseReplace"
RUNTIME_FILTER = "spark.rapids.tpu.sql.join.runtimeFilter.enabled"
NARROW_LANES = "spark.rapids.tpu.sql.encoded.narrow.lanes"
#: the rows of the fetched hash values
HASH_ROWS = 1_000_000
#: the tz cases' rows: lineitem's first TZ_ROWS
TZ_ROWS = 15_000_000
SEL_MONTH = (pydt.date(1995, 3, 1), pydt.date(1995, 4, 1))


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


def _days(d: pydt.date) -> int:
    return (d - pydt.date(1970, 1, 1)).days


def _col(hb, name):
    return hb.column_by_name(name)


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------

def bloom_sel(s, t):
    """lineitem ⋈ the orders of one month, counted and summed."""
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.session import col
    from spark_rapids_tpu_torch.types import DATE
    lo, hi = (_days(d) for d in SEL_MONTH)
    orders = s.from_host(t["orders"].select(["o_orderkey", "o_orderdate"])) \
        .filter(E.And(E.GreaterThanOrEqual(col("o_orderdate"),
                                           E.Literal(lo, DATE)),
                      E.LessThan(col("o_orderdate"), E.Literal(hi, DATE))))
    li = s.from_host(t["lineitem"].select(["l_orderkey", "l_quantity"]))
    return li.join(orders, left_on=["l_orderkey"], right_on=["o_orderkey"]) \
        .agg((Count(None), "n"), (Sum(col("l_quantity")), "qty"))


def ck_str2(s, t):
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.session import col
    o = s.from_host(t["orders"].select(["o_custkey", "o_orderpriority",
                                        "o_orderstatus"]))
    keys = ["o_orderpriority", "o_orderstatus"]
    counts = o.group_by(*keys).agg((Count(None), "cnt")).select(
        E.Alias(col("o_orderpriority"), "p"),
        E.Alias(col("o_orderstatus"), "st"), col("cnt"))
    return (o.join(counts, left_on=keys, right_on=["p", "st"])
            .group_by("o_orderstatus")
            .agg((Count(None), "n"), (Sum(col("cnt")), "pairs"),
                 (Sum(col("o_custkey")), "cust"))
            .sort("o_orderstatus"))


def ck_str_int(s, t):
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Average, Count, Sum
    from spark_rapids_tpu_torch.session import col
    li = s.from_host(t["lineitem"].select(["l_shipmode", "l_tax",
                                           "l_quantity", "l_extendedprice"]))
    avg = li.group_by("l_shipmode", "l_tax").agg(
        (Average(col("l_quantity")), "avg_qty")).select(
        E.Alias(col("l_shipmode"), "m"), E.Alias(col("l_tax"), "tx"),
        col("avg_qty"))
    return (li.join(avg, left_on=["l_shipmode", "l_tax"],
                    right_on=["m", "tx"])
            .filter(E.GreaterThan(col("l_quantity"), col("avg_qty")))
            .group_by("l_shipmode")
            .agg((Count(None), "n"), (Sum(col("l_extendedprice")), "price"))
            .sort("l_shipmode"))


WIDE_KEYS = ["l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice"]


def ck_wide(s, t):
    import decimal as pydec
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.session import col
    li = s.from_host(t["lineitem"].select(WIDE_KEYS + ["l_discount",
                                                       "l_quantity"]))
    low = li.filter(E.LessThanOrEqual(col("l_discount"),
                                      E.Literal(pydec.Decimal("0.02"))))
    build = low.select(*[E.Alias(col(k), f"b_{k}") for k in WIDE_KEYS],
                       E.Alias(col("l_quantity"), "q1"))
    return li.join(build, left_on=WIDE_KEYS,
                   right_on=[f"b_{k}" for k in WIDE_KEYS]).agg(
        (Count(None), "n"), (Sum(col("l_quantity")), "qty"),
        (Sum(col("q1")), "qty1"))


def _hash_expr(xx: bool):
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    cls = E.XxHash64 if xx else E.Murmur3Hash
    return cls(col("l_orderkey"), col("l_shipmode"), col("l_extendedprice"),
               col("l_shipdate"))


HASH_COLUMNS = ["l_orderkey", "l_shipmode", "l_extendedprice", "l_shipdate",
                "l_returnflag", "l_linestatus"]


def hash_groups(xx: bool):
    def build(s, t):
        from spark_rapids_tpu_torch import types as T
        from spark_rapids_tpu_torch.plan import expressions as E
        from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
        from spark_rapids_tpu_torch.session import col
        li = s.from_host(t["lineitem"].select(HASH_COLUMNS))
        return (li.select(col("l_returnflag"), col("l_linestatus"),
                          E.Alias(E.Cast(_hash_expr(xx), T.LONG), "h"))
                .group_by("l_returnflag", "l_linestatus")
                .agg((Sum(col("h")), "hsum"), (Count(None), "n"))
                .sort("l_returnflag", "l_linestatus"))
    return build


def hash_values(xx: bool):
    def build(s, t):
        from spark_rapids_tpu_torch.plan import expressions as E
        li = s.from_host(t["lineitem"].select(HASH_COLUMNS).slice(
            0, HASH_ROWS))
        return li.select(E.Alias(_hash_expr(xx), "h"))
    return build


US_DAY = 86_400_000_000


def ts_table(li):
    """The tz cases' host batch over lineitem's first TZ_ROWS rows: ts
    (TIMESTAMP), l_shipdate."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    if li.num_rows > TZ_ROWS:
        li = li.slice(0, TZ_ROWS)
    ship = _col(li, "l_shipdate")
    okey = _col(li, "l_orderkey").data.astype(np.int64)
    us = (ship.data.astype(np.int64) * 86_400 + okey * 7919 % 86_400) * \
        1_000_000
    return HostBatch([HostColumn(us, None, T.TIMESTAMP), ship],
                     ["ts", "l_shipdate"])


def tz_query(s, t):
    """Every datetime class of the slice, summed by the local hour."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import datetime as DT
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.session import col
    ts, ship = col("ts"), col("l_shipdate")
    epoch = E.Literal(0, T.DATE)       # DATE results sum as day numbers

    def days(e):
        return DT.DateDiff(e, epoch)
    lanes = {
        "minute": DT.Minute(ts), "second": DT.Second(ts),
        "year": DT.Year(ts), "month": DT.Month(ts),
        "day": DT.DayOfMonth(ts), "dow": DT.DayOfWeek(ts),
        "doy": DT.DayOfYear(ts), "woy": DT.WeekOfYear(ts),
        "ts_date": days(E.Cast(ts, T.DATE)),
        "unix_ts": DT.ToUnixTimestamp(ts),
        "unix_d": DT.ToUnixTimestamp(ship),
        "d_ts": DT.ToUnixTimestamp(E.Cast(ship, T.TIMESTAMP)),
        "add": days(DT.DateAdd(ship, 17)), "sub": days(DT.DateSub(ship, 45)),
        "diff": DT.DateDiff(ship, E.Cast(ts, T.DATE)),
        "add_m": days(DT.AddMonths(ship, 5)),
        "last": days(DT.LastDay(ship)),
        "t_year": days(DT.TruncDate(ship, "year")),
        "t_quarter": days(DT.TruncDate(ship, "quarter")),
        "t_month": days(DT.TruncDate(ship, "month")),
        "t_week": days(DT.TruncDate(ship, "week"))}
    df = s.from_host(t["tz"]).select(
        E.Alias(DT.Hour(ts), "hour"),
        *[E.Alias(e, n) for n, e in lanes.items()])
    return (df.group_by("hour")
            .agg((Count(None), "n"), *[(Sum(col(n)), n) for n in lanes])
            .sort("hour"))


def _quarter_hours(zone: str):
    """(UTC us of every quarter hour of 1992-1999, zoneinfo's offset in
    us there)."""
    from zoneinfo import ZoneInfo
    z = ZoneInfo(zone)
    start = pydt.datetime(1992, 1, 1, tzinfo=pydt.timezone.utc)
    n = (pydt.datetime(2000, 1, 1, tzinfo=pydt.timezone.utc) - start) // \
        pydt.timedelta(minutes=15)
    points = [start + pydt.timedelta(minutes=15 * i) for i in range(n)]
    offs = np.array([int(p.astimezone(z).utcoffset().total_seconds())
                     for p in points], np.int64) * 1_000_000
    base = int(start.timestamp()) * 1_000_000
    return base + np.arange(n, dtype=np.int64) * 900_000_000, offs


def _over_range(values, fn):
    """fn's lanes over `values`, computed once for each integer of their
    range and gathered: numpy's datetime64 casts cost far more a row than
    a gather, and a lane of every lineitem spans a few thousand days."""
    lo = int(values.min())
    lanes = fn(np.arange(lo, int(values.max()) + 1, dtype=np.int64))
    idx = values - lo
    return tuple(lane[idx] for lane in lanes) if isinstance(
        lanes, tuple) else lanes[idx]


def _civil_range(days):
    d = days.astype("datetime64[D]")
    m = d.astype("datetime64[M]")
    y = d.astype("datetime64[Y]")
    return (y.astype(np.int64) + 1970, m.astype(np.int64) % 12 + 1,
            (d - m).astype(np.int64) + 1, m.astype(np.int64),
            y.astype(np.int64))


def _civil(days):
    """(year, month, day, months since 1970, years since 1970) of each
    day since 1970."""
    return _over_range(days, _civil_range)


def _month_day(months):
    """The day since 1970 of the first day of each month since 1970."""
    return _over_range(months, lambda v: v.astype("datetime64[M]").astype(
        "datetime64[D]").astype(np.int64))


def expected_tz(li, zone: str) -> dict:
    """numpy's tz_query under `zone`."""
    from zoneinfo import ZoneInfo
    tt = ts_table(li)
    us = tt.columns[0].data
    ship = tt.columns[1].data.astype(np.int64)
    pts, offs = _quarter_hours(zone)
    # searchsorted(pts, us, "right") - 1 over the evenly spaced points
    local = us + offs[np.clip((us - pts[0]) // 900_000_000, -1,
                              len(pts) - 1)]
    days = local // US_DAY
    tod = local % US_DAY
    y, m, d, months, years = _civil(days)
    doy = days - _month_day(years * 12) + 1
    thursday = days + 3 - (days + 3) % 7
    woy = (thursday - _month_day(_civil(thursday)[4] * 12)) // 7 + 1
    z = ZoneInfo(zone)
    midnight = _over_range(ship, lambda v: np.array([int(pydt.datetime(
        *(pydt.date(1970, 1, 1) + pydt.timedelta(days=int(x))).timetuple()[
            :3], tzinfo=z).timestamp()) for x in v], np.int64))
    sy, sm, sd, smonths, syears = _civil(ship)
    total = smonths + 5
    add_m = _month_day(total) + np.minimum(
        sd, _month_day(total + 1) - _month_day(total)) - 1
    lanes = {
        "minute": tod // 60_000_000 % 60, "second": tod // 1_000_000 % 60,
        "year": y, "month": m, "day": d, "dow": (days + 4) % 7 + 1,
        "doy": doy, "woy": woy, "ts_date": days,
        "unix_ts": us // 1_000_000, "unix_d": midnight,
        "d_ts": midnight, "add": ship + 17, "sub": ship - 45,
        "diff": ship - days, "add_m": add_m,
        "last": _month_day(smonths + 1) - 1,
        "t_year": _month_day(syears * 12),
        "t_quarter": _month_day(smonths - smonths % 3),
        "t_month": _month_day(smonths),
        "t_week": ship - (ship + 3) % 7}
    hour = tod // 3_600_000_000
    out = {"hour": list(range(24)),
           "n": np.bincount(hour, minlength=24).tolist()}
    for name, lane in lanes.items():
        sums = np.zeros(24, np.int64)
        np.add.at(sums, hour, lane.astype(np.int64))
        out[name] = sums.tolist()
    keep = [i for i, c in enumerate(out["n"]) if c]
    return {k: [v[i] for i in keep] for k, v in out.items()}


def zones_found() -> int:
    import zoneinfo
    return len(zoneinfo.available_timezones())


# ---------------------------------------------------------------------------
# numpy: Spark's murmur3 and XXH64, written in unsigned numpy arithmetic
# ---------------------------------------------------------------------------

_U32 = np.uint32
_U64 = np.uint64


def _rotl32(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _mm_k1(k):
    return _rotl32(k * _U32(0xCC9E2D51), 15) * _U32(0x1B873593)


def _mm_h1(h, k):
    return _rotl32(h ^ k, 13) * _U32(5) + _U32(0xE6546B64)


def _mm_fmix(h, n):
    h = h ^ n
    h = h ^ (h >> _U32(16))
    h = h * _U32(0x85EBCA6B)
    h = h ^ (h >> _U32(13))
    h = h * _U32(0xC2B2AE35)
    return h ^ (h >> _U32(16))


def _mm_int(v, seed):
    return _mm_fmix(_mm_h1(seed, _mm_k1(v.astype(np.int64).astype(_U32))),
                    _U32(4))


def _mm_long(v, seed):
    u = v.astype(np.int64).view(_U64)
    h = _mm_h1(seed, _mm_k1((u & _U64(0xFFFFFFFF)).astype(_U32)))
    h = _mm_h1(h, _mm_k1((u >> _U64(32)).astype(_U32)))
    return _mm_fmix(h, _U32(8))


def _entry_units(entries):
    """Each entry's UTF-8 bytes as murmur3's units (the aligned 4-byte
    little-endian words, then each tail byte sign-extended)."""
    out = []
    for e in entries:
        b = str(e).encode("utf-8")
        cut = len(b) - len(b) % 4
        out.append([int.from_bytes(b[i:i + 4], "little")
                    for i in range(0, cut, 4)] +
                   [(x - 256 if x >= 128 else x) & 0xFFFFFFFF
                    for x in b[cut:]])
    return out


def _mm_string(codes, dictionary, seed):
    units = _entry_units(dictionary)
    width = max(len(u) for u in units)
    table = np.zeros((len(units), width), _U32)
    for i, u in enumerate(units):
        table[i, :len(u)] = u
    count = np.array([len(u) for u in units])[codes]
    nbytes = np.array([len(str(e).encode("utf-8")) for e in dictionary],
                      _U32)[codes]
    h = seed.copy()
    for j in range(width):
        step = _mm_h1(h, _mm_k1(table[codes, j]))
        h = np.where(j < count, step, h)
    return _mm_fmix(h, nbytes)


_P1, _P2, _P3, _P4, _P5 = (_U64(p) for p in (
    0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
    0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5))


def _rotl64(x, r):
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _xx_fmix(h):
    h = h ^ (h >> _U64(33))
    h = h * _P2
    h = h ^ (h >> _U64(29))
    h = h * _P3
    return h ^ (h >> _U64(32))


def _xx_round(acc, w):
    return _rotl64(acc + w * _P2, 31) * _P1


def _xx_long(v, seed):
    h = seed + _P5 + _U64(8)
    h = h ^ _xx_round(_U64(0), v.astype(np.int64).view(_U64))
    return _xx_fmix(_rotl64(h, 27) * _P1 + _P4)


def _xx_int(v, seed):
    h = seed + _P5 + _U64(4)
    h = h ^ (v.astype(np.int64).astype(_U32).astype(_U64) * _P1)
    return _xx_fmix(_rotl64(h, 23) * _P2 + _P3)


def _xx_string(codes, dictionary, seed):
    """XXH64 of short strings (under 32 bytes: no stripes), per row."""
    raw = [str(e).encode("utf-8") for e in dictionary]
    assert max(len(b) for b in raw) < 32
    h = seed + _P5 + np.array([len(b) for b in raw], _U64)[codes]
    for e, b in enumerate(raw):
        rows = codes == e
        x = h[rows]
        off = 0
        while off + 8 <= len(b):
            w = _U64(int.from_bytes(b[off:off + 8], "little"))
            x = _rotl64(x ^ _xx_round(_U64(0), w), 27) * _P1 + _P4
            off += 8
        if off + 4 <= len(b):
            w = _U64(int.from_bytes(b[off:off + 4], "little"))
            x = _rotl64(x ^ (w * _P1), 23) * _P2 + _P3
            off += 4
        for byte in b[off:]:
            x = _rotl64(x ^ (_U64(byte) * _P5), 11) * _P1
        h[rows] = x
    return _xx_fmix(h)


def np_hash(li, xx: bool, rows=None) -> np.ndarray:
    """Spark's hash (murmur3, int32) or xxhash64 (int64) of (l_orderkey,
    l_shipmode, l_extendedprice, l_shipdate) per lineitem row; no column
    has nulls."""
    cut = slice(None) if rows is None else slice(0, rows)
    okey = _col(li, "l_orderkey").data[cut]
    mode = _col(li, "l_shipmode")
    price = _col(li, "l_extendedprice").data[cut]
    ship = _col(li, "l_shipdate").data[cut]
    codes = mode.data[cut].astype(np.int64)
    with np.errstate(over="ignore"):
        if xx:
            h = np.full(len(okey), 42, _U64)
            h = _xx_long(okey, h)
            h = _xx_string(codes, mode.dictionary, h)
            h = _xx_long(price, h)
            return _xx_int(ship, h).view(np.int64)
        h = np.full(len(okey), 42, _U32)
        h = _mm_long(okey, h)
        h = _mm_string(codes, mode.dictionary, h)
        h = _mm_long(price, h)
        return _mm_int(ship, h).view(np.int32)


# ---------------------------------------------------------------------------
# numpy results
# ---------------------------------------------------------------------------

def _strings(c, codes):
    return [str(v) for v in c.dictionary[codes]]


def expected(name: str, tables) -> dict:
    """The numpy result of one case, as chip_smoke.lanes_of gives the
    port's (strings decoded, decimals as unscaled ints)."""
    li, orders = tables["lineitem"], tables["orders"]
    if name == "bloom_sel":
        lo, hi = (_days(d) for d in SEL_MONTH)
        od = _col(orders, "o_orderdate").data
        okey = _col(orders, "o_orderkey").data
        lkey = _col(li, "l_orderkey").data
        flag = np.zeros(int(max(okey.max(), lkey.max())) + 1, bool)
        flag[okey[(od >= lo) & (od < hi)]] = True
        m = flag[lkey]
        return {"n": [int(m.sum())],
                "qty": [int(_col(li, "l_quantity").data[m].astype(
                    np.int64).sum())]}
    if name == "ck_str2":
        pri, st = _col(orders, "o_orderpriority"), _col(orders,
                                                       "o_orderstatus")
        ns = len(st.dictionary)
        key = pri.data.astype(np.int64) * ns + st.data
        cnt = np.bincount(key, minlength=len(pri.dictionary) * ns)
        per_row = cnt[key]
        cust = _col(orders, "o_custkey").data.astype(np.int64)
        out = {"o_orderstatus": [], "n": [], "pairs": [], "cust": []}
        for code in np.unique(st.data):
            m = st.data == code
            out["o_orderstatus"].append(str(st.dictionary[code]))
            out["n"].append(int(m.sum()))
            out["pairs"].append(int(per_row[m].sum()))
            out["cust"].append(int(cust[m].sum()))
        return out
    if name == "ck_str_int":
        mode = _col(li, "l_shipmode")
        tax = _col(li, "l_tax").data.astype(np.int64)
        qty = _col(li, "l_quantity").data.astype(np.int64)
        price = _col(li, "l_extendedprice").data.astype(np.int64)
        span = int(tax.max()) + 1
        key = mode.data.astype(np.int64) * span + tax
        width = len(mode.dictionary) * span
        sums = np.zeros(width, np.int64)
        np.add.at(sums, key, qty)
        counts = np.bincount(key, minlength=width)
        # AVG(DECIMAL(12,2)) is DECIMAL(16,6), HALF_UP: (2 s 10^4 + c) //
        # (2 c) for the positive sums
        avg6 = np.zeros(width, np.int64)
        has = counts > 0
        avg6[has] = (2 * sums[has] * 10 ** 4 + counts[has]) // \
            (2 * counts[has])
        kept = qty * 10 ** 4 > avg6[key]
        out = {"l_shipmode": [], "n": [], "price": []}
        for code in np.unique(mode.data):
            m = kept & (mode.data == code)
            out["l_shipmode"].append(str(mode.dictionary[code]))
            out["n"].append(int(m.sum()))
            out["price"].append(int(price[m].sum()))
        return out
    if name == "ck_wide":
        # the first three keys pack into 62 bits (the generator's keys
        # are dense from 0); the price is compared after a search
        okey, pk, sk, price = (_col(li, k).data.astype(np.int64)
                               for k in WIDE_KEYS)
        qty = _col(li, "l_quantity").data.astype(np.int64)
        pack = (okey * (int(pk.max()) + 1) + pk) * (int(sk.max()) + 1) + sk
        low = _col(li, "l_discount").data <= 2
        order = np.argsort(pack[low], kind="stable")
        bpack, bprice, bqty = (a[low][order] for a in (pack, price, qty))
        # queries in sorted order search fast (numpy narrows each search
        # from the previous one)
        by = np.argsort(pack, kind="stable")
        lo = np.empty_like(by)
        hi = np.empty_like(by)
        lo[by] = np.searchsorted(bpack, pack[by], "left")
        hi[by] = np.searchsorted(bpack, pack[by], "right")
        n = qty_sum = q1_sum = 0
        one = (hi - lo) == 1
        hit = one & (bprice[np.minimum(lo, len(bpack) - 1)] == price)
        n, qty_sum = int(hit.sum()), int(qty[hit].sum())
        q1_sum = int(bqty[lo[hit]].sum())
        for r in np.flatnonzero(hi - lo > 1):      # a repeated triple
            for b in range(lo[r], hi[r]):
                if bprice[b] == price[r]:
                    n, qty_sum, q1_sum = n + 1, qty_sum + int(qty[r]), \
                        q1_sum + int(bqty[b])
        return {"n": [n], "qty": [qty_sum], "qty1": [q1_sum]}
    if name in ("hash_murmur3", "hash_xxhash64"):
        xx = name == "hash_xxhash64"
        h = np_hash(li, xx).astype(np.int64)
        rf, ls = _col(li, "l_returnflag"), _col(li, "l_linestatus")
        nl = len(ls.dictionary)
        key = rf.data.astype(np.int64) * nl + ls.data
        out = {"l_returnflag": [], "l_linestatus": [], "hsum": [], "n": []}
        for k in np.unique(key):
            m = key == k
            out["l_returnflag"].append(str(rf.dictionary[k // nl]))
            out["l_linestatus"].append(str(ls.dictionary[k % nl]))
            with np.errstate(over="ignore"):
                out["hsum"].append(int(np.add.reduce(h[m], dtype=np.int64)))
            out["n"].append(int(m.sum()))
        return {"groups": out,
                "values": np_hash(li, xx, HASH_ROWS).astype(
                    np.int64).tolist()}
    if name.startswith("tz_"):
        zone = name[3:]
        if zone != "UTC" and not zones_found():
            return None
        return expected_tz(li, zone)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the phase
# ---------------------------------------------------------------------------

def _counters(ctx) -> dict:
    m = ctx.metrics
    keys = [k for k in m if k.startswith("kernel_fallback.") or k in (
        "join_dense_domain", "join_pallas_hash", "bloom_filter_slots",
        "bloom_filtered_rows", "join_subpartition_fallbacks")]
    return {k: m[k] for k in sorted(keys)}


def _session(conf=None):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(dict(conf or {}))


def _case(C, name, s, build, tables, check_fn, launches, extra=""):
    got, ctx, cold, warm, peak, launches[name] = C._timed(s, build, tables)
    check_fn(C.lanes_of(got))
    counters = _counters(ctx)
    C._query_log(name, got.num_rows, cold, warm, peak, launches[name],
                 f"{extra}; {counters}", tag="joins")
    C._check_launches(name, launches[name])
    return got, ctx, cold, warm, counters


def _equal(C, name):
    def check(lanes, want):
        if name == "q3":
            C.check_top(name, lanes, want)
        elif name in ("q4", "q19", "q22"):
            C.check_later(name, lanes, want)
        else:
            C.check(lanes == want, f"{name} differs from the numpy "
                    f"reference:\n{lanes}\n{want}")
    return check


def joins_phase(C, tables, want, path_walls) -> dict:
    """Every case of the phase; -> launches by case."""
    from spark_rapids_tpu_torch import tpch
    cold5, warm5 = path_walls
    launches = {}
    t0 = time.perf_counter()
    dense_runs = {"AUTO": 0, "OFF": 0}
    for mode in ("AUTO", "OFF"):
        s = _session({DENSE: mode})
        for q in PATH_WANTS:
            build = tpch.JOIN_QUERIES.get(q) or C.later_query(q, 10.0)
            name = f"dense_{q}_{mode.lower()}"
            _got, _ctx, _cold, _warm, counters = _case(
                C, name, s, build, tables,
                lambda lanes, q=q: _equal(C, q)(lanes, want[q]), launches,
                f" ({q}; under ON in phase 5: cold {cold5[q]:.1f} ms, warm "
                f"median {warm5[q]:.1f} ms)")
            dense_runs[mode] += counters.get("join_dense_domain", 0)
    for mode, n in dense_runs.items():
        C.check(n > 0, f"no join of the seven ran the dense tier under "
                f"denseReplace={mode}")
    C.log(f"[joins] dense tier under AUTO: {dense_runs['AUTO']} joins, "
          f"under OFF: {dense_runs['OFF']} joins "
          f"({time.perf_counter() - t0:.1f} s)")

    for on in (True, False):
        # full-width scan lanes: the adaptive join sizes its stages by
        # their device bytes, and bloom_sel's FOR-narrowed stages
        # (ops/encodings.py, the default) put its probe under 4 x its
        # build, where no filter is installed (the late phase runs it
        # narrowed)
        s = _session({RUNTIME_FILTER: str(on).lower(), NARROW_LANES: "OFF"})
        tag = "on" if on else "off"
        _case(C, f"bloom_q3_{tag}", s, tpch.QUERIES["q3"], tables,
              lambda lanes: _equal(C, "q3")(lanes, want["q3"]), launches)
        _g, _c, _cold, _warm, counters = _case(
            C, f"bloom_sel_{tag}", s, bloom_sel, tables,
            lambda lanes: C.check(lanes == want["bloom_sel"],
                                  f"bloom_sel differs: {lanes} against "
                                  f"{want['bloom_sel']}"), launches)
        if on:
            C.check(counters.get("bloom_filtered_rows", 0) > 0,
                    "bloom_sel filtered no probe row")
        else:
            C.check("bloom_filter_slots" not in counters,
                    "bloom_sel installed a filter with it off")

    s = _session()
    for name, build in (("ck_str2", ck_str2), ("ck_str_int", ck_str_int),
                        ("ck_wide", ck_wide)):
        _g, _c, _cold, _warm, counters = _case(
            C, name, s, build, tables,
            lambda lanes, name=name: C.check(
                lanes == want[name], f"{name} differs: {lanes} against "
                f"{want[name]}"), launches)
        C.check(counters.get("kernel_fallback.hash_probe_join.multi_lane",
                             0) > 0, f"{name} did not run the multi-lane "
                "sorted tier")
        if name == "ck_wide":
            C.check(counters.get("join_subpartition_fallbacks", 0) > 0,
                    "ck_wide did not run the sub-partition join")

    for name in ("hash_murmur3", "hash_xxhash64"):
        xx = name.endswith("xxhash64")
        _case(C, name, s, hash_groups(xx), tables,
              lambda lanes, name=name: C.check(
                  lanes == want[name]["groups"], f"{name} differs: {lanes} "
                  f"against {want[name]['groups']}"), launches)
        got = hash_values(xx)(s, tables).collect()
        vals = got.column_by_name("h").data.astype(np.int64).tolist()
        C.check(vals == want[name]["values"], f"{name}'s first "
                f"{HASH_ROWS} values differ from numpy's")
        C.log(f"[joins] {name}: the first {HASH_ROWS} values equal numpy's")

    found = zones_found()
    C.log(f"[joins] tzdata: {found} zones found")
    tz_tables = {"tz": ts_table(tables["lineitem"])}
    for zone in TZ_ZONES:
        if zone != "UTC" and not found:
            C.log(f"[joins] tz_{zone}: not run, no tzdata on this host")
            continue
        _case(C, f"tz_{zone}", _session({"spark.sql.session.timeZone": zone}),
              tz_query, tz_tables,
              lambda lanes, zone=zone: C.check(
                  lanes == want[f"tz_{zone}"], f"tz_{zone} differs: {lanes} "
                  f"against {want[f'tz_{zone}']}"), launches)
    handbuilt_case(C)
    torch.cuda.synchronize()
    return launches


def handbuilt_case(C) -> None:
    """The device conversion against a hand-built table with a one-hour
    gap and a one-hour overlap, held to numpy's lookup."""
    from spark_rapids_tpu_torch.ops import timezone as TZ
    hour = 3_600_000_000
    utc_pts = np.array([-(1 << 60), 100 * hour, 200 * hour], np.int64)
    offs = np.array([0, hour, 0], np.int64)
    wall_pts = np.array([utc_pts[0], utc_pts[1] + hour, utc_pts[2] + hour],
                        np.int64)
    rng = np.random.default_rng(3)
    us = rng.integers(0, 300 * hour, 1 << 22)
    dev = torch.device("cuda")
    got = TZ.utc_to_local(torch.from_numpy(us).to(dev),
                          torch.from_numpy(utc_pts).to(dev),
                          torch.from_numpy(offs).to(dev)).cpu().numpy()
    want = us + offs[np.searchsorted(utc_pts, us, "right") - 1]
    C.check(np.array_equal(got, want), "the hand-built table's UTC -> local "
            "differs on the card")
    walls = np.array([100 * hour + hour // 2, 200 * hour + hour // 2,
                      50 * hour], np.int64)      # gap, overlap, plain
    got = TZ.local_to_utc(torch.from_numpy(walls).to(dev),
                          torch.from_numpy(wall_pts).to(dev),
                          torch.from_numpy(offs).to(dev)).cpu().tolist()
    # the gap's wall shifts forward (its previous offset, 0); the
    # overlap's takes the earlier offset (+1 h)
    C.check(got == [100 * hour + hour // 2, 199 * hour + hour // 2,
                    50 * hour], f"the hand-built table's local -> UTC "
            f"gives {got}")
    C.log("[joins] tz_handbuilt: UTC -> local over 4,194,304 instants and "
          "the gap's and the overlap's walls equal numpy's")
