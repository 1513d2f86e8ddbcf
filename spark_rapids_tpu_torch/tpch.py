"""TPC-H data generation + the ported query builders.

Counterpart of spark_rapids_tpu/tpch.py.  `gen_tables` makes the same
tables from the same seed with the same numpy draws in the same order,
so the port's tables equal the JAX package's value for value — but as
numpy HostBatches (columnar/host.py), with no pyarrow.  A `rng.choice`
over a list of strings is drawn as the integer index it is made of
(`Generator.choice` draws `integers(0, len)`), so string columns
dictionary-encode without per-row string work.

`tables` names the tables to materialise; every draw still happens, so
any subset is value-identical to the full set.

Ported queries (`QUERIES`, 14 of the 22), each the reference's text:
q1 (pricing summary: filter + group-by + sort), q3 (shipping priority:
two joins, a high-cardinality group-by, top 10), q4 (order priority: a
left semi join), q5 (local supplier volume: a six-way join and a
column = column filter), q6 (forecast revenue change: filter + global
aggregate), q7 (volume shipping: nation joined twice, IN, string
column != column, a Year key), q8 (market share: CASE WHEN over
DOUBLE volumes per Year), q10 (returned items: top 20), q11 (important
stock: HAVING against a scalar subquery through a cross join), q12
(shipping modes: IN and CASE WHEN sums), q15 (top supplier: an
aggregate view read twice, its MAX through a cross join), q17
(small-quantity revenue: a per-part average joined back), q18 (large
volume customers: a HAVING through a join, top 100) and q19 (discounted
revenue: an OR of ANDs with IN).  q18's HAVING bound is the
reference's 7200.0, which no order of this generator reaches, so it
returns no row; `q18(s, t, bound=300.0)`, TPC-H's validation value,
runs the same plan with rows in its join and top-N.  Likewise q11's
fraction is the reference's 0.0001 (TPC-H's at SF1), which keeps no
part at SF10; `q11(s, t, fraction=0.0001 / sf)` is the spec's.

`JOIN_QUERIES` are three DataFrame queries over the same tables that
drive the general equi-join, which no TPC-H query of the reference
reaches (its adaptive join finds a unique build side for every one):
`m2m` (lineitem ⋈ partsupp on part key, a many-to-many join, then
q9's cost term per ship mode), `outer` (q13's shape: partsupp left
outer join one week of lineitem, then the distribution of match counts)
and `semi` (lineitem rows whose (part, supplier) pair is in partsupp).
"""
from __future__ import annotations

import datetime as pydt
import decimal as pydec
from typing import Dict, Iterable, Optional

import numpy as np

from . import types as _t
from .columnar.host import (HostBatch, HostColumn, dictionary_column,
                            string_column)
from .plan import datetime as DT
from .plan import expressions as E
from .plan.aggregates import Average, Count, Max, Sum
from .session import DataFrame, TpuSession, col

DTYPE_DATE = _t.DATE
MONEY = _t.DecimalType(12, 2)
TABLES = ("region", "nation", "customer", "supplier", "part", "partsupp",
          "orders", "lineitem")

_DATE0 = pydt.date(1970, 1, 1)


def _days(d: pydt.date) -> int:
    return (d - _DATE0).days


def _lane(values, dt) -> HostColumn:
    return HostColumn(np.asarray(values).astype(_t.physical_np_dtype(dt)),
                      None, dt)


def _money(cents) -> HostColumn:
    return _lane(cents, MONEY)


def _batch(cols: Dict[str, HostColumn]) -> HostBatch:
    return HostBatch(list(cols.values()), list(cols.keys()))


def gen_tables(scale: float = 0.01, seed: int = 20240706,
               tables: Optional[Iterable[str]] = None
               ) -> Dict[str, HostBatch]:
    want = set(TABLES if tables is None else tables)
    rng = np.random.default_rng(seed)
    n_li = max(int(6_001_215 * scale), 100)
    n_ord = max(int(1_500_000 * scale), 40)
    n_cust = max(int(150_000 * scale), 20)
    n_supp = max(int(10_000 * scale), 5)
    n_part = max(int(200_000 * scale), 20)
    out: Dict[str, HostBatch] = {}

    nations = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
               "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA",
               "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO",
               "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
               "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"]
    region_of = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1]
    regions = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
    if "region" in want:
        out["region"] = _batch({
            "r_regionkey": _lane(np.arange(5), _t.LONG),
            "r_name": string_column(regions)})
    if "nation" in want:
        out["nation"] = _batch({
            "n_nationkey": _lane(np.arange(25), _t.LONG),
            "n_name": string_column(nations),
            "n_regionkey": _lane(region_of, _t.LONG)})

    # customer
    c_nation = rng.integers(0, 25, n_cust)
    phone = [rng.integers(100, 1000, n_cust), rng.integers(100, 1000, n_cust),
             rng.integers(1000, 10000, n_cust)]
    segments = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                "HOUSEHOLD"]
    c_seg = rng.integers(0, len(segments), n_cust)
    c_acct = rng.integers(-99999, 999999, n_cust)
    if "customer" in want:
        out["customer"] = _batch({
            "c_custkey": _lane(np.arange(n_cust), _t.LONG),
            "c_name": string_column([f"Customer#{i:09d}"
                                     for i in range(n_cust)]),
            "c_nationkey": _lane(c_nation, _t.LONG),
            # spec: phone country code = nationkey + 10 (TPC-H 4.2.2.9)
            "c_phone": string_column([f"{k + 10}-{a}-{b}-{c}" for k, a, b, c
                                      in zip(c_nation, *phone)]),
            "c_mktsegment": dictionary_column(c_seg, segments),
            "c_acctbal": _money(c_acct)})

    # supplier
    s_nation = rng.integers(0, 25, n_supp)
    s_acct = rng.integers(-99999, 999999, n_supp)
    s_comments = ["reliable and fast", "slow Customer Complaints recorded",
                  "usually on time", "pending Customer Complaints review",
                  "excellent record"]
    s_comment = rng.integers(0, len(s_comments), n_supp)
    if "supplier" in want:
        out["supplier"] = _batch({
            "s_suppkey": _lane(np.arange(n_supp), _t.LONG),
            "s_name": string_column([f"Supplier#{i:09d}"
                                     for i in range(n_supp)]),
            "s_address": string_column([f"addr {i} lane"
                                        for i in range(n_supp)]),
            "s_phone": string_column([f"{11 + i % 25}-{i % 900 + 100}-55"
                                      for i in range(n_supp)]),
            "s_nationkey": _lane(s_nation, _t.LONG),
            "s_acctbal": _money(s_acct),
            "s_comment": dictionary_column(s_comment, s_comments)})

    # part
    colors = ["green", "blue", "red", "ivory", "khaki"]
    types_ = ["ECONOMY ANODIZED STEEL", "LARGE BRUSHED BRASS",
              "STANDARD POLISHED TIN", "SMALL PLATED COPPER",
              "PROMO BURNISHED NICKEL"]
    containers = ["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE",
                  "LG BOX", "JUMBO PKG"]
    p_mfgr = rng.integers(1, 6, n_part)
    p_color = rng.integers(0, len(colors), n_part)
    p_type = rng.integers(0, len(types_), n_part)
    p_brand = rng.integers(11, 56, n_part)
    p_container = rng.integers(0, len(containers), n_part)
    p_size = rng.integers(1, 51, n_part)
    if "part" in want:
        out["part"] = _batch({
            "p_partkey": _lane(np.arange(n_part), _t.LONG),
            "p_mfgr": dictionary_column(
                p_mfgr - 1, [f"Manufacturer#{m}" for m in range(1, 6)]),
            "p_name": string_column([f"{colors[c]} polished item{i}"
                                     for i, c in enumerate(p_color)]),
            "p_type": dictionary_column(p_type, types_),
            "p_brand": dictionary_column(
                p_brand - 11, [f"Brand#{b}" for b in range(11, 56)]),
            "p_container": dictionary_column(p_container, containers),
            "p_size": _lane(p_size, _t.INT)})

    # partsupp: (ps_partkey, ps_suppkey) is the primary key — each part's
    # supplier copies use distinct stride offsets (TPC-H 4.2.3's shape).
    # Two suppliers a part, half the spec's four, as the reference makes
    # them: the scale-0.001 parity tests need its exact values
    n_ps = n_part * 2
    ps_avail = rng.integers(1, 10000, n_ps)
    ps_cost = rng.integers(1_00, 1000_00, n_ps)
    if "partsupp" in want:
        ps_pk = np.concatenate([np.arange(n_part), np.arange(n_part)])
        ps_sk = np.concatenate(
            [np.arange(n_part) % n_supp,
             (np.arange(n_part) + max(1, n_supp // 4 + 1)) % n_supp])
        out["partsupp"] = _batch({
            "ps_partkey": _lane(ps_pk, _t.LONG),
            "ps_suppkey": _lane(ps_sk, _t.LONG),
            "ps_availqty": _lane(ps_avail, _t.INT),
            "ps_supplycost": _money(ps_cost)})

    # orders: only custkeys that are not a multiple of 3 (spec 4.2.3)
    o_date_lo = _days(pydt.date(1992, 1, 1))
    o_date_hi = _days(pydt.date(1998, 8, 2))
    keys = np.arange(n_cust, dtype=np.int64)
    o_cust = keys[keys % 3 != 0][
        rng.integers(0, n_cust - (n_cust + 2) // 3, n_ord)]
    o_date = rng.integers(o_date_lo, o_date_hi, n_ord)
    statuses = ["F", "O", "P"]
    priorities = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                  "5-LOW"]
    o_comments = ["fast delivery", "special requests pending",
                  "nothing unusual", "pending special requests now",
                  "routine order"]
    o_status = rng.integers(0, len(statuses), n_ord)
    o_prio = rng.integers(0, len(priorities), n_ord)
    o_comment = rng.integers(0, len(o_comments), n_ord)
    o_total = rng.integers(100_00, 500_000_00, n_ord)
    if "orders" in want:
        out["orders"] = _batch({
            "o_orderkey": _lane(np.arange(n_ord), _t.LONG),
            "o_custkey": _lane(o_cust, _t.LONG),
            "o_orderdate": _lane(o_date, DTYPE_DATE),
            "o_shippriority": _lane(np.zeros(n_ord), _t.INT),
            "o_orderstatus": dictionary_column(o_status, statuses),
            "o_orderpriority": dictionary_column(o_prio, priorities),
            "o_comment": dictionary_column(o_comment, o_comments),
            "o_totalprice": _money(o_total)})

    # lineitem
    l_ship = rng.integers(o_date_lo, o_date_hi + 122, n_li).astype(np.int32)
    l_commit = l_ship + rng.integers(-30, 61, n_li).astype(np.int32)
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype(np.int32)
    flags = ["A", "N", "R"]
    rf = rng.integers(0, len(flags), n_li)
    l_order = rng.integers(0, n_ord, n_li)
    l_part = rng.integers(0, n_part, n_li)
    l_supp = rng.integers(0, n_supp, n_li)
    l_qty = rng.integers(1, 51, n_li) * 100
    l_price = rng.integers(900_00, 10_500_000, n_li)
    l_disc = rng.integers(0, 11, n_li)
    l_tax = rng.integers(0, 9, n_li)
    modes = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
    l_mode = rng.integers(0, len(modes), n_li)
    if "lineitem" in want:
        open_ = (l_ship > _days(pydt.date(1995, 6, 17))).astype(np.int64)
        out["lineitem"] = _batch({
            "l_orderkey": _lane(l_order, _t.LONG),
            "l_partkey": _lane(l_part, _t.LONG),
            "l_suppkey": _lane(l_supp, _t.LONG),
            "l_quantity": _money(l_qty),
            "l_extendedprice": _money(l_price),
            "l_discount": _money(l_disc),
            "l_tax": _money(l_tax),
            "l_returnflag": dictionary_column(rf, flags),
            "l_linestatus": dictionary_column(open_, ["F", "O"]),
            "l_shipdate": _lane(l_ship, DTYPE_DATE),
            "l_commitdate": _lane(l_commit, DTYPE_DATE),
            "l_receiptdate": _lane(l_receipt, DTYPE_DATE),
            "l_shipmode": dictionary_column(l_mode, modes)})
    return out


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def q1(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Pricing summary report."""
    cutoff = _days(pydt.date(1998, 12, 1)) - 90
    li = s.from_host(t["lineitem"])
    disc_price = E.Multiply(col("l_extendedprice"),
                            E.Subtract(E.Literal(1), col("l_discount")))
    charge = E.Multiply(disc_price,
                        E.Add(E.Literal(1), col("l_tax")))
    return (li.filter(E.LessThanOrEqual(col("l_shipdate"),
                                        E.Literal(cutoff, DTYPE_DATE)))
            .group_by("l_returnflag", "l_linestatus")
            .agg((Sum(col("l_quantity")), "sum_qty"),
                 (Sum(col("l_extendedprice")), "sum_base_price"),
                 (Sum(disc_price), "sum_disc_price"),
                 (Sum(charge), "sum_charge"),
                 (Average(col("l_quantity")), "avg_qty"),
                 (Average(col("l_extendedprice")), "avg_price"),
                 (Average(col("l_discount")), "avg_disc"),
                 (Count(None), "count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q3(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Shipping priority."""
    date = _days(pydt.date(1995, 3, 15))
    cust = s.from_host(t["customer"]).filter(
        E.EqualTo(col("c_mktsegment"), E.Literal("BUILDING")))
    orders = s.from_host(t["orders"]).filter(
        E.LessThan(col("o_orderdate"), E.Literal(date, DTYPE_DATE)))
    li = s.from_host(t["lineitem"]).filter(
        E.GreaterThan(col("l_shipdate"), E.Literal(date, DTYPE_DATE)))
    j = cust.join(orders, left_on=["c_custkey"], right_on=["o_custkey"]) \
        .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
    revenue = E.Multiply(col("l_extendedprice"),
                         E.Subtract(E.Literal(1), col("l_discount")))
    return (j.group_by("o_orderkey", "o_orderdate", "o_shippriority")
            .agg((Sum(revenue), "revenue"))
            .sort(("revenue", False, False), ("o_orderdate", True, True))
            .limit(10))


def q6(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Forecast revenue change."""
    d_lo = _days(pydt.date(1994, 1, 1))
    d_hi = _days(pydt.date(1995, 1, 1))
    li = s.from_host(t["lineitem"])
    cond = E.And(
        E.And(E.GreaterThanOrEqual(col("l_shipdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThan(col("l_shipdate"), E.Literal(d_hi, DTYPE_DATE))),
        E.And(E.And(E.GreaterThanOrEqual(col("l_discount"),
                                         E.Literal(pydec.Decimal("0.05"))),
                    E.LessThanOrEqual(col("l_discount"),
                                      E.Literal(pydec.Decimal("0.07")))),
              E.LessThan(col("l_quantity"),
                         E.Literal(pydec.Decimal("24")))))
    revenue = E.Multiply(col("l_extendedprice"), col("l_discount"))
    return li.filter(cond).agg((Sum(revenue), "revenue"))


def q4(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Order priority checking: EXISTS ≡ left-semi join."""
    d_lo = _days(pydt.date(1993, 7, 1))
    d_hi = _days(pydt.date(1993, 10, 1))
    orders = s.from_host(t["orders"]).filter(
        E.And(E.GreaterThanOrEqual(col("o_orderdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThan(col("o_orderdate"), E.Literal(d_hi, DTYPE_DATE))))
    late = s.from_host(t["lineitem"]).filter(
        E.LessThan(col("l_commitdate"), col("l_receiptdate")))
    j = orders.join(late, how="left_semi",
                    left_on=["o_orderkey"], right_on=["l_orderkey"])
    return (j.group_by("o_orderpriority")
            .agg((Count(None), "order_count"))
            .sort("o_orderpriority"))


def q5(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Local supplier volume: ASIA, 1994."""
    d_lo = _days(pydt.date(1994, 1, 1))
    d_hi = _days(pydt.date(1995, 1, 1))
    region = s.from_host(t["region"]).filter(
        E.EqualTo(col("r_name"), E.Literal("ASIA")))
    nation = s.from_host(t["nation"])
    cust = s.from_host(t["customer"])
    supp = s.from_host(t["supplier"])
    orders = s.from_host(t["orders"]).filter(
        E.And(E.GreaterThanOrEqual(col("o_orderdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThan(col("o_orderdate"), E.Literal(d_hi, DTYPE_DATE))))
    li = s.from_host(t["lineitem"])
    j = (region.join(nation, left_on=["r_regionkey"],
                     right_on=["n_regionkey"])
         .join(cust, left_on=["n_nationkey"], right_on=["c_nationkey"])
         .join(orders, left_on=["c_custkey"], right_on=["o_custkey"])
         .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"]))
    # l_suppkey must match a supplier in the same nation:
    j = j.join(supp, left_on=["l_suppkey"], right_on=["s_suppkey"]) \
        .filter(E.EqualTo(col("s_nationkey"), col("n_nationkey")))
    revenue = E.Multiply(col("l_extendedprice"),
                         E.Subtract(E.Literal(1), col("l_discount")))
    return (j.group_by("n_name").agg((Sum(revenue), "revenue"))
            .sort(("revenue", False, False)))


def q7(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Volume shipping between FRANCE and GERMANY (nation joined twice
    under renames)."""
    d_lo = _days(pydt.date(1995, 1, 1))
    d_hi = _days(pydt.date(1996, 12, 31))
    supp_nation = s.from_host(t["nation"]).select(
        col("n_nationkey"), col("n_name"),
        names=["sn_key", "supp_nation"]).filter(
        E.In(col("supp_nation"), ["FRANCE", "GERMANY"]))
    cust_nation = s.from_host(t["nation"]).select(
        col("n_nationkey"), col("n_name"),
        names=["cn_key", "cust_nation"]).filter(
        E.In(col("cust_nation"), ["FRANCE", "GERMANY"]))
    li = s.from_host(t["lineitem"]).filter(
        E.And(E.GreaterThanOrEqual(col("l_shipdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThanOrEqual(col("l_shipdate"),
                                E.Literal(d_hi, DTYPE_DATE))))
    j = (li.join(s.from_host(t["supplier"]),
                 left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(supp_nation, left_on=["s_nationkey"], right_on=["sn_key"])
         .join(s.from_host(t["orders"]),
               left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(s.from_host(t["customer"]),
               left_on=["o_custkey"], right_on=["c_custkey"])
         .join(cust_nation, left_on=["c_nationkey"], right_on=["cn_key"])
         .filter(E.Not(E.EqualTo(col("supp_nation"),
                                 col("cust_nation")))))
    volume = E.Multiply(col("l_extendedprice"),
                        E.Subtract(E.Literal(1), col("l_discount")))
    year = DT.Year(col("l_shipdate"))
    return (j.group_by(col("supp_nation"), col("cust_nation"),
                       E.Alias(year, "l_year"))
            .agg((Sum(volume), "revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def q8(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """National market share: BRAZIL's share of AMERICA's ECONOMY
    ANODIZED STEEL volume per year."""
    d_lo = _days(pydt.date(1995, 1, 1))
    d_hi = _days(pydt.date(1996, 12, 31))
    part = s.from_host(t["part"]).filter(
        E.EqualTo(col("p_type"), E.Literal("ECONOMY ANODIZED STEEL")))
    orders = s.from_host(t["orders"]).filter(
        E.And(E.GreaterThanOrEqual(col("o_orderdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThanOrEqual(col("o_orderdate"),
                                E.Literal(d_hi, DTYPE_DATE))))
    n1 = (s.from_host(t["region"])
          .filter(E.EqualTo(col("r_name"), E.Literal("AMERICA")))
          .join(s.from_host(t["nation"]),
                left_on=["r_regionkey"], right_on=["n_regionkey"])
          .select(col("n_nationkey"), names=["cn_key"]))
    n2 = s.from_host(t["nation"]).select(
        col("n_nationkey"), col("n_name"), names=["sn_key", "supp_nation"])
    j = (s.from_host(t["lineitem"])
         .join(part, left_on=["l_partkey"], right_on=["p_partkey"])
         .join(s.from_host(t["supplier"]),
               left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(orders, left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(s.from_host(t["customer"]),
               left_on=["o_custkey"], right_on=["c_custkey"])
         .join(n1, left_on=["c_nationkey"], right_on=["cn_key"])
         .join(n2, left_on=["s_nationkey"], right_on=["sn_key"]))
    volume = E.Multiply(
        E.Cast(col("l_extendedprice"), _t.DOUBLE),
        E.Subtract(E.Literal(1.0), E.Cast(col("l_discount"), _t.DOUBLE)))
    brazil = E.CaseWhen(
        [(E.EqualTo(col("supp_nation"), E.Literal("BRAZIL")), volume)],
        E.Literal(0.0))
    year = DT.Year(col("o_orderdate"))
    g = (j.group_by(E.Alias(year, "o_year"))
         .agg((Sum(brazil), "brazil_vol"), (Sum(volume), "total_vol")))
    share = E.Divide(col("brazil_vol"), col("total_vol"))
    return (g.select(col("o_year"), share, names=["o_year", "mkt_share"])
            .sort("o_year"))


def q10(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Returned item reporting (top 20 customers by lost revenue)."""
    d_lo = _days(pydt.date(1993, 10, 1))
    d_hi = _days(pydt.date(1994, 1, 1))
    cust = s.from_host(t["customer"])
    orders = s.from_host(t["orders"]).filter(
        E.And(E.GreaterThanOrEqual(col("o_orderdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThan(col("o_orderdate"), E.Literal(d_hi, DTYPE_DATE))))
    li = s.from_host(t["lineitem"]).filter(
        E.EqualTo(col("l_returnflag"), E.Literal("R")))
    nation = s.from_host(t["nation"])
    j = (cust.join(orders, left_on=["c_custkey"], right_on=["o_custkey"])
         .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
         .join(nation, left_on=["c_nationkey"], right_on=["n_nationkey"]))
    revenue = E.Multiply(col("l_extendedprice"),
                         E.Subtract(E.Literal(1), col("l_discount")))
    return (j.group_by("c_custkey", "n_name")
            .agg((Sum(revenue), "revenue"))
            .sort(("revenue", False, False), ("c_custkey", True, True))
            .limit(20))


def q11(s: TpuSession, t: Dict[str, HostBatch],
        fraction: float = 0.0001) -> DataFrame:
    """Important stock identification: HAVING against a scalar subquery
    (total value fraction) via a 1-row cross join.  The reference fixes
    the fraction at SF1's 0.0001; TPC-H's is 0.0001 / SF, which keeps
    rows at larger scales."""
    germany = (s.from_host(t["partsupp"])
               .join(s.from_host(t["supplier"]),
                     left_on=["ps_suppkey"], right_on=["s_suppkey"])
               .join(s.from_host(t["nation"]).filter(
                   E.EqualTo(col("n_name"), E.Literal("GERMANY"))),
                   left_on=["s_nationkey"], right_on=["n_nationkey"]))
    value = E.Multiply(E.Cast(col("ps_supplycost"), _t.DOUBLE),
                       E.Cast(col("ps_availqty"), _t.DOUBLE))
    per_part = (germany.group_by("ps_partkey")
                .agg((Sum(value), "value")))
    total = (germany.agg((Sum(value), "tv"))
             .select(E.Multiply(col("tv"), E.Literal(fraction)),
                     names=["threshold"]))
    j = per_part.join(total, how="cross")
    return (j.filter(E.GreaterThan(col("value"), col("threshold")))
            .select(col("ps_partkey"), col("value"))
            .sort(("value", False, False), ("ps_partkey", True, True)))


def q12(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Shipping modes and order priority (CASE WHEN sums + IN)."""
    d_lo = _days(pydt.date(1994, 1, 1))
    d_hi = _days(pydt.date(1995, 1, 1))
    li = s.from_host(t["lineitem"]).filter(E.And(
        E.And(E.In(col("l_shipmode"), ["MAIL", "SHIP"]),
              E.And(E.LessThan(col("l_commitdate"), col("l_receiptdate")),
                    E.LessThan(col("l_shipdate"), col("l_commitdate")))),
        E.And(E.GreaterThanOrEqual(col("l_receiptdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThan(col("l_receiptdate"),
                         E.Literal(d_hi, DTYPE_DATE)))))
    orders = s.from_host(t["orders"])
    j = orders.join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
    high = E.CaseWhen(
        [(E.In(col("o_orderpriority"), ["1-URGENT", "2-HIGH"]),
          E.Literal(1))], E.Literal(0))
    low = E.CaseWhen(
        [(E.In(col("o_orderpriority"), ["1-URGENT", "2-HIGH"]),
          E.Literal(0))], E.Literal(1))
    return (j.group_by("l_shipmode")
            .agg((Sum(high), "high_line_count"),
                 (Sum(low), "low_line_count"))
            .sort("l_shipmode"))


def q15(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Top supplier: revenue view + MAX scalar subquery."""
    d_lo = _days(pydt.date(1996, 1, 1))
    d_hi = _days(pydt.date(1996, 4, 1))
    li = s.from_host(t["lineitem"]).filter(
        E.And(E.GreaterThanOrEqual(col("l_shipdate"),
                                   E.Literal(d_lo, DTYPE_DATE)),
              E.LessThan(col("l_shipdate"), E.Literal(d_hi, DTYPE_DATE))))
    revenue = E.Multiply(
        E.Cast(col("l_extendedprice"), _t.DOUBLE),
        E.Subtract(E.Literal(1.0), E.Cast(col("l_discount"), _t.DOUBLE)))
    rev = (li.group_by("l_suppkey")
           .agg((Sum(revenue), "total_revenue")))
    top = rev.agg((Max(col("total_revenue")), "max_revenue"))
    j = (rev.join(top, how="cross")
         .filter(E.EqualTo(col("total_revenue"), col("max_revenue")))
         .join(s.from_host(t["supplier"]),
               left_on=["l_suppkey"], right_on=["s_suppkey"]))
    return (j.select(col("s_suppkey"), col("s_name"), col("s_address"),
                     col("s_phone"), col("total_revenue"))
            .sort("s_suppkey"))


def q17(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Small-quantity-order revenue: correlated avg subquery as a join."""
    part = s.from_host(t["part"]).filter(
        E.EqualTo(col("p_type"), E.Literal("PROMO BURNISHED NICKEL")))
    li = s.from_host(t["lineitem"])
    per_part = (li.group_by("l_partkey")
                .agg((Average(col("l_quantity")), "avg_qty")))
    per_part = per_part.select(
        col("l_partkey"), E.Multiply(E.Literal(0.2),
                                     E.Cast(col("avg_qty"), _t.DOUBLE)),
        names=["ap_partkey", "qty_limit"])
    j = (li.join(part, left_on=["l_partkey"], right_on=["p_partkey"])
         .join(per_part, left_on=["l_partkey"], right_on=["ap_partkey"])
         .filter(E.LessThan(E.Cast(col("l_quantity"), _t.DOUBLE),
                            col("qty_limit"))))
    total = j.agg((Sum(col("l_extendedprice")), "s"))
    return total.select(
        E.Divide(E.Cast(col("s"), _t.DOUBLE), E.Literal(7.0)),
        names=["avg_yearly"])


def q18(s: TpuSession, t: Dict[str, HostBatch],
        bound: float = 7200.0) -> DataFrame:
    """Large-volume customers (HAVING sum(qty) > threshold via join)."""
    li = s.from_host(t["lineitem"])
    big = (li.group_by("l_orderkey")
           .agg((Sum(col("l_quantity")), "total_qty"))
           .filter(E.GreaterThan(E.Cast(col("total_qty"), _t.DOUBLE),
                                 E.Literal(bound))))
    big = big.select(col("l_orderkey"), col("total_qty"),
                     names=["big_orderkey", "total_qty"])
    orders = s.from_host(t["orders"])
    cust = s.from_host(t["customer"])
    j = (orders.join(big, left_on=["o_orderkey"], right_on=["big_orderkey"])
         .join(cust, left_on=["o_custkey"], right_on=["c_custkey"]))
    return (j.select(col("c_custkey"), col("o_orderkey"), col("o_orderdate"),
                     col("o_totalprice"), col("total_qty"))
            .sort(("o_totalprice", False, False), ("o_orderdate", True, True))
            .limit(100))


def q19(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """Discounted revenue: disjunction of brand/container/quantity
    conjuncts (the OR-of-ANDs predicate shape)."""
    li = s.from_host(t["lineitem"]).filter(
        E.And(E.In(col("l_shipmode"), ["AIR", "REG AIR"]),
              E.EqualTo(col("l_returnflag"), E.Literal("N"))))
    part = s.from_host(t["part"])
    j = li.join(part, left_on=["l_partkey"], right_on=["p_partkey"])

    def qty_between(lo, hi):
        return E.And(
            E.GreaterThanOrEqual(col("l_quantity"),
                                 E.Literal(pydec.Decimal(lo))),
            E.LessThanOrEqual(col("l_quantity"),
                              E.Literal(pydec.Decimal(hi))))
    branch1 = E.And(E.And(E.EqualTo(col("p_brand"), E.Literal("Brand#12")),
                          E.In(col("p_container"),
                               ["SM CASE", "SM BOX"])),
                    E.And(qty_between("1", "11"),
                          E.LessThanOrEqual(col("p_size"), E.Literal(5))))
    branch2 = E.And(E.And(E.EqualTo(col("p_brand"), E.Literal("Brand#23")),
                          E.In(col("p_container"),
                               ["MED BAG", "MED BOX"])),
                    E.And(qty_between("10", "20"),
                          E.LessThanOrEqual(col("p_size"), E.Literal(10))))
    branch3 = E.And(E.And(E.EqualTo(col("p_brand"), E.Literal("Brand#34")),
                          E.In(col("p_container"),
                               ["LG CASE", "LG BOX", "JUMBO PKG"])),
                    E.And(qty_between("20", "30"),
                          E.LessThanOrEqual(col("p_size"), E.Literal(15))))
    revenue = E.Multiply(col("l_extendedprice"),
                         E.Subtract(E.Literal(1), col("l_discount")))
    return (j.filter(E.Or(E.Or(branch1, branch2), branch3))
            .agg((Sum(revenue), "revenue")))


QUERIES = {"q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
           "q8": q8, "q10": q10, "q11": q11, "q12": q12, "q15": q15,
           "q17": q17, "q18": q18, "q19": q19}


def _date_range(name: str, lo: pydt.date, hi: pydt.date) -> E.Expression:
    return E.And(E.GreaterThanOrEqual(col(name),
                                      E.Literal(_days(lo), DTYPE_DATE)),
                 E.LessThan(col(name), E.Literal(_days(hi), DTYPE_DATE)))


def m2m(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """1994's lineitem ⋈ partsupp on the part key (two partsupp rows a
    part: a build with repeated keys), q9's cost term and the pair count
    per ship mode."""
    li = s.from_host(t["lineitem"]).filter(
        _date_range("l_shipdate", pydt.date(1994, 1, 1),
                    pydt.date(1995, 1, 1)))
    cost = E.Multiply(col("ps_supplycost"), col("l_quantity"))
    return (li.join(s.from_host(t["partsupp"]), left_on=["l_partkey"],
                    right_on=["ps_partkey"])
            .group_by("l_shipmode")
            .agg((Sum(cost), "cost"), (Count(None), "n"))
            .sort("l_shipmode"))


def outer(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """q13's shape over partsupp and one week of lineitem: how many
    partsupp rows have each number of matching lineitem rows."""
    li = s.from_host(t["lineitem"]).filter(
        _date_range("l_shipdate", pydt.date(1995, 3, 1),
                    pydt.date(1995, 3, 8)))
    per_row = (s.from_host(t["partsupp"])
               .join(li, left_on=["ps_partkey"], right_on=["l_partkey"],
                     how="left_outer")
               .group_by("ps_partkey", "ps_suppkey")
               .agg((Count(col("l_orderkey")), "c_count")))
    return (per_row.group_by("c_count").agg((Count(None), "n"))
            .sort(("n", False, False), ("c_count", False, False)))


def semi(s: TpuSession, t: Dict[str, HostBatch]) -> DataFrame:
    """The lineitem rows whose (part, supplier) pair partsupp lists: a
    left semi join on a composite key that packs into one lane."""
    return (s.from_host(t["lineitem"])
            .join(s.from_host(t["partsupp"]),
                  left_on=["l_partkey", "l_suppkey"],
                  right_on=["ps_partkey", "ps_suppkey"], how="left_semi")
            .agg((Count(None), "n"), (Sum(col("l_quantity")), "qty")))


JOIN_QUERIES = {"m2m": m2m, "outer": outer, "semi": semi}
