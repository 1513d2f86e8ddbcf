"""TPC-H data generation + the ported query builders.

Counterpart of spark_rapids_tpu/tpch.py.  `gen_tables` makes the same
tables from the same seed with the same numpy draws in the same order,
so the port's tables equal the JAX package's value for value — but as
numpy HostBatches (columnar/host.py), with no pyarrow.  A `rng.choice`
over a list of strings is drawn as the integer index it is made of
(`Generator.choice` draws `integers(0, len)`), so string columns
dictionary-encode without per-row string work.

`tables` names the tables to materialise; every draw still happens, so
any subset is value-identical to the full set (the chip smoke builds
customer, orders and lineitem at SF10).

Ported queries: q1 (pricing summary: filter + group-by + sort), q3
(shipping priority: three filters, two joins, a group-by over a high-
cardinality key, top 10) and q6 (forecast revenue change: filter +
global aggregate).

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
from .plan import expressions as E
from .plan.aggregates import Average, Count, Sum
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


QUERIES = {"q1": q1, "q3": q3, "q6": q6}


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
