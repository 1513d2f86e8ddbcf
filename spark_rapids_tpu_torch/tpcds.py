"""TPC-DS data generation + the ported query corpus.

Counterpart of spark_rapids_tpu/tpcds.py.  `gen_tables(scale, seed)`
makes the reference generator's star schema — three sales channels
(store_sales, web_sales, catalog_sales) with their returns, a
Julian-day-keyed date_dim with calendar derivations, time_dim and the
dimension tables the queries touch — from the same seed with the same
numpy draws in the same order, so every value of every table equals
the reference's; but as numpy HostBatches (columnar/host.py), with no
pyarrow.  Money is decimal(7,2) (the int64 unscaled lane, clipped to
the type's domain), surrogate keys are int64 from 1, dates are DATE,
quantities and calendar fields INT.  Nullable foreign keys carry a
validity lane (their null rows' payload is 0, as `from_arrow` leaves
it).  Cyclic and formatted string attributes are dictionary-coded from
their integer codes, so no string is built per row of a fact table.

Row counts scale linearly with `scale` (scale=1.0 -> the reference's
SF1-ish counts); date_dim, time_dim and the demographics do not scale,
as dsdgen keeps them.  The value distributions are the reference's
simplified dsdgen shapes (uniform ranges, cyclic dimension attributes,
nullable foreign keys), not the full dsdgen grammar.

`QUERIES` holds the reference's 23 queries in its text: q3, q7, q19,
q42, q43, q52, q55, q73 and q96 (star joins with group-bys and top-N),
q26 and q93 (catalog averages, returns joined back on a composite key),
q65 (two aggregate subqueries joined), q12, q20 and q98 (a per-item
revenue ratio over a window partition total), q27, q36, q70 and q86
(ROLLUP through Expand with grouping(), ranks within each hierarchy
level), and q33, q56, q60 and q76 (UNION ALL over the three channels).
"""
from __future__ import annotations

import datetime as pydt
from typing import Dict

import numpy as np

from . import types as _t
from .columnar.host import (HostBatch, HostColumn, dictionary_column,
                            string_column)
from .plan import expressions as E
from .plan.aggregates import Average, Count, Sum
from .session import DataFrame, TpuSession, col
from .tpch import _batch, _lane

DTYPE_DATE = _t.DATE
MONEY7 = _t.DecimalType(7, 2)

_EPOCH = pydt.date(1970, 1, 1)
# date_sk is the Julian day number, as dsdgen assigns it
# (2000-01-01 -> 2451545)
_JDN_OFFSET = 1721425

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
STATES = ["TN", "SC", "AL", "GA", "SD", "MI", "OH", "TX", "KY", "MN",
          "NE", "IA", "IL", "MO", "KS", "WI", "VA", "NC", "IN", "WV"]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
COLORS = ["slate", "blanched", "burnished", "red", "green", "blue",
          "khaki", "ivory"]
BUY_POTENTIAL = [">10000", "unknown", "1001-5000", "5001-10000",
                 "501-1000", "0-500"]
_FIRST = ["James", "Mary", "John", "Linda", "Robert", "Susan", "Michael",
          "Karen", "William", "Betty"]
_LAST = ["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis",
         "Garcia", "Wilson", "Moore", "Taylor"]


def _jdn(d: pydt.date) -> int:
    return d.toordinal() + _JDN_OFFSET


def _days(d: pydt.date) -> int:
    return (d - _EPOCH).days


def money7(cents: np.ndarray) -> HostColumn:
    """decimal(7,2) money lane; cents clipped to the type's domain."""
    return _lane(np.clip(np.asarray(cents).astype(np.int64), -9_999_999,
                         9_999_999), MONEY7)


def _cyc(values, n: int) -> HostColumn:
    """Cyclic dimension attribute: value i % len(values) at row i (a
    repeated value is one dictionary entry)."""
    options, codes = np.unique(np.asarray(values, str), return_inverse=True)
    return dictionary_column(codes[np.arange(n) % len(values)], options)


def _ids(n: int, start: int = 1) -> HostColumn:
    """The "AAAAAAAA%08d" business ids of keys start..start+n-1: fixed
    width, so the sorted dictionary is the ids in key order."""
    keys = np.arange(start, start + n)
    return HostColumn(np.arange(n, dtype=np.int32), None, _t.STRING,
                      np.char.add("AAAAAAAA", np.char.zfill(
                          keys.astype(str), 8)))


def _sk(n: int) -> HostColumn:
    return _lane(np.arange(1, n + 1), _t.LONG)


def _int(values) -> HostColumn:
    return _lane(values, _t.INT)


def _fk(rng, hi: int, n: int, null_frac: float = 0.02) -> HostColumn:
    """Foreign key sample over 1..hi with the spec's nullable fks."""
    vals = rng.integers(1, hi + 1, n).astype(np.int64)
    if null_frac <= 0:
        return _lane(vals, _t.LONG)
    valid = ~(rng.random(n) < null_frac)
    return HostColumn(np.where(valid, vals, 0), valid, _t.LONG)


def _take(c: HostColumn, rows: np.ndarray) -> HostColumn:
    return HostColumn(c.data[rows], None if c.validity is None
                      else c.validity[rows], c.dtype, c.dictionary)


def gen_date_dim() -> HostBatch:
    """Calendar 1998-01-01 .. 2003-12-31 with the spec's derivations.
    d_month_seq counts months since 1900-01 (Jan-2000 -> 1200), the
    convention the monthly-window queries (q65, q70, q86) rely on."""
    start = pydt.date(1998, 1, 1)
    end = pydt.date(2003, 12, 31)
    n = (end - start).days + 1
    dates = [start + pydt.timedelta(days=i) for i in range(n)]
    moy = np.array([d.month for d in dates], np.int32)
    jdn = np.array([_jdn(d) for d in dates], np.int64)
    return _batch({
        "d_date_sk": _lane(jdn, _t.LONG),
        "d_date_id": _ids(n, int(jdn[0])),
        "d_date": _lane(np.array([_days(d) for d in dates]), DTYPE_DATE),
        "d_year": _int([d.year for d in dates]),
        "d_moy": _int(moy),
        "d_dom": _int([d.day for d in dates]),
        "d_qoy": _int((moy - 1) // 3 + 1),
        "d_dow": _int([d.weekday() for d in dates]),
        "d_day_name": dictionary_column([d.weekday() for d in dates],
                                        DAY_NAMES),
        "d_month_seq": _int([(d.year - 1900) * 12 + d.month - 1
                             for d in dates]),
    })


def gen_time_dim() -> HostBatch:
    """All 86400 seconds of the day (fixed size, as dsdgen)."""
    sk = np.arange(86400, dtype=np.int64)
    return _batch({
        "t_time_sk": _lane(sk, _t.LONG),
        "t_time": _int(sk),
        "t_hour": _int(sk // 3600),
        "t_minute": _int((sk // 60) % 60),
        "t_second": _int(sk % 60),
    })


def gen_tables(scale: float = 0.01, seed: int = 20250804
               ) -> Dict[str, HostBatch]:
    rng = np.random.default_rng(seed)
    n_item = max(int(18_000 * scale), 200)
    n_cust = max(int(100_000 * scale), 100)
    n_ca = max(int(50_000 * scale), 60)
    n_store = max(int(12 * scale), 6)
    n_promo = max(int(300 * scale), 30)
    n_ss = max(int(2_880_404 * scale), 2500)
    n_ws = max(int(719_384 * scale), 900)
    n_cs = max(int(1_441_548 * scale), 1300)

    date_dim = gen_date_dim()
    time_dim = gen_time_dim()
    # facts sell during 1998..2002 (the tranche's filter years)
    sell_lo = _jdn(pydt.date(1998, 1, 1))
    sell_hi = _jdn(pydt.date(2002, 12, 31))
    last_day = _jdn(pydt.date(2003, 12, 31))

    # -- item ---------------------------------------------------------------
    isk = np.arange(1, n_item + 1)
    cat_id = (isk - 1) % 10 + 1
    class_id = (isk - 1) % 16 + 1
    brand_id = (isk - 1) % 1000 + 1001
    manufact_id = (isk - 1) % 1000 + 1
    manager_id = (isk - 1) % 100 + 1
    item = _batch({
        "i_item_sk": _lane(isk, _t.LONG),
        "i_item_id": _ids(n_item),
        "i_item_desc": string_column([f"item description {k}"
                                      for k in isk.tolist()]),
        "i_current_price": money7(rng.integers(99, 9999, n_item)),
        "i_wholesale_cost": money7(rng.integers(50, 6000, n_item)),
        "i_brand_id": _int(brand_id),
        "i_brand": dictionary_column(
            brand_id - 1001, [f"Brand#{b}" for b in range(1001, 2001)]),
        "i_class_id": _int(class_id),
        "i_class": dictionary_column(
            class_id - 1, [f"class{c:02d}" for c in range(1, 17)]),
        "i_category_id": _int(cat_id),
        "i_category": dictionary_column(cat_id - 1, CATEGORIES),
        "i_manufact_id": _int(manufact_id),
        "i_manufact": dictionary_column(
            manufact_id - 1, [f"Manufacturer#{m}" for m in range(1, 1001)]),
        "i_manager_id": _int(manager_id),
        "i_color": _cyc(COLORS, n_item),
    })

    # -- customer_demographics: fixed cross product (dsdgen keeps cd
    # scale-independent); sk enumerates the attribute combinations -------
    genders = ["M", "F"]
    maritals = ["M", "S", "D", "W", "U"]
    educations = ["Primary", "Secondary", "College", "2 yr Degree",
                  "4 yr Degree", "Advanced Degree", "Unknown"]
    credits = ["Low Risk", "High Risk", "Good", "Unknown"]
    combos = [(g, m, e, c) for c in credits for e in educations
              for m in maritals for g in genders]
    n_cd = len(combos)
    customer_demographics = _batch({
        "cd_demo_sk": _sk(n_cd),
        "cd_gender": string_column([x[0] for x in combos]),
        "cd_marital_status": string_column([x[1] for x in combos]),
        "cd_education_status": string_column([x[2] for x in combos]),
        "cd_credit_rating": string_column([x[3] for x in combos]),
    })

    # -- household_demographics: fixed 20 x 6 x 10 x 6 cross product ------
    hd = [(ib, bp, dep, veh)
          for ib in range(1, 21) for bp in range(len(BUY_POTENTIAL))
          for dep in range(10) for veh in range(-1, 5)]
    n_hd = len(hd)
    household_demographics = _batch({
        "hd_demo_sk": _sk(n_hd),
        "hd_income_band_sk": _lane([x[0] for x in hd], _t.LONG),
        "hd_buy_potential": dictionary_column([x[1] for x in hd],
                                              BUY_POTENTIAL),
        "hd_dep_count": _int([x[2] for x in hd]),
        "hd_vehicle_count": _int([x[3] for x in hd]),
    })

    # -- customer / customer_address --------------------------------------
    customer = _batch({
        "c_customer_sk": _sk(n_cust),
        "c_customer_id": _ids(n_cust),
        "c_current_cdemo_sk": _fk(rng, n_cd, n_cust),
        "c_current_hdemo_sk": _fk(rng, n_hd, n_cust),
        "c_current_addr_sk": _fk(rng, n_ca, n_cust, null_frac=0.0),
        "c_first_name": _cyc(_FIRST, n_cust),
        "c_last_name": _cyc(_LAST, n_cust),
        "c_salutation": _cyc(["Mr.", "Mrs.", "Ms.", "Dr.", "Sir"], n_cust),
        "c_preferred_cust_flag": _cyc(["Y", "N"], n_cust),
        "c_birth_year": _int(rng.integers(1924, 1993, n_cust)),
        "c_birth_country": _cyc(["UNITED STATES", "CANADA", "MEXICO",
                                 "GERMANY", "JAPAN"], n_cust),
    })
    row = np.arange(n_ca)
    zips = [f"{z:05d}" for z in range(100_000)]
    customer_address = _batch({
        "ca_address_sk": _sk(n_ca),
        "ca_city": _cyc(["Midway", "Fairview", "Oakland", "Unionville",
                         "Pleasant Hill", "Centerville"], n_ca),
        # state i % 20 and county i % 7 repeat every 140 rows
        "ca_county": dictionary_column(
            row % 140, [f"{STATES[j % 20]} County {j % 7}"
                        for j in range(140)]),
        "ca_state": _cyc(STATES, n_ca),
        "ca_zip": dictionary_column(((row + 1) * 7919) % 100_000, zips),
        "ca_country": dictionary_column(np.zeros(n_ca, np.int64),
                                        ["United States"]),
        "ca_gmt_offset": _lane(
            np.array([-500, -600, -700, -800] * (n_ca // 4 + 1),
                     np.int64)[:n_ca], _t.DecimalType(5, 2)),
    })

    # -- store / promotion / reason ---------------------------------------
    ssk = np.arange(1, n_store + 1)
    store = _batch({
        "s_store_sk": _lane(ssk, _t.LONG),
        "s_store_id": _ids(n_store),
        "s_store_name": _cyc(["ese", "ose", "able", "ought", "bar",
                              "cally"], n_store),
        "s_number_employees": _int(rng.integers(200, 301, n_store)),
        "s_city": _cyc(["Midway", "Fairview"], n_store),
        "s_county": dictionary_column(
            np.arange(n_store) % 8, [f"{s} County 0" for s in STATES[:8]]),
        "s_state": _cyc(STATES[:8], n_store),
        "s_zip": dictionary_column((ssk * 7919) % 100_000, zips),
        "s_gmt_offset": _lane(
            np.array([-500, -600] * (n_store // 2 + 1),
                     np.int64)[:n_store], _t.DecimalType(5, 2)),
    })
    promotion = _batch({
        "p_promo_sk": _sk(n_promo),
        "p_promo_id": _ids(n_promo),
        "p_channel_email": _cyc(["N", "N", "Y"], n_promo),
        "p_channel_event": _cyc(["N", "Y"], n_promo),
        "p_channel_dmail": _cyc(["Y", "N"], n_promo),
    })
    reason = _batch({
        "r_reason_sk": _sk(35),
        "r_reason_id": _ids(35),
        "r_reason_desc": string_column([f"reason {k}" for k in range(1, 36)]),
    })

    # -- fact helpers -------------------------------------------------------
    def _prices(n, qty):
        """The per-row money columns every channel shares, in cents."""
        wholesale = rng.integers(100, 10_000, n)
        list_p = (wholesale * rng.integers(110, 300, n)) // 100
        sales_p = (list_p * rng.integers(30, 101, n)) // 100
        ext_sales = sales_p * qty
        ext_wholesale = wholesale * qty
        ext_list = list_p * qty
        ext_discount = (list_p - sales_p) * qty
        ext_tax = (ext_sales * rng.integers(0, 9, n)) // 100
        coupon = np.where(rng.random(n) < 0.1,
                          (ext_sales * rng.integers(5, 30, n)) // 100, 0)
        net_paid = ext_sales - coupon
        net_profit = net_paid - ext_wholesale
        return {
            "wholesale_cost": wholesale, "list_price": list_p,
            "sales_price": sales_p, "ext_discount_amt": ext_discount,
            "ext_sales_price": ext_sales,
            "ext_wholesale_cost": ext_wholesale, "ext_list_price": ext_list,
            "ext_tax": ext_tax, "coupon_amt": coupon, "net_paid": net_paid,
            "net_paid_inc_tax": net_paid + ext_tax,
            "net_profit": net_profit,
        }

    # -- store_sales + store_returns ---------------------------------------
    ss_qty = rng.integers(1, 101, n_ss)
    ss_money = _prices(n_ss, ss_qty)
    ss_sold = rng.integers(sell_lo, sell_hi + 1, n_ss).astype(np.int64)
    ss_ticket = rng.integers(1, max(n_ss // 3, 2), n_ss).astype(np.int64)
    store_sales = _batch({
        "ss_sold_date_sk": _lane(ss_sold, _t.LONG),
        "ss_sold_time_sk": _fk(rng, 86399, n_ss),
        "ss_item_sk": _lane(rng.integers(1, n_item + 1, n_ss), _t.LONG),
        "ss_customer_sk": _fk(rng, n_cust, n_ss),
        "ss_cdemo_sk": _fk(rng, n_cd, n_ss),
        "ss_hdemo_sk": _fk(rng, n_hd, n_ss),
        "ss_addr_sk": _fk(rng, n_ca, n_ss),
        "ss_store_sk": _fk(rng, n_store, n_ss, null_frac=0.04),
        "ss_promo_sk": _fk(rng, n_promo, n_ss),
        "ss_ticket_number": _lane(ss_ticket, _t.LONG),
        "ss_quantity": _int(ss_qty),
        **{f"ss_{k}": money7(v) for k, v in ss_money.items()},
    })
    n_sr = max(n_ss // 10, 100)
    ret_rows = rng.choice(n_ss, n_sr, replace=False)
    sr_ret_qty = np.minimum(rng.integers(1, 101, n_sr), ss_qty[ret_rows])
    sr_amt = ss_money["sales_price"][ret_rows] * sr_ret_qty
    sr_returned = np.minimum(ss_sold[ret_rows] + rng.integers(1, 91, n_sr),
                             last_day)
    sr_reason = _fk(rng, 35, n_sr)
    sr_qty_valid = ~(rng.random(n_sr) < 0.05)
    store_returns = _batch({
        "sr_returned_date_sk": _lane(sr_returned, _t.LONG),
        "sr_item_sk": _take(store_sales.column_by_name("ss_item_sk"),
                            ret_rows),
        "sr_customer_sk": _take(store_sales.column_by_name("ss_customer_sk"),
                                ret_rows),
        "sr_ticket_number": _lane(ss_ticket[ret_rows], _t.LONG),
        "sr_reason_sk": sr_reason,
        "sr_return_quantity": HostColumn(
            np.where(sr_qty_valid, sr_ret_qty, 0).astype(np.int32),
            sr_qty_valid, _t.INT),
        "sr_return_amt": money7(sr_amt),
        "sr_return_tax": money7((sr_amt * rng.integers(0, 9, n_sr)) // 100),
        "sr_fee": money7(rng.integers(50, 10_000, n_sr)),
        "sr_net_loss": money7(sr_amt // 2 + rng.integers(50, 5_000, n_sr)),
    })

    # -- web_sales + web_returns -------------------------------------------
    ws_qty = rng.integers(1, 101, n_ws)
    ws_money = _prices(n_ws, ws_qty)
    ws_sold = rng.integers(sell_lo, sell_hi + 1, n_ws).astype(np.int64)
    ws_order = rng.integers(1, max(n_ws // 3, 2), n_ws).astype(np.int64)
    web_sales = _batch({
        "ws_sold_date_sk": _lane(ws_sold, _t.LONG),
        "ws_sold_time_sk": _fk(rng, 86399, n_ws),
        "ws_item_sk": _lane(rng.integers(1, n_item + 1, n_ws), _t.LONG),
        "ws_bill_customer_sk": _fk(rng, n_cust, n_ws),
        "ws_bill_cdemo_sk": _fk(rng, n_cd, n_ws),
        "ws_bill_addr_sk": _fk(rng, n_ca, n_ws),
        "ws_ship_customer_sk": _fk(rng, n_cust, n_ws, null_frac=0.04),
        "ws_promo_sk": _fk(rng, n_promo, n_ws),
        "ws_order_number": _lane(ws_order, _t.LONG),
        "ws_quantity": _int(ws_qty),
        **{f"ws_{k}": money7(v) for k, v in ws_money.items()},
    })
    n_wr = max(n_ws // 10, 50)
    wret = rng.choice(n_ws, n_wr, replace=False)
    wr_qty = np.minimum(rng.integers(1, 101, n_wr), ws_qty[wret])
    wr_amt = ws_money["sales_price"][wret] * wr_qty
    web_returns = _batch({
        "wr_returned_date_sk": _lane(
            np.minimum(ws_sold[wret] + rng.integers(1, 91, n_wr), last_day),
            _t.LONG),
        "wr_item_sk": _take(web_sales.column_by_name("ws_item_sk"), wret),
        "wr_order_number": _lane(ws_order[wret], _t.LONG),
        "wr_reason_sk": _fk(rng, 35, n_wr),
        "wr_return_quantity": _int(wr_qty),
        "wr_return_amt": money7(wr_amt),
        "wr_net_loss": money7(wr_amt // 2 + rng.integers(50, 5_000, n_wr)),
    })

    # -- catalog_sales + catalog_returns -----------------------------------
    cs_qty = rng.integers(1, 101, n_cs)
    cs_money = _prices(n_cs, cs_qty)
    cs_sold = rng.integers(sell_lo, sell_hi + 1, n_cs).astype(np.int64)
    cs_order = rng.integers(1, max(n_cs // 3, 2), n_cs).astype(np.int64)
    catalog_sales = _batch({
        "cs_sold_date_sk": _lane(cs_sold, _t.LONG),
        "cs_sold_time_sk": _fk(rng, 86399, n_cs),
        "cs_item_sk": _lane(rng.integers(1, n_item + 1, n_cs), _t.LONG),
        "cs_bill_customer_sk": _fk(rng, n_cust, n_cs),
        "cs_bill_cdemo_sk": _fk(rng, n_cd, n_cs),
        "cs_bill_addr_sk": _fk(rng, n_ca, n_cs),
        "cs_ship_addr_sk": _fk(rng, n_ca, n_cs, null_frac=0.04),
        "cs_promo_sk": _fk(rng, n_promo, n_cs),
        "cs_order_number": _lane(cs_order, _t.LONG),
        "cs_quantity": _int(cs_qty),
        **{f"cs_{k}": money7(v) for k, v in cs_money.items()},
    })
    n_cr = max(n_cs // 10, 50)
    cret = rng.choice(n_cs, n_cr, replace=False)
    cr_qty = np.minimum(rng.integers(1, 101, n_cr), cs_qty[cret])
    cr_amt = cs_money["sales_price"][cret] * cr_qty
    catalog_returns = _batch({
        "cr_returned_date_sk": _lane(
            np.minimum(cs_sold[cret] + rng.integers(1, 91, n_cr), last_day),
            _t.LONG),
        "cr_item_sk": _take(catalog_sales.column_by_name("cs_item_sk"),
                            cret),
        "cr_order_number": _lane(cs_order[cret], _t.LONG),
        "cr_reason_sk": _fk(rng, 35, n_cr),
        "cr_return_quantity": _int(cr_qty),
        "cr_return_amount": money7(cr_amt),
        "cr_net_loss": money7(cr_amt // 2 + rng.integers(50, 5_000, n_cr)),
    })

    return {
        "date_dim": date_dim, "time_dim": time_dim, "item": item,
        "customer": customer, "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "household_demographics": household_demographics,
        "store": store, "promotion": promotion, "reason": reason,
        "store_sales": store_sales, "store_returns": store_returns,
        "web_sales": web_sales, "web_returns": web_returns,
        "catalog_sales": catalog_sales, "catalog_returns": catalog_returns,
    }


# ---------------------------------------------------------------------------
# Query corpus
# ---------------------------------------------------------------------------
# Parameter substitutions are chosen wide enough that every query returns
# rows at the tier-1 tiny scale (the spec's qgen randomizes them anyway);
# the operator SHAPE of each query follows the spec text.

def _dd(s: TpuSession, t, **eq) -> DataFrame:
    """date_dim with equality filters, e.g. _dd(s, t, d_year=2000)."""
    df = s.from_host(t["date_dim"])
    for k, v in eq.items():
        df = df.filter(E.EqualTo(col(k), E.Literal(v)))
    return df


def _between(c, lo, hi) -> E.Expression:
    return E.And(E.GreaterThanOrEqual(c, E.Literal(lo)),
                 E.LessThanOrEqual(c, E.Literal(hi)))


def _dbl(c) -> E.Expression:
    return E.Cast(c, _t.DOUBLE)


def q3(s: TpuSession, t) -> DataFrame:
    """Brand revenue for a manufacturer band in November."""
    j = (_dd(s, t, d_moy=11)
         .join(s.from_host(t["store_sales"]),
               left_on=["d_date_sk"], right_on=["ss_sold_date_sk"])
         .join(s.from_host(t["item"]).filter(
             _between(col("i_manufact_id"), 120, 140)),
             left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    return (j.group_by("d_year", "i_brand_id", "i_brand")
            .agg((Sum(col("ss_ext_sales_price")), "sum_agg"))
            .sort(("d_year", True, True), ("sum_agg", False, False),
                  ("i_brand_id", True, True))
            .limit(100))


def q7(s: TpuSession, t) -> DataFrame:
    """Demographic averages by item (cd + promotion dims)."""
    cd = s.from_host(t["customer_demographics"]).filter(E.And(
        E.And(E.EqualTo(col("cd_gender"), E.Literal("M")),
              E.EqualTo(col("cd_marital_status"), E.Literal("S"))),
        E.EqualTo(col("cd_education_status"), E.Literal("College"))))
    promo = s.from_host(t["promotion"]).filter(
        E.Or(E.EqualTo(col("p_channel_email"), E.Literal("N")),
             E.EqualTo(col("p_channel_event"), E.Literal("N"))))
    j = (s.from_host(t["store_sales"])
         .join(cd, left_on=["ss_cdemo_sk"], right_on=["cd_demo_sk"])
         .join(_dd(s, t, d_year=2000),
               left_on=["ss_sold_date_sk"], right_on=["d_date_sk"])
         .join(s.from_host(t["item"]),
               left_on=["ss_item_sk"], right_on=["i_item_sk"])
         .join(promo, left_on=["ss_promo_sk"], right_on=["p_promo_sk"]))
    return (j.group_by("i_item_id")
            .agg((Average(_dbl(col("ss_quantity"))), "agg1"),
                 (Average(_dbl(col("ss_list_price"))), "agg2"),
                 (Average(_dbl(col("ss_coupon_amt"))), "agg3"),
                 (Average(_dbl(col("ss_sales_price"))), "agg4"))
            .sort("i_item_id").limit(100))


def _revenue_ratio(s, t, fact, date_fk, item_fk, price, keys_sort):
    """q12/q20/q98 shape: per-item revenue + class-partition revenue
    ratio via a window total (100 * rev / sum(rev) over i_class)."""
    d_lo = _days(pydt.date(1999, 2, 22))
    dd = s.from_host(t["date_dim"]).filter(E.And(
        E.GreaterThanOrEqual(col("d_date"), E.Literal(d_lo, DTYPE_DATE)),
        E.LessThanOrEqual(col("d_date"),
                          E.Literal(d_lo + 30, DTYPE_DATE))))
    item = s.from_host(t["item"]).filter(
        E.In(col("i_category"), ["Sports", "Books", "Home"]))
    j = (s.from_host(t[fact])
         .join(item, left_on=[item_fk], right_on=["i_item_sk"])
         .join(dd, left_on=[date_fk], right_on=["d_date_sk"]))
    g = (j.group_by("i_item_id", "i_item_desc", "i_category", "i_class",
                    "i_current_price")
         .agg((Sum(col(price)), "itemrevenue")))
    g = g.with_column("rev_d", _dbl(col("itemrevenue")))
    from .plan.window import WinSum
    w = g.window([(WinSum(col("rev_d")), "class_rev")],
                 partition_by=["i_class"])
    ratio = E.Divide(E.Multiply(col("rev_d"), E.Literal(100.0)),
                     col("class_rev"))
    return (w.select(col("i_item_id"), col("i_item_desc"),
                     col("i_category"), col("i_class"),
                     col("i_current_price"), col("itemrevenue"), ratio,
                     names=["i_item_id", "i_item_desc", "i_category",
                            "i_class", "i_current_price", "itemrevenue",
                            "revenueratio"])
            .sort(*keys_sort).limit(100))


_RATIO_SORT = (("i_category", True, True), ("i_class", True, True),
               ("i_item_id", True, True), ("i_item_desc", True, True),
               ("revenueratio", True, True))


def q12(s: TpuSession, t) -> DataFrame:
    """Web revenue ratio within item class (window partition total)."""
    return _revenue_ratio(s, t, "web_sales", "ws_sold_date_sk",
                          "ws_item_sk", "ws_ext_sales_price", _RATIO_SORT)


def q19(s: TpuSession, t) -> DataFrame:
    """Brand revenue where customer and store are in different zips."""
    from .plan.strings import Substring
    j = (_dd(s, t, d_moy=11, d_year=1998)
         .join(s.from_host(t["store_sales"]),
               left_on=["d_date_sk"], right_on=["ss_sold_date_sk"])
         .join(s.from_host(t["item"]).filter(
             _between(col("i_manager_id"), 1, 20)),
             left_on=["ss_item_sk"], right_on=["i_item_sk"])
         .join(s.from_host(t["customer"]),
               left_on=["ss_customer_sk"], right_on=["c_customer_sk"])
         .join(s.from_host(t["customer_address"]),
               left_on=["c_current_addr_sk"], right_on=["ca_address_sk"])
         .join(s.from_host(t["store"]),
               left_on=["ss_store_sk"], right_on=["s_store_sk"])
         .filter(E.Not(E.EqualTo(Substring(col("ca_zip"), 1, 5),
                                 Substring(col("s_zip"), 1, 5)))))
    return (j.group_by("i_brand_id", "i_brand", "i_manufact_id",
                       "i_manufact")
            .agg((Sum(col("ss_ext_sales_price")), "ext_price"))
            .sort(("ext_price", False, False), ("i_brand", True, True),
                  ("i_brand_id", True, True), ("i_manufact_id", True, True),
                  ("i_manufact", True, True))
            .limit(100))


def q20(s: TpuSession, t) -> DataFrame:
    """Catalog revenue ratio within item class."""
    return _revenue_ratio(s, t, "catalog_sales", "cs_sold_date_sk",
                          "cs_item_sk", "cs_ext_sales_price", _RATIO_SORT)


def q26(s: TpuSession, t) -> DataFrame:
    """Catalog demographic averages by item (q7's catalog twin)."""
    cd = s.from_host(t["customer_demographics"]).filter(E.And(
        E.And(E.EqualTo(col("cd_gender"), E.Literal("M")),
              E.EqualTo(col("cd_marital_status"), E.Literal("S"))),
        E.EqualTo(col("cd_education_status"), E.Literal("College"))))
    promo = s.from_host(t["promotion"]).filter(
        E.Or(E.EqualTo(col("p_channel_email"), E.Literal("N")),
             E.EqualTo(col("p_channel_event"), E.Literal("N"))))
    j = (s.from_host(t["catalog_sales"])
         .join(cd, left_on=["cs_bill_cdemo_sk"], right_on=["cd_demo_sk"])
         .join(_dd(s, t, d_year=2000),
               left_on=["cs_sold_date_sk"], right_on=["d_date_sk"])
         .join(s.from_host(t["item"]),
               left_on=["cs_item_sk"], right_on=["i_item_sk"])
         .join(promo, left_on=["cs_promo_sk"], right_on=["p_promo_sk"]))
    return (j.group_by("i_item_id")
            .agg((Average(_dbl(col("cs_quantity"))), "agg1"),
                 (Average(_dbl(col("cs_list_price"))), "agg2"),
                 (Average(_dbl(col("cs_coupon_amt"))), "agg3"),
                 (Average(_dbl(col("cs_sales_price"))), "agg4"))
            .sort("i_item_id").limit(100))


def q27(s: TpuSession, t) -> DataFrame:
    """Store demographics under ROLLUP(i_item_id, s_state) with
    grouping(s_state) — the Expand lowering end to end."""
    cd = s.from_host(t["customer_demographics"]).filter(E.And(
        E.And(E.EqualTo(col("cd_gender"), E.Literal("M")),
              E.EqualTo(col("cd_marital_status"), E.Literal("S"))),
        E.EqualTo(col("cd_education_status"), E.Literal("College"))))
    j = (s.from_host(t["store_sales"])
         .join(cd, left_on=["ss_cdemo_sk"], right_on=["cd_demo_sk"])
         .join(_dd(s, t, d_year=2000),
               left_on=["ss_sold_date_sk"], right_on=["d_date_sk"])
         .join(s.from_host(t["store"]).filter(
             E.In(col("s_state"), ["TN", "SC", "AL", "GA", "SD", "MI"])),
             left_on=["ss_store_sk"], right_on=["s_store_sk"])
         .join(s.from_host(t["item"]),
               left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    r = j.rollup("i_item_id", "s_state")
    g = r.agg((Average(_dbl(col("ss_quantity"))), "agg1"),
              (Average(_dbl(col("ss_list_price"))), "agg2"),
              (Average(_dbl(col("ss_coupon_amt"))), "agg3"),
              (Average(_dbl(col("ss_sales_price"))), "agg4"))
    return (g.select(col("i_item_id"), col("s_state"),
                     r.grouping("s_state"), col("agg1"), col("agg2"),
                     col("agg3"), col("agg4"),
                     names=["i_item_id", "s_state", "g_state", "agg1",
                            "agg2", "agg3", "agg4"])
            .sort(("i_item_id", True, True), ("s_state", True, True))
            .limit(100))


def _channel_union(s, t, sel_items, sel_key, group_col,
                   d_year, d_moy):
    """q33/q56/q60 shape: the same (date, address, item, item-subset
    semi join, group, sum) pipeline over all three sales channels,
    UNION ALLed and re-aggregated."""
    channels = [("store_sales", "ss_sold_date_sk", "ss_addr_sk",
                 "ss_item_sk", "ss_ext_sales_price"),
                ("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
                 "ws_item_sk", "ws_ext_sales_price"),
                ("catalog_sales", "cs_sold_date_sk", "cs_bill_addr_sk",
                 "cs_item_sk", "cs_ext_sales_price")]
    parts = []
    for fact, date_fk, addr_fk, item_fk, price in channels:
        ca = s.from_host(t["customer_address"]).filter(
            E.EqualTo(col("ca_gmt_offset"),
                      E.Literal(__import__("decimal").Decimal("-5.00"))))
        j = (s.from_host(t[fact])
             .join(_dd(s, t, d_year=d_year, d_moy=d_moy),
                   left_on=[date_fk], right_on=["d_date_sk"])
             .join(ca, left_on=[addr_fk], right_on=["ca_address_sk"])
             .join(s.from_host(t["item"]),
                   left_on=[item_fk], right_on=["i_item_sk"])
             .join(sel_items(s), how="left_semi",
                   left_on=[group_col], right_on=[sel_key]))
        parts.append(
            j.group_by(group_col)
            .agg((Sum(_dbl(col(price))), "total_sales")))
    u = parts[0].union(parts[1]).union(parts[2])
    return (u.group_by(group_col)
            .agg((Sum(col("total_sales")), "total_sales"))
            .sort(("total_sales", True, True), (group_col, True, True))
            .limit(100))


def q33(s: TpuSession, t) -> DataFrame:
    """Electronics manufacturer revenue across all three channels."""
    def sel(sess):
        return (sess.from_host(t["item"])
                .filter(E.EqualTo(col("i_category"),
                                  E.Literal("Electronics")))
                .select(col("i_manufact_id"), names=["sel_manufact_id"]))
    return _channel_union(s, t, sel, "sel_manufact_id", "i_manufact_id",
                          1998, 5)


def q36(s: TpuSession, t) -> DataFrame:
    """Gross margin hierarchy: ROLLUP(i_category, i_class) + rank()
    within each hierarchy level (grouping_id-driven window)."""
    from .plan.window import Rank
    j = (s.from_host(t["store_sales"])
         .join(_dd(s, t, d_year=2001),
               left_on=["ss_sold_date_sk"], right_on=["d_date_sk"])
         .join(s.from_host(t["item"]),
               left_on=["ss_item_sk"], right_on=["i_item_sk"])
         .join(s.from_host(t["store"]).filter(
             E.In(col("s_state"), ["TN", "SC", "AL", "GA", "SD", "MI",
                                   "OH", "TX"])),
             left_on=["ss_store_sk"], right_on=["s_store_sk"]))
    r = j.rollup("i_category", "i_class")
    g = r.agg((Sum(col("ss_net_profit")), "profit"),
              (Sum(col("ss_ext_sales_price")), "sales"))
    margin = E.Divide(_dbl(col("profit")), _dbl(col("sales")))
    lochier = E.Add(r.grouping("i_category"), r.grouping("i_class"))
    parent = E.CaseWhen(
        [(E.EqualTo(r.grouping("i_class"), E.Literal(0)),
          col("i_category"))], E.Literal(None, _t.STRING))
    g = g.select(margin, col("i_category"), col("i_class"), lochier,
                 parent,
                 names=["gross_margin", "i_category", "i_class",
                        "lochierarchy", "parent_cat"])
    w = g.window([(Rank(), "rank_within_parent")],
                 partition_by=["lochierarchy", "parent_cat"],
                 order_by=[("gross_margin", True, True)])
    sort_cat = E.CaseWhen(
        [(E.EqualTo(col("lochierarchy"), E.Literal(0)),
          col("i_category"))], E.Literal(None, _t.STRING))
    w = w.with_column("sort_cat", sort_cat)
    return (w.select(col("gross_margin"), col("i_category"),
                     col("i_class"), col("lochierarchy"),
                     col("rank_within_parent"), col("sort_cat"),
                     names=["gross_margin", "i_category", "i_class",
                            "lochierarchy", "rank_within_parent",
                            "sort_cat"])
            .sort(("lochierarchy", False, False),
                  ("sort_cat", True, True),
                  ("rank_within_parent", True, True),
                  ("i_category", True, True), ("i_class", True, True))
            .limit(100))


def q42(s: TpuSession, t) -> DataFrame:
    """Category revenue for a manager band in November."""
    j = (_dd(s, t, d_moy=11, d_year=2000)
         .join(s.from_host(t["store_sales"]),
               left_on=["d_date_sk"], right_on=["ss_sold_date_sk"])
         .join(s.from_host(t["item"]).filter(
             _between(col("i_manager_id"), 1, 10)),
             left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    return (j.group_by("d_year", "i_category_id", "i_category")
            .agg((Sum(col("ss_ext_sales_price")), "total_sales"))
            .sort(("total_sales", False, False), ("d_year", True, True),
                  ("i_category_id", True, True),
                  ("i_category", True, True))
            .limit(100))


def q43(s: TpuSession, t) -> DataFrame:
    """Store sales pivoted by day-of-week (CASE WHEN sums)."""
    import decimal as pydec
    j = (_dd(s, t, d_year=2000)
         .join(s.from_host(t["store_sales"]),
               left_on=["d_date_sk"], right_on=["ss_sold_date_sk"])
         .join(s.from_host(t["store"]).filter(
             E.EqualTo(col("s_gmt_offset"),
                       E.Literal(pydec.Decimal("-5.00")))),
             left_on=["ss_store_sk"], right_on=["s_store_sk"]))
    zero = E.Literal(pydec.Decimal("0.00"))

    def day_sum(day):
        return Sum(E.CaseWhen(
            [(E.EqualTo(col("d_day_name"), E.Literal(day)),
              col("ss_sales_price"))], zero))
    return (j.group_by("s_store_name", "s_store_id")
            .agg((day_sum("Sunday"), "sun_sales"),
                 (day_sum("Monday"), "mon_sales"),
                 (day_sum("Tuesday"), "tue_sales"),
                 (day_sum("Wednesday"), "wed_sales"),
                 (day_sum("Thursday"), "thu_sales"),
                 (day_sum("Friday"), "fri_sales"),
                 (day_sum("Saturday"), "sat_sales"))
            .sort("s_store_name", "s_store_id").limit(100))


def q52(s: TpuSession, t) -> DataFrame:
    """Brand revenue, November 2000 (q3's manager-filter twin)."""
    j = (_dd(s, t, d_moy=11, d_year=2000)
         .join(s.from_host(t["store_sales"]),
               left_on=["d_date_sk"], right_on=["ss_sold_date_sk"])
         .join(s.from_host(t["item"]).filter(
             _between(col("i_manager_id"), 1, 10)),
             left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    return (j.group_by("d_year", "i_brand_id", "i_brand")
            .agg((Sum(col("ss_ext_sales_price")), "ext_price"))
            .sort(("d_year", True, True), ("ext_price", False, False),
                  ("i_brand_id", True, True))
            .limit(100))


def q55(s: TpuSession, t) -> DataFrame:
    """Brand revenue for one manager's items."""
    j = (_dd(s, t, d_moy=11, d_year=1999)
         .join(s.from_host(t["store_sales"]),
               left_on=["d_date_sk"], right_on=["ss_sold_date_sk"])
         .join(s.from_host(t["item"]).filter(
             _between(col("i_manager_id"), 20, 40)),
             left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    return (j.group_by("i_brand_id", "i_brand")
            .agg((Sum(col("ss_ext_sales_price")), "ext_price"))
            .sort(("ext_price", False, False), ("i_brand_id", True, True))
            .limit(100))


def q56(s: TpuSession, t) -> DataFrame:
    """Colored-item revenue across all three channels by item id."""
    def sel(sess):
        return (sess.from_host(t["item"])
                .filter(E.In(col("i_color"),
                             ["slate", "blanched", "burnished"]))
                .select(col("i_item_id"), names=["sel_item_id"]))
    return _channel_union(s, t, sel, "sel_item_id", "i_item_id", 2001, 2)


def q60(s: TpuSession, t) -> DataFrame:
    """Music-category revenue across all three channels by item id."""
    def sel(sess):
        return (sess.from_host(t["item"])
                .filter(E.EqualTo(col("i_category"), E.Literal("Music")))
                .select(col("i_item_id"), names=["sel_item_id"]))
    return _channel_union(s, t, sel, "sel_item_id", "i_item_id", 1998, 9)


def q65(s: TpuSession, t) -> DataFrame:
    """Under-performing items: per-(store,item) revenue vs 10% of the
    store's average item revenue (two aggregate subqueries joined)."""
    dd = s.from_host(t["date_dim"]).filter(
        _between(col("d_month_seq"), 1176, 1187))
    rev = (s.from_host(t["store_sales"])
           .join(dd, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"])
           .group_by("ss_store_sk", "ss_item_sk")
           .agg((Sum(col("ss_sales_price")), "revenue")))
    rev = rev.select(col("ss_store_sk"), col("ss_item_sk"),
                     _dbl(col("revenue")),
                     names=["ss_store_sk", "ss_item_sk", "revenue"])
    ave = (rev.group_by("ss_store_sk")
           .agg((Average(col("revenue")), "ave"))
           .select(col("ss_store_sk"), col("ave"),
                   names=["avg_store_sk", "ave"]))
    j = (rev.join(ave, left_on=["ss_store_sk"], right_on=["avg_store_sk"])
         .filter(E.LessThanOrEqual(
             col("revenue"), E.Multiply(E.Literal(0.1), col("ave"))))
         .join(s.from_host(t["store"]),
               left_on=["ss_store_sk"], right_on=["s_store_sk"])
         .join(s.from_host(t["item"]),
               left_on=["ss_item_sk"], right_on=["i_item_sk"]))
    return (j.select(col("s_store_name"), col("i_item_desc"),
                     col("revenue"), col("i_current_price"),
                     col("i_wholesale_cost"), col("i_brand"))
            .sort(("s_store_name", True, True), ("i_item_desc", True, True),
                  ("revenue", True, True))
            .limit(100))


def q70(s: TpuSession, t) -> DataFrame:
    """Profit hierarchy over ROLLUP(s_state, s_county), restricted to
    the top-5 states by a ranking-window subquery."""
    from .plan.window import Rank
    dd = s.from_host(t["date_dim"]).filter(
        _between(col("d_month_seq"), 1200, 1211))
    base = (s.from_host(t["store_sales"])
            .join(dd, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"])
            .join(s.from_host(t["store"]),
                  left_on=["ss_store_sk"], right_on=["s_store_sk"]))
    per_state = (base.group_by("s_state")
                 .agg((Sum(col("ss_net_profit")), "sp"))
                 .select(col("s_state"), _dbl(col("sp")),
                         names=["t_state", "sp"]))
    top = (per_state.window([(Rank(), "ranking")],
                            order_by=[("sp", False, False)])
           .filter(E.LessThanOrEqual(col("ranking"), E.Literal(5)))
           .select(col("t_state"), names=["top_state"]))
    j = base.join(top, how="left_semi",
                  left_on=["s_state"], right_on=["top_state"])
    r = j.rollup("s_state", "s_county")
    g = r.agg((Sum(col("ss_net_profit")), "total_sum"))
    lochier = E.Add(r.grouping("s_state"), r.grouping("s_county"))
    parent = E.CaseWhen(
        [(E.EqualTo(r.grouping("s_county"), E.Literal(0)),
          col("s_state"))], E.Literal(None, _t.STRING))
    g = g.select(col("total_sum"), col("s_state"), col("s_county"),
                 lochier, parent, _dbl(col("total_sum")),
                 names=["total_sum", "s_state", "s_county",
                        "lochierarchy", "parent_state", "total_d"])
    w = g.window([(Rank(), "rank_within_parent")],
                 partition_by=["lochierarchy", "parent_state"],
                 order_by=[("total_d", False, False)])
    sort_state = E.CaseWhen(
        [(E.EqualTo(col("lochierarchy"), E.Literal(0)),
          col("s_state"))], E.Literal(None, _t.STRING))
    w = w.with_column("sort_state", sort_state)
    return (w.select(col("total_sum"), col("s_state"), col("s_county"),
                     col("lochierarchy"), col("rank_within_parent"),
                     col("sort_state"),
                     names=["total_sum", "s_state", "s_county",
                            "lochierarchy", "rank_within_parent",
                            "sort_state"])
            .sort(("lochierarchy", False, False),
                  ("sort_state", True, True),
                  ("rank_within_parent", True, True),
                  ("s_state", True, True), ("s_county", True, True))
            .limit(100))


def q73(s: TpuSession, t) -> DataFrame:
    """Ticket counts per customer for high-dependency households."""
    hd = s.from_host(t["household_demographics"]).filter(E.And(
        E.And(E.Or(E.EqualTo(col("hd_buy_potential"),
                             E.Literal(">10000")),
                   E.EqualTo(col("hd_buy_potential"),
                             E.Literal("unknown"))),
              E.GreaterThan(col("hd_vehicle_count"), E.Literal(0))),
        E.GreaterThan(
            E.Divide(_dbl(col("hd_dep_count")),
                     _dbl(col("hd_vehicle_count"))),
            E.Literal(1.0))))
    dd = s.from_host(t["date_dim"]).filter(E.And(
        _between(col("d_dom"), 1, 2),
        E.In(col("d_year"), [1999, 2000, 2001])))
    j = (s.from_host(t["store_sales"])
         .join(dd, left_on=["ss_sold_date_sk"], right_on=["d_date_sk"])
         .join(s.from_host(t["store"]),
               left_on=["ss_store_sk"], right_on=["s_store_sk"])
         .join(hd, left_on=["ss_hdemo_sk"], right_on=["hd_demo_sk"]))
    dj = (j.group_by("ss_ticket_number", "ss_customer_sk")
          .agg((Count(None), "cnt"))
          .filter(_between(col("cnt"), 1, 5)))
    out = dj.join(s.from_host(t["customer"]),
                  left_on=["ss_customer_sk"], right_on=["c_customer_sk"])
    return (out.select(col("c_last_name"), col("c_first_name"),
                       col("c_salutation"), col("c_preferred_cust_flag"),
                       col("ss_ticket_number"), col("cnt"))
            .sort(("cnt", False, False), ("c_last_name", True, True),
                  ("ss_ticket_number", True, True)))


def q76(s: TpuSession, t) -> DataFrame:
    """NULL-key sales per channel: UNION ALL with literal channel tags
    over rows whose customer/store/address fk is null."""
    channels = [
        ("store", "ss_store_sk", "store_sales", "ss_sold_date_sk",
         "ss_item_sk", "ss_ext_sales_price"),
        ("web", "ws_ship_customer_sk", "web_sales", "ws_sold_date_sk",
         "ws_item_sk", "ws_ext_sales_price"),
        ("catalog", "cs_ship_addr_sk", "catalog_sales", "cs_sold_date_sk",
         "cs_item_sk", "cs_ext_sales_price"),
    ]
    parts = []
    for chan, null_col, fact, date_fk, item_fk, price in channels:
        j = (s.from_host(t[fact]).filter(E.IsNull(col(null_col)))
             .join(s.from_host(t["item"]),
                   left_on=[item_fk], right_on=["i_item_sk"])
             .join(s.from_host(t["date_dim"]),
                   left_on=[date_fk], right_on=["d_date_sk"]))
        parts.append(j.select(
            E.Literal(chan), E.Literal(null_col), col("d_year"),
            col("d_qoy"), col("i_category"), _dbl(col(price)),
            names=["channel", "col_name", "d_year", "d_qoy", "i_category",
                   "ext_sales_price"]))
    u = parts[0].union(parts[1]).union(parts[2])
    return (u.group_by("channel", "col_name", "d_year", "d_qoy",
                       "i_category")
            .agg((Count(None), "sales_cnt"),
                 (Sum(col("ext_sales_price")), "sales_amt"))
            .sort("channel", "col_name", "d_year", "d_qoy", "i_category")
            .limit(100))


def q86(s: TpuSession, t) -> DataFrame:
    """Web net-paid hierarchy: ROLLUP(i_category, i_class) + rank()
    within each hierarchy level."""
    from .plan.window import Rank
    dd = s.from_host(t["date_dim"]).filter(
        _between(col("d_month_seq"), 1200, 1211))
    j = (s.from_host(t["web_sales"])
         .join(dd, left_on=["ws_sold_date_sk"], right_on=["d_date_sk"])
         .join(s.from_host(t["item"]),
               left_on=["ws_item_sk"], right_on=["i_item_sk"]))
    r = j.rollup("i_category", "i_class")
    g = r.agg((Sum(col("ws_net_paid")), "total_sum"))
    lochier = E.Add(r.grouping("i_category"), r.grouping("i_class"))
    parent = E.CaseWhen(
        [(E.EqualTo(r.grouping("i_class"), E.Literal(0)),
          col("i_category"))], E.Literal(None, _t.STRING))
    g = g.select(col("total_sum"), col("i_category"), col("i_class"),
                 lochier, parent, _dbl(col("total_sum")),
                 names=["total_sum", "i_category", "i_class",
                        "lochierarchy", "parent_cat", "total_d"])
    w = g.window([(Rank(), "rank_within_parent")],
                 partition_by=["lochierarchy", "parent_cat"],
                 order_by=[("total_d", False, False)])
    sort_cat = E.CaseWhen(
        [(E.EqualTo(col("lochierarchy"), E.Literal(0)),
          col("i_category"))], E.Literal(None, _t.STRING))
    w = w.with_column("sort_cat", sort_cat)
    return (w.select(col("total_sum"), col("i_category"), col("i_class"),
                     col("lochierarchy"), col("rank_within_parent"),
                     col("sort_cat"),
                     names=["total_sum", "i_category", "i_class",
                            "lochierarchy", "rank_within_parent",
                            "sort_cat"])
            .sort(("lochierarchy", False, False),
                  ("sort_cat", True, True),
                  ("rank_within_parent", True, True),
                  ("i_category", True, True), ("i_class", True, True))
            .limit(100))


def q93(s: TpuSession, t) -> DataFrame:
    """Actual sales after returns: left-outer against store_returns,
    CASE over the nullable return quantity, reason-coded returns only."""
    sr = (s.from_host(t["store_returns"])
          .join(s.from_host(t["reason"]).filter(
              E.EqualTo(col("r_reason_desc"), E.Literal("reason 28"))),
              left_on=["sr_reason_sk"], right_on=["r_reason_sk"]))
    j = s.from_host(t["store_sales"]).join(
        sr, how="inner",
        left_on=["ss_item_sk", "ss_ticket_number"],
        right_on=["sr_item_sk", "sr_ticket_number"])
    act = E.CaseWhen(
        [(E.IsNotNull(col("sr_return_quantity")),
          E.Multiply(_dbl(E.Subtract(col("ss_quantity"),
                                     col("sr_return_quantity"))),
                     _dbl(col("ss_sales_price"))))],
        E.Multiply(_dbl(col("ss_quantity")), _dbl(col("ss_sales_price"))))
    g = (j.select(col("ss_customer_sk"), act,
                  names=["ss_customer_sk", "act_sales"])
         .group_by("ss_customer_sk")
         .agg((Sum(col("act_sales")), "sumsales")))
    return (g.sort(("sumsales", True, True), ("ss_customer_sk", True, True))
            .limit(100))


def q96(s: TpuSession, t) -> DataFrame:
    """Evening-rush ticket count (time_dim + household filters)."""
    td = s.from_host(t["time_dim"]).filter(E.And(
        E.EqualTo(col("t_hour"), E.Literal(20)),
        E.GreaterThanOrEqual(col("t_minute"), E.Literal(30))))
    hd = s.from_host(t["household_demographics"]).filter(
        E.EqualTo(col("hd_dep_count"), E.Literal(7)))
    st = s.from_host(t["store"]).filter(
        E.EqualTo(col("s_store_name"), E.Literal("ese")))
    j = (s.from_host(t["store_sales"])
         .join(td, left_on=["ss_sold_time_sk"], right_on=["t_time_sk"])
         .join(hd, left_on=["ss_hdemo_sk"], right_on=["hd_demo_sk"])
         .join(st, left_on=["ss_store_sk"], right_on=["s_store_sk"]))
    return j.agg((Count(None), "cnt"))


def q98(s: TpuSession, t) -> DataFrame:
    """Store revenue ratio within item class (q12's store twin)."""
    return _revenue_ratio(s, t, "store_sales", "ss_sold_date_sk",
                          "ss_item_sk", "ss_ext_sales_price", _RATIO_SORT)


QUERIES = {"q3": q3, "q7": q7, "q12": q12, "q19": q19, "q20": q20,
           "q26": q26, "q27": q27, "q33": q33, "q36": q36, "q42": q42,
           "q43": q43, "q52": q52, "q55": q55, "q56": q56, "q60": q60,
           "q65": q65, "q70": q70, "q73": q73, "q76": q76, "q86": q86,
           "q93": q93, "q96": q96, "q98": q98}
