"""The TPC-DS side of chip_smoke.py: independent numpy results of the 23
TPC-DS queries (spark_rapids_tpu_torch.tpcds.QUERIES) and of the window
phase, and the comparisons that hold the port's results to them.

Each query is recomputed from the generator's numpy tables without the
engine: a dimension row is found by its surrogate key (item, customer,
address, store, promotion, demographics and reason keys are 1..n, the
date key is the Julian day, the time key the second of the day), a
nullable foreign key drops its null rows as an inner join does, groups
come from a lexsort and run boundaries, decimal sums are exact int64
`np.add.reduceat`, averages of DOUBLE casts divide the f64 sum by the
count, and the rollups, ranks and window totals are spelled out per
level.  `compare` checks a result with its sort order: equal sort
keys row by row, then each run of tied keys as a multiset (the engine
orders tied rows by its upstream order), and a tie cut by the LIMIT only
from the tied set; DOUBLE columns within rtol 1e-12 (the README's f64
tolerance), everything else exactly.

Run by chip_smoke.py (`tpcds` and `window` phases); imports numpy only.
"""
from __future__ import annotations

import datetime as pydt
import math

import numpy as np

JDN_OFFSET = 1721425
RTOL = 1e-12


def _jdn(d: pydt.date) -> int:
    return d.toordinal() + JDN_OFFSET


def _days(d: pydt.date) -> int:
    return (d - pydt.date(1970, 1, 1)).days


class Tables:
    """Column access over the generator's HostBatches.  Dimension
    attributes are looked up per fact row by surrogate key; string
    attributes as their dictionary codes (the sorted dictionaries make
    code order string order), decoded once a result is small."""

    def __init__(self, tables):
        self.t = tables
        self.d0 = int(self.v("date_dim", "d_date_sk")[0])

    def c(self, table, name):
        return self.t[table].column_by_name(name)

    def v(self, table, name):
        return self.c(table, name).data

    def ok(self, table, name):
        c = self.c(table, name)
        return np.ones(len(c.data), bool) if c.validity is None \
            else c.validity

    def s(self, table, name):
        """A (dimension's) string column's values per row."""
        c = self.c(table, name)
        return c.dictionary[c.data]

    def decode(self, table, name, codes):
        return self.c(table, name).dictionary[codes]

    def date(self, lane, date_sk):
        """A date_dim-level lane at each date key."""
        return lane[date_sk - self.d0]

    def dd(self, name, date_sk):
        return self.date(self.v("date_dim", name), date_sk)

    def fk(self, fact, name, rows=None):
        """(key, valid) of a nullable foreign key (null rows' key 1, a
        valid index)."""
        k, ok = self.v(fact, name), self.ok(fact, name)
        if rows is not None:
            k, ok = k[rows], ok[rows]
        return np.where(ok, k, 1), ok


def _codes(values: np.ndarray) -> np.ndarray:
    """int64 codes in value order (strings -> their rank)."""
    if values.dtype.kind in "iub":
        return values.astype(np.int64)
    _u, inv = np.unique(values, return_inverse=True)
    return inv.astype(np.int64)


def group(keys, sums=()):
    """Group rows by the key arrays (ascending): -> (per-key group values,
    per-sum group sums, group row counts).  Integer sums are exact."""
    keys = [np.asarray(k) for k in keys]
    n = len(keys[0])
    if n == 0:
        return [k[:0] for k in keys], [np.asarray(s)[:0] for s in sums], \
            np.zeros(0, np.int64)
    codes = [_codes(k) for k in keys]
    order = np.lexsort(codes[::-1])
    change = np.zeros(n, bool)
    change[0] = True
    for cd in codes:
        sc = cd[order]
        change[1:] |= sc[1:] != sc[:-1]
    starts = np.flatnonzero(change)
    gkeys = [k[order][starts] for k in keys]
    gsums = [np.add.reduceat(np.asarray(s)[order], starts) for s in sums]
    counts = np.diff(np.r_[starts, n])
    return gkeys, gsums, counts


def _cents_f64(cents) -> np.ndarray:
    """A decimal(p,2) lane as DOUBLE (correctly rounded, as the port)."""
    return np.asarray(cents, np.int64) / np.float64(100.0)


def _lists(**cols):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else list(v))
            for k, v in cols.items()}


# ---------------------------------------------------------------------------
# The queries (each -> (columns, sort keys, limit, DOUBLE columns))
# ---------------------------------------------------------------------------

def _date_mask(T, moy=None, year=None):
    """date_dim-level mask of d_moy == moy and d_year == year."""
    m = np.ones(T.t["date_dim"].num_rows, bool)
    if moy is not None:
        m &= T.v("date_dim", "d_moy") == moy
    if year is not None:
        m &= T.v("date_dim", "d_year") == year
    return m


def _item_between(T, name, lo, hi):
    v = T.v("item", name)
    return (v >= lo) & (v <= hi)


def _star(T, date_ok, item_ok, fact="store_sales", p="ss"):
    """Rows of a fact whose date and item pass their masks -> (rows,
    date keys, item keys) of those rows."""
    date = T.v(fact, f"{p}_sold_date_sk")
    item = T.v(fact, f"{p}_item_sk")
    rows = np.flatnonzero(T.date(date_ok, date) & item_ok[item - 1])
    return rows, date[rows], item[rows]


def _brands(T, moy, year, name, lo, hi, with_year=True):
    rows, date, item = _star(T, _date_mask(T, moy, year),
                             _item_between(T, name, lo, hi))
    keys = ([T.dd("d_year", date)] if with_year else []) + [
        T.v("item", "i_brand_id")[item - 1],
        T.v("item", "i_brand")[item - 1]]
    gk, (s,), _n = group(keys, [T.v("store_sales",
                                    "ss_ext_sales_price")[rows]])
    gk[-1] = T.decode("item", "i_brand", gk[-1])
    return gk, s


def q3(T):
    (y, bid, b), s = _brands(T, 11, None, "i_manufact_id", 120, 140)
    return (_lists(d_year=y, i_brand_id=bid, i_brand=b, sum_agg=s),
            [("d_year", True, True), ("sum_agg", False, False),
             ("i_brand_id", True, True)], 100, ())


def q52(T):
    (y, bid, b), s = _brands(T, 11, 2000, "i_manager_id", 1, 10)
    return (_lists(d_year=y, i_brand_id=bid, i_brand=b, ext_price=s),
            [("d_year", True, True), ("ext_price", False, False),
             ("i_brand_id", True, True)], 100, ())


def q55(T):
    (bid, b), s = _brands(T, 11, 1999, "i_manager_id", 20, 40,
                          with_year=False)
    return (_lists(i_brand_id=bid, i_brand=b, ext_price=s),
            [("ext_price", False, False), ("i_brand_id", True, True)], 100,
            ())


def q42(T):
    rows, date, item = _star(T, _date_mask(T, 11, 2000),
                             _item_between(T, "i_manager_id", 1, 10))
    (y, cid, cat), (s,), _n = group(
        [T.dd("d_year", date), T.v("item", "i_category_id")[item - 1],
         T.v("item", "i_category")[item - 1]],
        [T.v("store_sales", "ss_ext_sales_price")[rows]])
    return (_lists(d_year=y, i_category_id=cid,
                   i_category=T.decode("item", "i_category", cat),
                   total_sales=s),
            [("total_sales", False, False), ("d_year", True, True),
             ("i_category_id", True, True), ("i_category", True, True)],
            100, ())


def _cd_mask(T):
    """customer_demographics-level mask: M / S / College."""
    cd = "customer_demographics"
    return (T.s(cd, "cd_gender") == "M") & \
        (T.s(cd, "cd_marital_status") == "S") & \
        (T.s(cd, "cd_education_status") == "College")


def _fk_in(T, fact, name, dim_ok):
    """Per fact row: the nullable key `name` is valid and its dimension
    row passes `dim_ok` (an inner join against a filtered dimension)."""
    k, ok = T.fk(fact, name)
    return ok & dim_ok[k - 1]


def _demographic_avgs(T, fact, p, cdemo, promo):
    promo_ok = (T.s("promotion", "p_channel_email") == "N") | \
        (T.s("promotion", "p_channel_event") == "N")
    date = T.v(fact, f"{p}_sold_date_sk")
    rows = np.flatnonzero(
        _fk_in(T, fact, cdemo, _cd_mask(T)) &
        T.date(_date_mask(T, year=2000), date) &
        _fk_in(T, fact, promo, promo_ok))
    item = T.v(fact, f"{p}_item_sk")[rows]
    vals = [T.v(fact, f"{p}_quantity")[rows].astype(np.float64),
            _cents_f64(T.v(fact, f"{p}_list_price")[rows]),
            _cents_f64(T.v(fact, f"{p}_coupon_amt")[rows]),
            _cents_f64(T.v(fact, f"{p}_sales_price")[rows])]
    (iid,), sums, n = group([T.v("item", "i_item_id")[item - 1]], vals)
    aggs = {f"agg{i + 1}": s / n for i, s in enumerate(sums)}
    return (_lists(i_item_id=T.decode("item", "i_item_id", iid), **aggs),
            [("i_item_id", True, True)], 100, tuple(aggs))


def q7(T):
    return _demographic_avgs(T, "store_sales", "ss", "ss_cdemo_sk",
                             "ss_promo_sk")


def q26(T):
    return _demographic_avgs(T, "catalog_sales", "cs", "cs_bill_cdemo_sk",
                             "cs_promo_sk")


_RATIO_SORT = [("i_category", True, True), ("i_class", True, True),
               ("i_item_id", True, True), ("i_item_desc", True, True),
               ("revenueratio", True, True)]


def _revenue_ratio(T, fact, p):
    d_lo = _days(pydt.date(1999, 2, 22))
    d = T.v("date_dim", "d_date")
    date_ok = (d >= d_lo) & (d <= d_lo + 30)
    item_ok = np.isin(T.s("item", "i_category"), ["Sports", "Books",
                                                  "Home"])
    rows, _date, item = _star(T, date_ok, item_ok, fact, p)
    (isk,), (rev,), _n = group([item],
                               [T.v(fact, f"{p}_ext_sales_price")[rows]])
    cls = T.s("item", "i_class")[isk - 1]
    rev_d = _cents_f64(rev)
    (ucls,), (tot,), _n = group([cls], [rev_d])
    class_rev = tot[np.searchsorted(ucls, cls)]
    return (_lists(i_item_id=T.s("item", "i_item_id")[isk - 1],
                   i_item_desc=T.s("item", "i_item_desc")[isk - 1],
                   i_category=T.s("item", "i_category")[isk - 1],
                   i_class=cls,
                   i_current_price=T.v("item", "i_current_price")[isk - 1],
                   itemrevenue=rev,
                   revenueratio=rev_d * np.float64(100.0) / class_rev),
            _RATIO_SORT, 100, ("revenueratio",))


def q12(T):
    return _revenue_ratio(T, "web_sales", "ws")


def q20(T):
    return _revenue_ratio(T, "catalog_sales", "cs")


def q98(T):
    return _revenue_ratio(T, "store_sales", "ss")


def _zips(T, table, name):
    """A zip column as integers, per dimension row."""
    c = T.c(table, name)
    return c.dictionary.astype(np.int64)[c.data]


def q19(T):
    ss = "store_sales"
    rows, date, item = _star(T, _date_mask(T, 11, 1998),
                             _item_between(T, "i_manager_id", 1, 20))
    cust, c_ok = T.fk(ss, "ss_customer_sk", rows)
    store, s_ok = T.fk(ss, "ss_store_sk", rows)
    addr = T.v("customer", "c_current_addr_sk")[cust - 1]
    ca_zip = _zips(T, "customer_address", "ca_zip")[addr - 1]
    s_zip = _zips(T, "store", "s_zip")[store - 1]
    keep = c_ok & s_ok & (ca_zip != s_zip)
    rows, item = rows[keep], item[keep]
    (bid, b, mid, m), (s,), _n = group(
        [T.v("item", "i_brand_id")[item - 1], T.v("item", "i_brand")[item - 1],
         T.v("item", "i_manufact_id")[item - 1],
         T.v("item", "i_manufact")[item - 1]],
        [T.v(ss, "ss_ext_sales_price")[rows]])
    return (_lists(i_brand_id=bid, i_brand=T.decode("item", "i_brand", b),
                   i_manufact_id=mid,
                   i_manufact=T.decode("item", "i_manufact", m),
                   ext_price=s),
            [("ext_price", False, False), ("i_brand", True, True),
             ("i_brand_id", True, True), ("i_manufact_id", True, True),
             ("i_manufact", True, True)], 100, ())


def _rollup2(k1, k2, sums, dec1, dec2):
    """ROLLUP(k1, k2) over pre-filtered rows, keys as codes that `dec1`
    and `dec2` turn into strings: [(k1, k2, gid, sums..., count)],
    levels (k1, k2) gid 0, (k1) gid 1 and () gid 3."""
    out = []
    (a, b), s2, n2 = group([k1, k2], sums)
    out += [(x, y, 0, *[s[i] for s in s2], n2[i]) for i, (x, y) in
            enumerate(zip(dec1(a).tolist(), dec2(b).tolist()))]
    (a,), s1, n1 = group([k1], sums)
    out += [(x, None, 1, *[s[i] for s in s1], n1[i])
            for i, x in enumerate(dec1(a).tolist())]
    if len(k1):
        out.append((None, None, 3, *[np.asarray(s).sum() for s in sums],
                    len(k1)))
    return out


def _decoders(T, *columns):
    """Code -> string functions of (table, column) string columns."""
    return [lambda codes, c=c: T.decode(*c, codes) for c in columns]


def _store_in(T, states):
    return np.isin(T.s("store", "s_state"), states)


def q27(T):
    ss = "store_sales"
    date = T.v(ss, "ss_sold_date_sk")
    store_ok = _store_in(T, ["TN", "SC", "AL", "GA", "SD", "MI"])
    rows = np.flatnonzero(
        _fk_in(T, ss, "ss_cdemo_sk", _cd_mask(T)) &
        T.date(_date_mask(T, year=2000), date) &
        _fk_in(T, ss, "ss_store_sk", store_ok))
    item = T.v(ss, "ss_item_sk")[rows]
    store = T.v(ss, "ss_store_sk")[rows]
    vals = [T.v(ss, "ss_quantity")[rows].astype(np.float64),
            _cents_f64(T.v(ss, "ss_list_price")[rows]),
            _cents_f64(T.v(ss, "ss_coupon_amt")[rows]),
            _cents_f64(T.v(ss, "ss_sales_price")[rows])]
    out = _rollup2(T.v("item", "i_item_id")[item - 1],
                   T.v("store", "s_state")[store - 1], vals,
                   *_decoders(T, ("item", "i_item_id"),
                              ("store", "s_state")))
    cols = {"i_item_id": [r[0] for r in out], "s_state": [r[1] for r in out],
            "g_state": [1 if r[2] & 1 else 0 for r in out]}
    for i in range(4):
        cols[f"agg{i + 1}"] = [float(r[3 + i] / r[7]) for r in out]
    return (cols, [("i_item_id", True, True), ("s_state", True, True)], 100,
            ("agg1", "agg2", "agg3", "agg4"))


def _ranks(values, parts, desc: bool):
    """Spark rank() per partition, ordered by `values` (asc or desc)."""
    out = [0] * len(values)
    by = {}
    for i, p in enumerate(parts):
        by.setdefault(p, []).append(i)
    for idx in by.values():
        vs = sorted(idx, key=lambda i: values[i], reverse=desc)
        rank = 0
        for pos, i in enumerate(vs):
            if pos == 0 or values[i] != values[vs[pos - 1]]:
                rank = pos + 1
            out[i] = rank
    return out


def _hierarchy(out, value_of, desc: bool, key1: str, key2: str, extra):
    """The rollup-and-rank tail of q36, q70 and q86: lochierarchy,
    parent, rank within (lochierarchy, parent) and the sort key."""
    loch = [(r[2] >> 1 & 1) + (r[2] & 1) for r in out]
    parent = [r[0] if not r[2] & 1 else None for r in out]
    vals = [value_of(r) for r in out]
    ranks = _ranks(vals, list(zip(loch, parent)), desc)
    sort_key = [r[0] if lo == 0 else None for r, lo in zip(out, loch)]
    cols = {**extra(out, vals), key1: [r[0] for r in out],
            key2: [r[1] for r in out], "lochierarchy": loch,
            "rank_within_parent": ranks}
    return cols, sort_key


def q36(T):
    ss = "store_sales"
    date = T.v(ss, "ss_sold_date_sk")
    rows = np.flatnonzero(
        T.date(_date_mask(T, year=2001), date) &
        _fk_in(T, ss, "ss_store_sk", _store_in(
            T, ["TN", "SC", "AL", "GA", "SD", "MI", "OH", "TX"])))
    item = T.v(ss, "ss_item_sk")[rows]
    out = _rollup2(T.v("item", "i_category")[item - 1],
                   T.v("item", "i_class")[item - 1],
                   [T.v(ss, "ss_net_profit")[rows],
                    T.v(ss, "ss_ext_sales_price")[rows]],
                   *_decoders(T, ("item", "i_category"),
                              ("item", "i_class")))
    cols, sort_key = _hierarchy(
        out, lambda r: float(_cents_f64(r[3]) / _cents_f64(r[4])), False,
        "i_category", "i_class", lambda o, vals: {"gross_margin": vals})
    cols["sort_cat"] = sort_key
    order = ["gross_margin", "i_category", "i_class", "lochierarchy",
             "rank_within_parent", "sort_cat"]
    return ({k: cols[k] for k in order},
            [("lochierarchy", False, False), ("sort_cat", True, True),
             ("rank_within_parent", True, True), ("i_category", True, True),
             ("i_class", True, True)], 100, ("gross_margin",))


def _month_seq(T, lo, hi):
    seq = T.v("date_dim", "d_month_seq")
    return (seq >= lo) & (seq <= hi)


def q86(T):
    ws = "web_sales"
    rows, _date, item = _star(T, _month_seq(T, 1200, 1211),
                              np.ones(T.t["item"].num_rows, bool), ws, "ws")
    out = _rollup2(T.v("item", "i_category")[item - 1],
                   T.v("item", "i_class")[item - 1],
                   [T.v(ws, "ws_net_paid")[rows]],
                   *_decoders(T, ("item", "i_category"),
                              ("item", "i_class")))
    cols, sort_key = _hierarchy(
        out, lambda r: float(_cents_f64(r[3])), True, "i_category",
        "i_class", lambda o, vals: {"total_sum": [int(r[3]) for r in o]})
    cols["sort_cat"] = sort_key
    order = ["total_sum", "i_category", "i_class", "lochierarchy",
             "rank_within_parent", "sort_cat"]
    return ({k: cols[k] for k in order},
            [("lochierarchy", False, False), ("sort_cat", True, True),
             ("rank_within_parent", True, True), ("i_category", True, True),
             ("i_class", True, True)], 100, ())


def q70(T):
    ss = "store_sales"
    date = T.v(ss, "ss_sold_date_sk")
    store, s_ok = T.fk(ss, "ss_store_sk")
    base = np.flatnonzero(T.date(_month_seq(T, 1200, 1211), date) & s_ok)
    store = store[base]
    profit = T.v(ss, "ss_net_profit")[base]
    state = T.v("store", "s_state")[store - 1]
    (st,), (sp,), _n = group([state], [profit])
    sp_d = _cents_f64(sp).tolist()
    ranks = _ranks(sp_d, [0] * len(sp_d), True)
    top = [s for s, r in zip(st.tolist(), ranks) if r <= 5]
    keep = np.isin(state, top)
    out = _rollup2(state[keep], T.v("store", "s_county")[store[keep] - 1],
                   [profit[keep]],
                   *_decoders(T, ("store", "s_state"),
                              ("store", "s_county")))
    cols, sort_key = _hierarchy(
        out, lambda r: float(_cents_f64(r[3])), True, "s_state",
        "s_county", lambda o, vals: {"total_sum": [int(r[3]) for r in o]})
    cols["sort_state"] = sort_key
    order = ["total_sum", "s_state", "s_county", "lochierarchy",
             "rank_within_parent", "sort_state"]
    return ({k: cols[k] for k in order},
            [("lochierarchy", False, False), ("sort_state", True, True),
             ("rank_within_parent", True, True), ("s_state", True, True),
             ("s_county", True, True)], 100, ())


_CHANNELS = [("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_item_sk",
              "ss_ext_sales_price"),
             ("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
              "ws_item_sk", "ws_ext_sales_price"),
             ("catalog_sales", "cs_sold_date_sk", "cs_bill_addr_sk",
              "cs_item_sk", "cs_ext_sales_price")]


def _channel_union(T, item_key, item_sel, decode, group_name, year, moy):
    """q33/q56/q60: per channel the rows of one month whose address is
    at GMT -5 and whose item's group value (`item_key`, per item row)
    is among the selected items' (`item_sel`), DOUBLE sums per group
    value, then summed over the channels."""
    item_ok = np.isin(item_key, np.unique(item_key[item_sel]))
    gmt_ok = T.v("customer_address", "ca_gmt_offset") == -500
    date_ok = _date_mask(T, moy, year)
    keys, sums = [], []
    for fact, date_fk, addr_fk, item_fk, price in _CHANNELS:
        item = T.v(fact, item_fk)
        rows = np.flatnonzero(T.date(date_ok, T.v(fact, date_fk)) &
                              _fk_in(T, fact, addr_fk, gmt_ok) &
                              item_ok[item - 1])
        (k,), (s,), _n = group([item_key[item[rows] - 1]],
                               [_cents_f64(T.v(fact, price)[rows])])
        keys.append(k)
        sums.append(s)
    (k,), (s,), _n = group([np.concatenate(keys)], [np.concatenate(sums)])
    return ({group_name: decode(k).tolist(), "total_sales": s.tolist()},
            [("total_sales", True, True), (group_name, True, True)], 100,
            ("total_sales",))


def q33(T):
    return _channel_union(T, T.v("item", "i_manufact_id"),
                          T.s("item", "i_category") == "Electronics",
                          lambda k: k, "i_manufact_id", 1998, 5)


def _item_ids(T, sel, year, moy):
    return _channel_union(
        T, T.v("item", "i_item_id").astype(np.int64), sel,
        lambda k: T.decode("item", "i_item_id", k), "i_item_id", year, moy)


def q56(T):
    return _item_ids(T, np.isin(T.s("item", "i_color"),
                                ["slate", "blanched", "burnished"]),
                     2001, 2)


def q60(T):
    return _item_ids(T, T.s("item", "i_category") == "Music", 1998, 9)


def q43(T):
    ss = "store_sales"
    date = T.v(ss, "ss_sold_date_sk")
    store_ok = T.v("store", "s_gmt_offset") == -500
    rows = np.flatnonzero(T.date(_date_mask(T, year=2000), date) &
                          _fk_in(T, ss, "ss_store_sk", store_ok))
    day = T.dd("d_day_name", date[rows])
    names = T.c("date_dim", "d_day_name").dictionary
    store = T.v(ss, "ss_store_sk")[rows]
    price = T.v(ss, "ss_sales_price")[rows]
    days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday"]
    codes = [int(np.searchsorted(names, d)) for d in days]
    (name, sid), sums, _n = group(
        [T.v("store", "s_store_name")[store - 1],
         T.v("store", "s_store_id")[store - 1]],
        [np.where(day == c, price, 0) for c in codes])
    cols = {"s_store_name": T.decode("store", "s_store_name", name).tolist(),
            "s_store_id": T.decode("store", "s_store_id", sid).tolist()}
    for d, s in zip(days, sums):
        cols[f"{d[:3].lower()}_sales"] = s.tolist()
    return cols, [("s_store_name", True, True), ("s_store_id", True, True)], \
        100, ()


def q65(T):
    ss = "store_sales"
    rows = np.flatnonzero(T.date(_month_seq(T, 1176, 1187),
                                 T.v(ss, "ss_sold_date_sk")))
    # a null store is its own group (0 here), which no store joins
    store = np.where(T.ok(ss, "ss_store_sk"), T.v(ss, "ss_store_sk"),
                     0)[rows]
    (st, it), (rev,), _n = group([store, T.v(ss, "ss_item_sk")[rows]],
                                 [T.v(ss, "ss_sales_price")[rows]])
    rev_d = _cents_f64(rev)
    (ust,), (tot,), cnt = group([st], [rev_d])
    ave = (tot / cnt)[np.searchsorted(ust, st)]
    keep = (st > 0) & (rev_d <= np.float64(0.1) * ave)
    st, it, rev_d = st[keep], it[keep], rev_d[keep]
    return (_lists(s_store_name=T.s("store", "s_store_name")[st - 1],
                   i_item_desc=T.s("item", "i_item_desc")[it - 1],
                   revenue=rev_d,
                   i_current_price=T.v("item", "i_current_price")[it - 1],
                   i_wholesale_cost=T.v("item", "i_wholesale_cost")[it - 1],
                   i_brand=T.s("item", "i_brand")[it - 1]),
            [("s_store_name", True, True), ("i_item_desc", True, True),
             ("revenue", True, True)], 100, ("revenue",))


def q73(T):
    hd = "household_demographics"
    veh = T.v(hd, "hd_vehicle_count")
    dep = T.v(hd, "hd_dep_count")
    hd_ok = np.isin(T.s(hd, "hd_buy_potential"), [">10000", "unknown"]) & \
        (veh > 0) & (dep.astype(np.float64) / np.where(veh > 0, veh, 1) >
                     1.0)
    dom = T.v("date_dim", "d_dom")
    date_ok = (dom >= 1) & (dom <= 2) & np.isin(
        T.v("date_dim", "d_year"), [1999, 2000, 2001])
    ss = "store_sales"
    rows = np.flatnonzero(T.date(date_ok, T.v(ss, "ss_sold_date_sk")) &
                          T.ok(ss, "ss_store_sk") &
                          _fk_in(T, ss, "ss_hdemo_sk", hd_ok))
    # a null customer is its own group (0 here), which no customer joins
    cust = np.where(T.ok(ss, "ss_customer_sk"), T.v(ss, "ss_customer_sk"),
                    0)[rows]
    (tk, cu), _s, cnt = group([T.v(ss, "ss_ticket_number")[rows], cust])
    keep = (cnt >= 1) & (cnt <= 5) & (cu > 0)
    tk, cu, cnt = tk[keep], cu[keep], cnt[keep]
    c = "customer"
    return (_lists(c_last_name=T.s(c, "c_last_name")[cu - 1],
                   c_first_name=T.s(c, "c_first_name")[cu - 1],
                   c_salutation=T.s(c, "c_salutation")[cu - 1],
                   c_preferred_cust_flag=T.s(
                       c, "c_preferred_cust_flag")[cu - 1],
                   ss_ticket_number=tk, cnt=cnt),
            [("cnt", False, False), ("c_last_name", True, True),
             ("ss_ticket_number", True, True)], None, ())


def q76(T):
    channels = [("store", "ss_store_sk", "store_sales", "ss_sold_date_sk",
                 "ss_item_sk", "ss_ext_sales_price"),
                ("web", "ws_ship_customer_sk", "web_sales",
                 "ws_sold_date_sk", "ws_item_sk", "ws_ext_sales_price"),
                ("catalog", "cs_ship_addr_sk", "catalog_sales",
                 "cs_sold_date_sk", "cs_item_sk", "cs_ext_sales_price")]
    keys = [[], [], [], [], []]
    vals = []
    for chan, null_col, fact, date_fk, item_fk, price in channels:
        rows = np.flatnonzero(~T.ok(fact, null_col))
        date = T.v(fact, date_fk)[rows]
        item = T.v(fact, item_fk)[rows]
        keys[0].append(np.full(len(rows), chan))
        keys[1].append(np.full(len(rows), null_col))
        keys[2].append(T.dd("d_year", date))
        keys[3].append(T.dd("d_qoy", date))
        keys[4].append(T.s("item", "i_category")[item - 1])
        vals.append(_cents_f64(T.v(fact, price)[rows]))
    (ch, cn, y, q, cat), (s,), cnt = group(
        [np.concatenate(k) for k in keys], [np.concatenate(vals)])
    return (_lists(channel=ch, col_name=cn, d_year=y, d_qoy=q,
                   i_category=cat, sales_cnt=cnt, sales_amt=s),
            [("channel", True, True), ("col_name", True, True),
             ("d_year", True, True), ("d_qoy", True, True),
             ("i_category", True, True)], 100, ("sales_amt",))


def q93(T):
    sr, ss = "store_returns", "store_sales"
    sr_rows = np.flatnonzero(_fk_in(
        T, sr, "sr_reason_sk", T.s("reason", "r_reason_desc") == "reason 28"))
    span = int(T.v(ss, "ss_ticket_number").max()) + 1
    ss_key = T.v(ss, "ss_item_sk") * span + T.v(ss, "ss_ticket_number")
    sr_key = (T.v(sr, "sr_item_sk") * span +
              T.v(sr, "sr_ticket_number"))[sr_rows]
    order = np.argsort(ss_key, kind="stable")
    sk = ss_key[order]
    lo = np.searchsorted(sk, sr_key, "left")
    cnt = np.searchsorted(sk, sr_key, "right") - lo
    sr_pair = np.repeat(sr_rows, cnt)
    off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ss_pair = order[np.repeat(lo, cnt) + off]
    qty = T.v(ss, "ss_quantity")[ss_pair].astype(np.int64)
    rq = T.v(sr, "sr_return_quantity")[sr_pair].astype(np.int64)
    rq_ok = T.ok(sr, "sr_return_quantity")[sr_pair]
    price = _cents_f64(T.v(ss, "ss_sales_price")[ss_pair])
    diff = (qty - rq).astype(np.int32).astype(np.float64)
    act = np.where(rq_ok, diff * price, qty.astype(np.float64) * price)
    cust = np.where(T.ok(ss, "ss_customer_sk")[ss_pair],
                    T.v(ss, "ss_customer_sk")[ss_pair], 0)
    (cu,), (s,), _n = group([cust], [act])
    return ({"ss_customer_sk": [int(c) if c > 0 else None
                                for c in cu.tolist()],
             "sumsales": s.tolist()},
            [("sumsales", True, True), ("ss_customer_sk", True, True)], 100,
            ("sumsales",))


def q96(T):
    ss = "store_sales"
    td_ok = (T.v("time_dim", "t_hour") == 20) & \
        (T.v("time_dim", "t_minute") >= 30)
    t, t_ok = T.fk(ss, "ss_sold_time_sk")
    keep = (t_ok & td_ok[t] &
            _fk_in(T, ss, "ss_hdemo_sk", T.v("household_demographics",
                                             "hd_dep_count") == 7) &
            _fk_in(T, ss, "ss_store_sk", T.s("store", "s_store_name") ==
                   "ese"))
    return {"cnt": [int(keep.sum())]}, [], None, ()


QUERIES = ("q3", "q7", "q12", "q19", "q20", "q26", "q27", "q33", "q36",
           "q42", "q43", "q52", "q55", "q56", "q60", "q65", "q70", "q73",
           "q76", "q86", "q93", "q96", "q98")


def expected(name: str, tables):
    """(columns, sort keys, limit, DOUBLE columns) of one query's full
    result (before its LIMIT)."""
    return globals()[name](Tables(tables))


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------

def _sort_value(x):
    if isinstance(x, float):
        return (1 if math.isnan(x) else 0, 0.0 if math.isnan(x) else x)
    return x


def sort_rows(rows, names, keys):
    """Rows in the order of `keys` ((name, asc, nulls_first) most
    significant first): stable passes, least significant first."""
    rows = list(rows)
    for name, asc, nf in reversed(keys):
        i = names.index(name)
        if asc:
            rows.sort(key=lambda r: (0 if nf else 2, 0) if r[i] is None
                      else (1, _sort_value(r[i])))
        else:
            rows.sort(key=lambda r: (2 if nf else 0, 0) if r[i] is None
                      else (1, _sort_value(r[i])), reverse=True)
    return rows


def _close(a, b, double: bool) -> bool:
    if a is None or b is None:
        return a is b
    if double:
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0) or \
            (math.isnan(a) and math.isnan(b))
    return a == b


def _row_close(r, w, dbl) -> bool:
    return all(_close(a, b, d) for a, b, d in zip(r, w, dbl))


def compare(name: str, got: dict, want) -> str:
    """'' when `got` (column -> values) is the query's result, else what
    differs."""
    cols, keys, limit, doubles = want
    names = list(cols)
    if list(got) != names:
        return f"columns {list(got)}, not {names}"
    dbl = [n in doubles for n in names]
    wrows = sort_rows(zip(*cols.values()), names, keys)
    grows = list(zip(*(got[n] for n in names)))
    n_want = len(wrows) if limit is None else min(limit, len(wrows))
    if len(grows) != n_want:
        return f"{len(grows)} rows, numpy {n_want}"
    kidx = [names.index(k) for k, _a, _nf in keys]

    def kt(r):
        return tuple(r[i] for i in kidx)

    pos = 0
    while pos < len(grows):
        # one run of rows with equal sort keys in the engine's output
        end = pos + 1
        while end < len(grows) and kt(grows[end]) == kt(grows[pos]):
            end += 1
        if not all(_close(a, b, dbl[i]) for a, b, i in zip(
                kt(grows[pos]), kt(wrows[pos]), kidx)):
            return (f"row {pos}: sort keys {kt(grows[pos])}, numpy "
                    f"{kt(wrows[pos])}")
        # the numpy rows tied with it (the whole run, past any LIMIT)
        wkey = kt(wrows[pos])
        lo = pos
        while lo > 0 and kt(wrows[lo - 1]) == wkey:
            lo -= 1
        hi = pos
        while hi < len(wrows) and kt(wrows[hi]) == wkey:
            hi += 1
        pool = wrows[lo:hi]
        for r in grows[pos:end]:
            hit = next((j for j, w in enumerate(pool)
                        if _row_close(r, w, dbl)), None)
            if hit is None:
                return f"row {pos}..{end}: {r} is not among numpy's " \
                    f"{pool[:4]}"
            pool.pop(hit)
        pos = end
    return ""


def result_columns(hb) -> dict:
    """Column -> values (None for nulls; strings decoded, decimals as
    unscaled ints)."""
    out = {}
    for name, c in zip(hb.names, hb.columns):
        if c.dictionary is not None:
            vals = [str(v) for v in c.dictionary[c.data]] \
                if len(c.dictionary) else [None] * len(c.data)
        else:
            vals = c.data.tolist()
        if c.validity is not None:
            vals = [v if ok else None
                    for v, ok in zip(vals, c.validity.tolist())]
        out[name] = vals
    return out


# ---------------------------------------------------------------------------
# The window phase: one WindowExec over all of store_sales
# ---------------------------------------------------------------------------

#: (output name, spec constructor over the port's plan.window module W,
#: whose arguments come from the frame constructor F) — every function
#: of plan/window.py, partitioned by item and ordered by sale date
#: (TPC-DS q47's and q51's running and moving sums per item by date)
WINDOW_SPECS = (
    ("row_number", lambda W, F, c: W.RowNumber()),
    ("rank", lambda W, F, c: W.Rank()),
    ("dense_rank", lambda W, F, c: W.DenseRank()),
    ("percent_rank", lambda W, F, c: W.PercentRank()),
    ("cume_dist", lambda W, F, c: W.CumeDist()),
    ("ntile4", lambda W, F, c: W.NTile(4)),
    ("lead_qty", lambda W, F, c: W.Lead(c("ss_quantity"), 1, -1)),
    ("lag_qty", lambda W, F, c: W.Lag(c("ss_quantity"), 2, -2)),
    ("first_paid", lambda W, F, c: W.FirstValue(c("ss_net_paid"))),
    ("last_paid", lambda W, F, c: W.LastValue(c("ss_net_paid"))),
    ("count", lambda W, F, c: W.WinCount(None)),
    ("avg_paid", lambda W, F, c: W.WinAverage(
        c("ss_net_paid"), F("range", None, None))),
    ("sum_running", lambda W, F, c: W.WinSum(
        c("ss_net_paid"), F("rows", None, 0))),
    ("sum_rows3", lambda W, F, c: W.WinSum(
        c("ss_net_paid"), F("rows", -3, 3))),
    ("sum_30d", lambda W, F, c: W.WinSum(
        c("ss_net_paid"), F("range", -30, 0))),
    ("min_rows3", lambda W, F, c: W.WinMin(
        c("ss_net_paid"), F("rows", -3, 3))),
    ("max_rows3", lambda W, F, c: W.WinMax(
        c("ss_net_paid"), F("rows", -3, 3))),
    ("min_30d", lambda W, F, c: W.WinMin(
        c("ss_net_paid"), F("range", -30, 0))),
    ("max_30d", lambda W, F, c: W.WinMax(
        c("ss_net_paid"), F("range", -30, 0))),
)
WINDOW_COLUMNS = ("ss_item_sk", "ss_sold_date_sk", "ss_quantity",
                  "ss_net_paid")


def window_frame(session, store_sales):
    """The window phase's DataFrame over `store_sales` (its four columns)."""
    from spark_rapids_tpu_torch.plan import window as W
    from spark_rapids_tpu_torch.session import col
    df = session.from_host(store_sales.select(list(WINDOW_COLUMNS)))
    return df.window([(make(W, W.WindowFrame, col), name)
                      for name, make in WINDOW_SPECS],
                     partition_by=["ss_item_sk"],
                     order_by=[("ss_sold_date_sk", True, True)])


def _half_up(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    q = (np.abs(num) + den // 2) // den
    return np.where(num < 0, -q, q)


def _window_lanes(store_sales, rows=None):
    lanes = [store_sales.column_by_name(n).data for n in WINDOW_COLUMNS]
    return lanes if rows is None else [x[rows] for x in lanes]


def expected_window(store_sales, rows=None) -> dict:
    """Every output of `window_frame` in numpy (over `rows` of
    store_sales, all by default): a stable sort by the packed (item,
    date) key, partition and peer runs, per-row arithmetic on their
    bounds, prefix-sum differences, and RANGE bounds by searchsorted on
    that key.  -> output name -> values in the sorted row order (the
    operator's)."""
    item, date, qty, paid = _window_lanes(store_sales, rows)
    span = int(date.max()) + 64
    perm = np.argsort(item * span + date, kind="stable")
    item, date = item[perm], date[perm]
    qty, paid = qty[perm].astype(np.int64), paid[perm].astype(np.int64)
    n = len(item)
    idx = np.arange(n)
    part_b = np.r_[True, item[1:] != item[:-1]]
    peer_b = part_b | np.r_[True, date[1:] != date[:-1]]
    part_id = np.cumsum(part_b) - 1
    peer_id = np.cumsum(peer_b) - 1
    p_starts = np.flatnonzero(part_b)
    p_ends = np.r_[p_starts[1:], n] - 1
    q_starts = np.flatnonzero(peer_b)
    q_ends = np.r_[q_starts[1:], n] - 1
    ps, pe = p_starts[part_id], p_ends[part_id]
    qs, qe = q_starts[peer_id], q_ends[peer_id]
    rows = pe - ps + 1
    rn0 = idx - ps
    out = {"row_number": rn0 + 1, "rank": qs - ps + 1,
           "dense_rank": peer_id - peer_id[ps] + 1}
    out["percent_rank"] = np.where(
        rows > 1, (qs - ps).astype(np.float64) /
        np.maximum(rows - 1, 1).astype(np.float64), 0.0)
    out["cume_dist"] = (qe - ps + 1).astype(np.float64) / \
        rows.astype(np.float64)
    k, rem = rows // 4, rows % 4
    cut = rem * (k + 1)
    bucket = np.where(rn0 < cut, rn0 // np.maximum(k + 1, 1),
                      rem + (rn0 - cut) // np.maximum(k, 1))
    out["ntile4"] = np.where(rows < 4, rn0, bucket) + 1
    out["lead_qty"] = np.where(idx + 1 <= pe,
                               qty[np.minimum(idx + 1, n - 1)], -1)
    out["lag_qty"] = np.where(idx - 2 >= ps, qty[np.maximum(idx - 2, 0)],
                              -2)
    out["first_paid"] = paid[ps]
    out["last_paid"] = paid[qe]
    out["count"] = qe - ps + 1
    cs = np.cumsum(paid)

    def span_sum(lo, hi):
        return cs[hi] - np.where(lo > 0, cs[np.maximum(lo - 1, 0)], 0)
    out["avg_paid"] = _half_up(span_sum(ps, pe) * 10 ** 4, rows)
    out["sum_running"] = span_sum(ps, idx)
    lo3, hi3 = np.maximum(ps, idx - 3), np.minimum(pe, idx + 3)
    out["sum_rows3"] = span_sum(lo3, hi3)
    key = item * span + date
    lo30 = np.searchsorted(key, key - 30, "left")
    out["sum_30d"] = span_sum(lo30, qe)
    for name, lo, hi in (("rows3", lo3, hi3), ("30d", lo30, qe)):
        mn = paid[lo].copy()
        mx = paid[lo].copy()
        for off in range(1, int((hi - lo).max()) + 1):
            src = np.minimum(lo + off, hi)
            mn = np.minimum(mn, paid[src])
            mx = np.maximum(mx, paid[src])
        out[f"min_{name}"] = mn
        out[f"max_{name}"] = mx
    return out


_M64 = (1 << 64) - 1


def _digest(values: np.ndarray, offset: int = 0):
    """(rows, position-weighted sum, sum) of a lane's 64-bit patterns,
    both mod 2^64, its first row at position `offset` of the whole
    lane: equal lanes give equal digests, a lane that differs in any
    row almost surely does not, and the digests of consecutive pieces
    add up to the whole lane's (`add_digests`)."""
    v = np.asarray(values)
    v = (v.astype(np.float64) if v.dtype.kind == "f" else
         v.astype(np.int64)).view(np.uint64)
    w = (np.arange(len(v), dtype=np.uint64) + np.uint64(offset)) * \
        np.uint64(0x9E3779B97F4A7C15) + np.uint64(0x632BE59BD9B4E019)
    with np.errstate(over="ignore"):
        return len(v), int((v * w).sum(dtype=np.uint64)), \
            int(v.sum(dtype=np.uint64))


def add_digests(parts) -> dict:
    """The whole lane's digests from its pieces' (window_part_digests)."""
    out = {}
    for part in parts:
        for name, (n, ws, s) in part.items():
            n0, ws0, s0 = out.get(name, (0, 0, 0))
            out[name] = (n0 + n, (ws0 + ws) & _M64, (s0 + s) & _M64)
    return out


def window_part_digests(store_sales, part: int, parts: int) -> dict:
    """The digests of every expected output over the items of one of
    `parts` equal item-key ranges: partitions never cross items, and the
    sorted order puts the ranges one after the other, so a forked
    process each computes a piece and hands back digests, not 19 lanes
    of 28.8M rows."""
    item = store_sales.column_by_name("ss_item_sk").data
    top = int(item.max()) + 1
    lo, hi = top * part // parts, top * (part + 1) // parts
    rows = np.flatnonzero((item >= lo) & (item < hi))
    offset = int(np.count_nonzero(item < lo))
    return {name: _digest(v, offset)
            for name, v in expected_window(store_sales, rows).items()}


def window_digests_equal(got_hb, digests: dict) -> list:
    """The outputs whose values or nulls differ from the digests."""
    bad = []
    for name, dg in digests.items():
        c = got_hb.column_by_name(name)
        if (c.validity is not None and not c.validity.all()) or \
                _digest(c.data) != dg:
            bad.append(name)
    return bad


def compare_window(got_hb, want: dict) -> dict:
    """-> {output: max abs difference}; raises AssertionError naming the
    first output that differs (integers and decimals exactly, DOUBLE
    within rtol 1e-12) or holds a null."""
    errs = {}
    for name, exp in want.items():
        c = got_hb.column_by_name(name)
        assert c.validity is None or c.validity.all(), f"{name} has nulls"
        got = c.data
        assert len(got) == len(exp), f"{name}: {len(got)} rows, " \
            f"numpy {len(exp)}"
        if got.dtype.kind == "f":
            ok = np.allclose(got, exp, rtol=RTOL, atol=0.0)
            err = float(np.abs(got - exp).max()) if len(got) else 0.0
        else:
            diff = got.astype(np.int64) - np.asarray(exp, np.int64)
            ok = not diff.any()
            err = float(np.abs(diff).max()) if len(got) else 0.0
        if not ok:
            at = int(np.flatnonzero(~np.isclose(got, exp, rtol=RTOL,
                                                atol=0.0))[0])
            raise AssertionError(f"window {name} differs from numpy from "
                                 f"row {at}: {got[at:at + 5]} against "
                                 f"{np.asarray(exp)[at:at + 5]}")
        errs[name] = err
    return errs
