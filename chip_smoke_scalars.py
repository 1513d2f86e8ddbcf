"""The scalars phase of chip_smoke.py: the queries that drive the dense
group-by tier, the range / sample execs, the scalar expression families
and the statistical aggregates on the card, their independent numpy
results, and the comparisons that hold the port's results to them.

  * moments_q1   — TPC-H lineitem grouped by (l_returnflag,
                   l_linestatus) into the seven statistical aggregates
                   over l_quantity, l_extendedprice, l_discount and l_tax
                   (numpy: two-pass moments about each group's mean);
  * scalars_q1   — one projection of every new scalar family over
                   lineitem (arithmetic on l_orderkey, round / bround of
                   the DECIMAL revenue, floor / ceil, the math functions
                   on the prices cast to DOUBLE, greatest / least of the
                   three dates, width_bucket), grouped by (l_returnflag,
                   l_linestatus) into SUM, MIN and MAX of each (numpy:
                   the same functions over the rows sorted by group,
                   exact int64 sums of the integer and DECIMAL lanes);
  * range_sample — range(0, RANGE_ROWS).sample(0.01, seed=7) grouped by
                   id % 1000 into COUNT and SUM(id), and its count()
                   (numpy: the reference's uint32 murmur3 finalizer over
                   the ids);
  * edge_values  — range(EDGE_LO, EDGE_HI) cast to DOUBLE and divided
                   so that NaN, ±inf, -0.0 and nulls appear, every new
                   expression fetched and compared elementwise;
  * dense_sf10   — TPC-DS store_sales ⋈ item grouped by (i_category,
                   i_class, i_color), 1,683 buckets: the dense tier.

Tolerances: integer, DECIMAL, DATE and boolean results and the exact
DOUBLE families (sqrt, rint, floor / ceil, round / bround, to_degrees /
to_radians, signum, greatest / least, width_bucket, arithmetic) bit for
bit; the transcendental functions (exp, expm1, the logs, cbrt, the
trigonometric and hyperbolic functions, pow, atan2, hypot) within ULPS
units in the last place of numpy's (CUDA's libdevice documents up to 2
ulps for these, glibc under 1); DOUBLE sums and the statistics within
rtol RTOL (the card adds in another order), a covariance or correlation
within RTOL of the mean product its moment form cancels (`close`).

Run by chip_smoke.py; imports numpy only at module level.
"""
from __future__ import annotations

import math

import numpy as np

ULPS = 4
RTOL = 1e-9
U32 = 0xFFFFFFFF
RANGE_ROWS = 25_000_000
SAMPLE_FRACTION = 0.01
SAMPLE_SEED = 7
EDGE_LO, EDGE_HI = -2_500_000, 2_500_000
LONG_MIN = -2 ** 63


def _port():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    return T, E, A, col


# ---------------------------------------------------------------------------
# The queries (port side)
# ---------------------------------------------------------------------------

KEYS = ("l_returnflag", "l_linestatus")
MOMENTS = (("var_pop_qty", "VariancePop", ("l_quantity",)),
           ("var_samp_price", "VarianceSamp", ("l_extendedprice",)),
           ("sd_pop_disc", "StddevPop", ("l_discount",)),
           ("sd_samp_tax", "StddevSamp", ("l_tax",)),
           ("covar_pop_qty_price", "CovarPop",
            ("l_quantity", "l_extendedprice")),
           ("covar_samp_disc_tax", "CovarSamp", ("l_discount", "l_tax")),
           ("corr_price_disc", "Corr", ("l_extendedprice", "l_discount")))


def moments_q1(s, t):
    T, E, A, col = _port()
    aggs = [(getattr(A, fn)(*[col(c) for c in cols]), name)
            for name, fn, cols in MOMENTS]
    return (s.from_host(t["lineitem"]).group_by(*KEYS)
            .agg(*aggs, (A.Count(None), "n")).sort(*KEYS))


#: scalars_q1's projections: name -> (kind, builder).  kind: "int" (an
#: integral or DATE lane), "dec" (a DECIMAL's unscaled lane), "exact" (a
#: DOUBLE bit for bit), "ulp" (a transcendental DOUBLE)
def _scalar_exprs():
    T, E, A, col = _port()
    ok = col("l_orderkey")
    ext, disc, tax, qty = (E.Cast(col(c), T.DOUBLE) for c in (
        "l_extendedprice", "l_discount", "l_tax", "l_quantity"))
    rev = E.Multiply(col("l_extendedprice"),
                     E.Subtract(E.Literal(1), col("l_discount")))
    dates = [col(c) for c in ("l_shipdate", "l_commitdate",
                              "l_receiptdate")]
    out = {
        "div_ok": ("int", E.IntegralDivide(ok, E.Literal(7))),
        "rem_ok": ("int", E.Remainder(ok, E.Literal(1000))),
        "neg_ok": ("int", E.UnaryMinus(ok)),
        "abs_ok": ("int", E.Abs(E.Subtract(ok, E.Literal(30_000_000)))),
        "round_rev": ("dec", E.Round(rev, 2)),
        "bround_rev": ("dec", E.BRound(rev, 1)),
        "round_rev_neg": ("dec", E.Round(rev, -2)),
        "round_ext": ("exact", E.Round(E.Multiply(ext, E.Literal(1.37)),
                                       1)),
        "floor_ext": ("int", E.Floor(E.Multiply(ext, E.Literal(1.37)))),
        "ceil_ext": ("int", E.Ceil(E.Divide(ext, E.Literal(7.0)))),
        "sqrt": ("exact", E.Sqrt(ext)),
        "rint": ("exact", E.Rint(E.Divide(ext, E.Literal(7.0)))),
        "degrees": ("exact", E.ToDegrees(disc)),
        "radians": ("exact", E.ToRadians(disc)),
        "signum": ("exact", E.Signum(E.Subtract(ext, E.Literal(50000.0)))),
        "greatest_date": ("int", E.Greatest(*dates)),
        "least_date": ("int", E.Least(*dates)),
        "width_bucket": ("int", E.WidthBucket(
            ext, E.Literal(900.0), E.Literal(105000.0), E.Literal(20))),
        "pow": ("ulp", E.Pow(disc, tax)),
        "atan2": ("ulp", E.Atan2(disc, tax)),
        "hypot": ("ulp", E.Hypot(ext, qty)),
    }
    for fn in ("Exp", "Expm1", "Log1p", "Asin", "Acos", "Atan", "Sinh",
               "Cosh", "Tanh"):
        out[fn.lower()] = ("ulp", getattr(E, fn)(disc))
    for fn in ("Log", "Log10", "Log2", "Cbrt", "Sin", "Cos", "Tan", "Cot",
               "Sec", "Csc"):
        out[fn.lower()] = ("ulp", getattr(E, fn)(ext))
    return out


def scalars_q1(s, t):
    T, E, A, col = _port()
    exprs = _scalar_exprs()
    proj = s.from_host(t["lineitem"]).select(
        *[col(k) for k in KEYS], *[E.Alias(e, n) for n, (_k, e) in
                                   exprs.items()])
    aggs = []
    for name, (kind, _e) in exprs.items():
        # the DECIMAL(23-25) roundings are read through a one-operand
        # COALESCE (the same values): a DECIMAL wider than 18 digits read
        # straight off a column places its aggregate on the CPU engine
        # (the reference's plan-time rule, for a host column's high
        # word), and this phase holds the card's aggregation; their SUMs
        # run as two half lanes each
        ref = E.Coalesce(col(name)) if kind == "dec" else col(name)
        if not name.endswith("_date"):
            aggs.append((A.Sum(ref), f"sum_{name}"))
        aggs += [(A.Min(ref), f"min_{name}"), (A.Max(ref), f"max_{name}")]
    return proj.group_by(*KEYS).agg(*aggs).sort(*KEYS)


def range_sample(s):
    T, E, A, col = _port()
    return (s.range(0, RANGE_ROWS).sample(SAMPLE_FRACTION, seed=SAMPLE_SEED)
            .group_by(E.Alias(E.Remainder(col("id"), E.Literal(1000)), "m"))
            .agg((A.Count(None), "n"), (A.Sum(col("id")), "s")).sort("m"))


def range_sample_count(s) -> int:
    return s.range(0, RANGE_ROWS).sample(SAMPLE_FRACTION,
                                         seed=SAMPLE_SEED).count()


def _edge_inputs():
    """(x, y, lmin, dec) over range(EDGE_LO, EDGE_HI): x a DOUBLE with
    NaN (id % 11 == 0), ±inf and huge values (id % 13), -0.0 (id % 17),
    nulls (id % 19, and a zero divisor); y a DOUBLE with NaN (id % 29);
    lmin the ids moved down to Long.MIN_VALUE; dec a DECIMAL(?, 2)."""
    from decimal import Decimal
    T, E, A, col = _port()
    i = col("id")

    def rem(k):
        return E.Remainder(i, E.Literal(k))

    def zero(k):
        return E.EqualTo(rem(k), E.Literal(0))
    a = E.Divide(E.Cast(i, T.DOUBLE), E.Literal(1000.0))
    x = E.CaseWhen([(zero(11), E.Sqrt(E.Literal(-1.0))),
                    (zero(13), E.Multiply(a, E.Literal(1e306))),
                    (zero(17), E.UnaryMinus(E.Literal(0.0))),
                    (zero(19), E.Literal(None, T.DOUBLE))],
                   E.Divide(a, E.Cast(E.Subtract(rem(23), E.Literal(11)),
                                      T.DOUBLE)))
    y = E.CaseWhen([(zero(29), E.Literal(float("nan")))],
                   E.Divide(E.Cast(rem(1000), T.DOUBLE), E.Literal(7.0)))
    lmin = E.Add(i, E.Literal(LONG_MIN - EDGE_LO, T.LONG))
    dec = E.Multiply(E.Cast(rem(100000), T.DecimalType(9, 0)),
                     E.Literal(Decimal("0.01")))
    return x, y, lmin, dec, i, rem


def _edge_exprs():
    T, E, A, col = _port()
    x, y, lmin, dec, i, rem = _edge_inputs()
    out = {
        "x": ("exact", x), "y": ("exact", y),
        "div": ("int", E.IntegralDivide(i, E.Subtract(rem(7),
                                                       E.Literal(3)))),
        "rem": ("int", E.Remainder(i, E.Subtract(rem(7), E.Literal(3)))),
        "div_min": ("int", E.IntegralDivide(lmin, E.Literal(-1))),
        "rem_min": ("int", E.Remainder(lmin, E.Literal(-1))),
        "neg_min": ("int", E.UnaryMinus(lmin)),
        "abs_min": ("int", E.Abs(lmin)),
        "rem_double": ("exact", E.Remainder(x, y)),
        "neg": ("exact", E.UnaryMinus(x)), "abs": ("exact", E.Abs(x)),
        "nullsafe_eq": ("bool", E.EqualNullSafe(x, y)),
        "isnan": ("bool", E.IsNaN(x)),
        "floor": ("int", E.Floor(x)), "ceil": ("int", E.Ceil(x)),
        "round2": ("exact", E.Round(x, 2)),
        "bround2": ("exact", E.BRound(x, 2)),
        "round_neg": ("exact", E.Round(x, -1)),
        "round_long": ("int", E.Round(lmin, -2)),
        "round_dec": ("dec", E.Round(dec, 1)),
        "bround_dec": ("dec", E.BRound(dec, 1)),
        "round_dec_neg": ("dec", E.Round(dec, -2)),
        "floor_dec": ("int", E.Floor(dec)), "ceil_dec": ("int", E.Ceil(dec)),
        "sqrt": ("exact", E.Sqrt(x)), "rint": ("exact", E.Rint(x)),
        "degrees": ("exact", E.ToDegrees(x)),
        "radians": ("exact", E.ToRadians(x)),
        "signum": ("exact", E.Signum(x)),
        "greatest": ("exact", E.Greatest(x, y, E.Literal(0.0))),
        "least": ("exact", E.Least(x, y)),
        "width_bucket": ("int", E.WidthBucket(
            x, E.Literal(-100.0), E.Literal(100.0), E.Literal(10))),
        "pow": ("ulp", E.Pow(x, y)), "atan2": ("ulp", E.Atan2(x, y)),
        "hypot": ("ulp", E.Hypot(x, y)),
    }
    for fn in ("Exp", "Expm1", "Log", "Log10", "Log2", "Log1p", "Cbrt",
               "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
               "Tanh", "Cot", "Sec", "Csc"):
        out[fn.lower()] = ("ulp", getattr(E, fn)(x))
    return out


def edge_values(s):
    T, E, A, col = _port()
    return s.range(EDGE_LO, EDGE_HI).select(
        *[E.Alias(e, n) for n, (_k, e) in _edge_exprs().items()])


def raise_error_query(s):
    T, E, A, col = _port()
    return s.range(0, 10).select(E.Alias(E.RaiseError("edge"), "e"))


DENSE_KEYS = ("i_category", "i_class", "i_color")


def dense_sf10(s, t):
    T, E, A, col = _port()
    ss = s.from_host(t["store_sales"])
    item = s.from_host(t["item"])
    price = col("ss_sales_price")
    return (ss.join(item, left_on=["ss_item_sk"], right_on=["i_item_sk"])
            .group_by(*DENSE_KEYS)
            .agg((A.Sum(col("ss_net_paid")), "sum_net_paid"),
                 (A.Count(None), "n"),
                 (A.Average(col("ss_quantity")), "avg_qty"),
                 (A.Min(price), "min_price"), (A.Max(price), "max_price"),
                 (A.StddevSamp(price), "sd_price"))
            .sort(*DENSE_KEYS))


# ---------------------------------------------------------------------------
# numpy results
# ---------------------------------------------------------------------------

def _col(hb, name):
    return hb.column_by_name(name)


def _group_sorted(li):
    """(sorting permutation, group starts, group codes) of lineitem by
    (returnflag, linestatus) codes; the dictionaries are sorted, so code
    order is the engine's key order."""
    rf = _col(li, "l_returnflag").data.astype(np.int64)
    ls = _col(li, "l_linestatus").data.astype(np.int64)
    g = rf * 2 + ls
    perm = np.argsort(g, kind="stable")
    gs = g[perm]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    return perm, starts, gs[starts]


def _money(li, name, perm):
    return _col(li, name).data[perm].astype(np.float64) / 100.0


def expected_moments(li) -> dict:
    perm, starts, codes = _group_sorted(li)
    ends = np.r_[starts[1:], len(perm)]
    vals = {c: _money(li, c, perm) for c in
            ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    out = {"n": (ends - starts).astype(np.int64)}
    for name, fn, cols in MOMENTS:
        res, scale = [], []
        for a, b in zip(starts, ends):
            xs = [vals[c][a:b] for c in cols]
            n = b - a
            d = [v - v.mean() for v in xs]
            if fn.startswith("Variance") or fn.startswith("Stddev"):
                m2 = float(np.dot(d[0], d[0]))
                v = m2 / (n - (1 if fn.endswith("Samp") else 0))
                res.append(math.sqrt(v) if fn.startswith("Stddev") else v)
            elif fn.startswith("Covar"):
                den = n - (1 if fn.endswith("Samp") else 0)
                res.append(float(np.dot(d[0], d[1])) / den)
                scale.append(abs(float(np.dot(xs[0], xs[1]))) / den)
            else:
                sxx = float(np.dot(d[0], d[0]))
                syy = float(np.dot(d[1], d[1]))
                res.append(float(np.dot(d[0], d[1])) / math.sqrt(sxx * syy))
                scale.append(abs(float(np.dot(xs[0], xs[1]))) /
                             math.sqrt(sxx * syy))
        out[name] = np.array(res)
        out[name + ":scale"] = np.array(scale) if scale else None
    out["_codes"] = codes
    return out


def _np_scalar(name, c):
    """scalars_q1's projection `name` in numpy over the columns `c`
    (sorted by group).  -> the lane (int64 unscaled for a DECIMAL)."""
    ok = c["l_orderkey"]
    ext, disc, tax, qty = c["ext"], c["disc"], c["tax"], c["qty"]
    with np.errstate(all="ignore"):
        if name == "div_ok":
            return ok // 7
        if name == "rem_ok":
            return ok % 1000
        if name == "neg_ok":
            return -ok
        if name == "abs_ok":
            return np.abs(ok - 30_000_000)
        if name.startswith("round_rev") or name == "bround_rev":
            rev = c["ext_u"] * (100 - c["disc_u"])         # scale 4
            if name == "round_rev":
                return (rev + 50) // 100                   # HALF_UP, >= 0
            if name == "round_rev_neg":
                return (rev + 500_000) // 1_000_000 * 100  # to hundreds
            q, r = rev // 1000, rev % 1000                 # HALF_EVEN, 1
            return q + ((r > 500) | ((r == 500) & (q % 2 == 1)))
        if name == "round_ext":
            y = ext * 1.37 * 10.0
            return np.trunc(y + 0.5) / 10.0
        if name == "floor_ext":
            return np.floor(ext * 1.37).astype(np.int64)
        if name == "ceil_ext":
            return np.ceil(ext / 7.0).astype(np.int64)
        if name == "rint":
            return np.rint(ext / 7.0)
        if name == "signum":
            return np.sign(ext - 50000.0)
        if name in ("greatest_date", "least_date"):
            d = np.stack([c["ship"], c["commit"], c["receipt"]])
            return (d.max(0) if name == "greatest_date" else d.min(0)) \
                .astype(np.int64)
        if name == "width_bucket":
            frac = (ext - 900.0) / (105000.0 - 900.0)
            mid = (frac * 20.0).astype(np.int64) + 1
            return np.where(ext < 900.0, 0, np.where(ext >= 105000.0, 21,
                                                     mid))
        if name == "pow":
            return np.power(disc, tax)
        if name == "atan2":
            return np.arctan2(disc, tax)
        if name == "hypot":
            return np.hypot(ext, qty)
        if name == "degrees":
            return np.degrees(disc)
        if name == "radians":
            return np.radians(disc)
        one = {"exp": np.exp, "expm1": np.expm1, "log1p": np.log1p,
               "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
               "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh}
        if name in one:
            return one[name](disc)
        two = {"sqrt": np.sqrt, "log": np.log, "log10": np.log10,
               "log2": np.log2, "cbrt": np.cbrt, "sin": np.sin,
               "cos": np.cos, "tan": np.tan,
               "cot": lambda v: 1.0 / np.tan(v),
               "sec": lambda v: 1.0 / np.cos(v),
               "csc": lambda v: 1.0 / np.sin(v)}
        return two[name](ext)


SCALAR_NAMES = ("div_ok", "rem_ok", "neg_ok", "abs_ok", "round_rev",
                "bround_rev", "round_rev_neg", "round_ext", "floor_ext",
                "ceil_ext", "sqrt", "rint", "degrees", "radians", "signum",
                "greatest_date", "least_date", "width_bucket", "pow",
                "atan2", "hypot", "exp", "expm1", "log1p", "asin", "acos",
                "atan", "sinh", "cosh", "tanh", "log", "log10", "log2",
                "cbrt", "sin", "cos", "tan", "cot", "sec", "csc")


def expected_scalars(li, part: int, parts: int) -> dict:
    """SUM / MIN / MAX per group of every `parts`-th projection of
    scalars_q1 from `part` on (sums of integral and DECIMAL lanes exact
    in int64, of DOUBLEs by np.sum, pairwise)."""
    perm, starts, codes = _group_sorted(li)
    ends = np.r_[starts[1:], len(perm)]
    c = {"l_orderkey": _col(li, "l_orderkey").data[perm].astype(np.int64)}
    for short, name in (("ext", "l_extendedprice"), ("disc", "l_discount"),
                        ("tax", "l_tax"), ("qty", "l_quantity")):
        c[short + "_u"] = _col(li, name).data[perm].astype(np.int64)
        c[short] = c[short + "_u"].astype(np.float64) / 100.0
    for short, name in (("ship", "l_shipdate"), ("commit", "l_commitdate"),
                        ("receipt", "l_receiptdate")):
        c[short] = _col(li, name).data[perm]
    out = {"_codes": codes}
    for name in SCALAR_NAMES[part::parts]:
        v = _np_scalar(name, c)
        segs = [v[a:b] for a, b in zip(starts, ends)]
        if not name.endswith("_date"):
            out[f"sum_{name}"] = np.array([s.sum() for s in segs])
        out[f"min_{name}"] = np.array([s.min() for s in segs])
        out[f"max_{name}"] = np.array([s.max() for s in segs])
    return out


def sample_hash_np(pos: np.ndarray, seed: int) -> np.ndarray:
    """The reference's murmur3 finalizer in numpy uint32 (its own
    wrapping multiplies and logical shifts)."""
    h = pos.astype(np.uint32) ^ np.uint32((seed * 0x9E3779B9) & U32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def expected_range_sample() -> dict:
    thr = np.uint32(min(int(round(SAMPLE_FRACTION * 2.0 ** 32)), U32))
    kept = []
    for lo in range(0, RANGE_ROWS, 1 << 24):
        ids = np.arange(lo, min(lo + (1 << 24), RANGE_ROWS), dtype=np.int64)
        kept.append(ids[sample_hash_np(ids, SAMPLE_SEED) < thr])
    kept = np.concatenate(kept)
    m = kept % 1000
    n = np.bincount(m, minlength=1000)
    s = np.zeros(1000, np.int64)
    np.add.at(s, m, kept)
    live = n > 0
    return {"m": np.flatnonzero(live), "n": n[live], "s": s[live],
            "count": len(kept)}


def _np_java_div(a, b):
    """Java's long division truncating toward zero, b != 0, MIN / -1
    wrapping to MIN."""
    safe = np.where((b == 0) | (b == -1), 1, b)
    q = np.abs(a) // np.abs(safe)
    q = np.where((a < 0) != (safe < 0), -q, q)
    return np.where(b == -1, -a, q)


def expected_edge() -> dict:
    """Every edge_values column in numpy: (data, valid) pairs."""
    i = np.arange(EDGE_LO, EDGE_HI, dtype=np.int64)
    ones = np.ones(len(i), bool)
    with np.errstate(all="ignore"):
        a = i.astype(np.float64) / 1000.0
        div = np.fmod(i, 23) - 11
        x = a / div.astype(np.float64)
        xv = div != 0
        case = [(np.fmod(i, 11) == 0, np.nan, True),
                (np.fmod(i, 13) == 0, None, True),
                (np.fmod(i, 17) == 0, -0.0, True),
                (np.fmod(i, 19) == 0, 0.0, False)]
        taken = np.zeros(len(i), bool)
        for hit, val, valid in case:
            h = hit & ~taken
            x = np.where(h, a * 1e306 if val is None else val, x)
            xv = np.where(h, valid, xv)
            taken |= hit
        y = np.where(np.fmod(i, 29) == 0, np.nan,
                     np.fmod(i, 1000).astype(np.float64) / 7.0)
        lmin = i + (LONG_MIN - EDGE_LO)
        dec = np.fmod(i, 100000)                       # unscaled, scale 2
        d7 = np.fmod(i, 7) - 3
        out = {"x": (x, xv), "y": (y, ones),
               "div": (_np_java_div(i, d7), d7 != 0),
               "rem": (np.fmod(i, np.where(d7 == 0, 1, d7)), d7 != 0),
               "div_min": (-lmin, ones), "rem_min": (lmin * 0, ones),
               "neg_min": (-lmin, ones),
               "abs_min": (np.where(lmin < 0, -lmin, lmin), ones),
               "rem_double": (np.fmod(x, np.where(y == 0, 1.0, y)),
                              xv & (y != 0)),
               "neg": (-x, xv), "abs": (np.abs(x), xv),
               "isnan": (np.isnan(x) & xv, ones)}
        eq = (x == y) & xv
        out["nullsafe_eq"] = (eq, ones)
        big = 9.223372036854775e18
        for nm, f in (("floor", np.floor), ("ceil", np.ceil)):
            r = np.clip(np.nan_to_num(f(x), nan=0.0), -big * 1.0000000001,
                        big)
            r = np.where(r < -big, float(LONG_MIN), r)
            out[nm] = (r.astype(np.int64), xv)
        y2 = x * 100.0
        out["round2"] = (np.trunc(y2 + np.where(x >= 0, 0.5, -0.5)) / 100.0,
                         xv)
        out["bround2"] = (np.round(y2) / 100.0, xv)
        y1 = x * 0.1
        out["round_neg"] = (np.trunc(y1 + np.where(x >= 0, 0.5, -0.5)) /
                            0.1, xv)
        q, r = np.divmod(lmin, 100)                     # floor division
        up = (r > 50) | ((r == 50) & (lmin >= 0))      # ties away from 0
        out["round_long"] = ((q + up) * 100, ones)
        for nm, drop, even, mul in (("round_dec", 1, False, 1),
                                    ("bround_dec", 1, True, 1),
                                    ("round_dec_neg", 4, False, 100)):
            p = 10 ** drop
            qt = np.trunc(dec / p).astype(np.int64)
            r2 = np.abs(dec - qt * p) * 2
            upd = (r2 > p) | ((r2 == p) & (qt % 2 != 0)) if even \
                else r2 >= p
            qt = qt + np.where(upd, np.sign(dec), 0)
            out[nm] = (qt * mul, ones)
        out["floor_dec"] = (np.floor_divide(dec, 100), ones)
        out["ceil_dec"] = (-np.floor_divide(-dec, 100), ones)
        out["sqrt"] = (np.sqrt(x), xv)
        out["rint"] = (np.rint(x), xv)
        out["degrees"] = (np.degrees(x), xv)
        out["radians"] = (np.radians(x), xv)
        out["signum"] = (np.where((x == 0) | np.isnan(x), x, np.sign(x)),
                         xv)
        out["greatest"] = (_java_max(_java_max(x, xv, y, ones), ones,
                                     np.zeros(len(i)), ones), ones)
        out["least"] = (_java_min(x, xv, y, ones), ones)
        bad = np.isnan(x)
        frac = (x + 100.0) / 200.0
        inside = ~((x < -100.0) | (x >= 100.0) | bad)
        mid = np.where(inside, frac * 10.0, 0.0).astype(np.int64) + 1
        out["width_bucket"] = (np.where(x < -100.0, 0,
                                        np.where(x >= 100.0, 11, mid)),
                               xv & ~bad)
        out["pow"] = (np.power(x, y), xv)
        out["atan2"] = (np.arctan2(x, y), xv)
        out["hypot"] = (np.hypot(x, y), xv)
        one = {"exp": np.exp, "expm1": np.expm1, "cbrt": np.cbrt,
               "sin": np.sin, "cos": np.cos, "tan": np.tan,
               "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
               "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
               "cot": lambda v: 1.0 / np.tan(v),
               "sec": lambda v: 1.0 / np.cos(v),
               "csc": lambda v: 1.0 / np.sin(v)}
        for nm, f in one.items():
            out[nm] = (f(x), xv)
        for nm, f, floor in (("log", np.log, 0.0), ("log10", np.log10, 0.0),
                             ("log2", np.log2, 0.0),
                             ("log1p", np.log1p, -1.0)):
            out[nm] = (f(x), xv & (x > floor))
    return out


def _java_max(a, av, b, bv):
    """greatest of two nullable DOUBLE lanes: nulls skipped, NaN the
    largest, -0.0 below 0.0 (Java's Double.compare)."""
    take_b = bv & (~av | (np.isnan(b) & ~np.isnan(a)) |
                   (~np.isnan(a) & ~np.isnan(b) &
                    ((b > a) | ((b == a) & np.signbit(a) & ~np.signbit(b)))))
    return np.where(take_b, b, a)


def _java_min(a, av, b, bv):
    take_b = bv & (~av | (np.isnan(a) & ~np.isnan(b)) |
                   (~np.isnan(a) & ~np.isnan(b) &
                    ((b < a) | ((b == a) & ~np.signbit(a) & np.signbit(b)))))
    return np.where(take_b, b, a)


def expected_dense_sf10(t) -> dict:
    """{(category, class, color) codes with -1 for null: (sum net paid
    unscaled, count, avg quantity, min price, max price, stddev_samp
    price)} over store_sales rows with an item."""
    ss, item = t["store_sales"], t["item"]
    sk = _col(ss, "ss_item_sk")
    ok = sk.valid_mask()
    rows = sk.data[ok].astype(np.int64) - 1
    codes = []
    for name in DENSE_KEYS:
        c = _col(item, name)
        v = c.data.astype(np.int64)
        if c.validity is not None:
            v = np.where(c.validity, v, -1)
        codes.append(v[rows])
    sizes = [int(c.max()) + 2 for c in codes]
    g = (codes[0] + 1) * sizes[1] * sizes[2] + (codes[1] + 1) * sizes[2] + \
        codes[2] + 1
    perm = np.argsort(g, kind="stable")
    gs = g[perm]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    ends = np.r_[starts[1:], len(gs)]

    def lane(name):
        c = _col(ss, name)
        return c.data[ok][perm], c.valid_mask()[ok][perm]
    paid, paid_ok = lane("ss_net_paid")
    qty, qty_ok = lane("ss_quantity")
    price, price_ok = lane("ss_sales_price")
    out = {}
    for a, b in zip(starts, ends):
        key = tuple(int(c[perm[a]]) for c in codes)
        pv = price[a:b][price_ok[a:b]].astype(np.int64)
        pf = pv.astype(np.float64) / 100.0
        sd = math.sqrt(float(np.dot(pf - pf.mean(), pf - pf.mean())) /
                       (len(pf) - 1)) if len(pf) > 1 else None
        qv = qty[a:b][qty_ok[a:b]].astype(np.int64)
        out[key] = (int(paid[a:b][paid_ok[a:b]].astype(np.int64).sum())
                    if paid_ok[a:b].any() else None,
                    b - a, float(qv.sum()) / len(qv) if len(qv) else None,
                    int(pv.min()) if len(pv) else None,
                    int(pv.max()) if len(pv) else None, sd)
    return out


def expected(name: str, tables):
    """One numpy result by name (run in a forked process)."""
    if name == "moments_q1":
        return expected_moments(tables["lineitem"])
    if name.startswith("scalars_q1:"):
        part, parts = map(int, name.split(":")[1].split("/"))
        return expected_scalars(tables["lineitem"], part, parts)
    if name == "dense_sf10":
        return expected_dense_sf10(tables)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between float64 lanes, exactly, in int64:
    0 where both are NaN or equal (-0.0 == 0.0), 2^62 across signs."""
    ia = a.view(np.int64)
    ib = b.view(np.int64)
    mag = np.int64(0x7FFFFFFFFFFFFFFF)
    oa = np.where(ia < 0, -(ia & mag), ia)
    ob = np.where(ib < 0, -(ib & mag), ib)
    d = np.where((oa < 0) != (ob < 0), np.int64(1 << 62), np.abs(oa - ob))
    return np.where((np.isnan(a) & np.isnan(b)) | (a == b), 0, d)


def check_lane(name: str, kind: str, got, want) -> float:
    """Compare one lane (got: data, valid; want: data, valid) by its
    kind; -> the largest ulp distance seen (0 for exact kinds).  Raises
    AssertionError naming the first differing row."""
    gd, gv = got
    wd, wv = want
    if not np.array_equal(gv, wv):
        bad = int(np.flatnonzero(gv != wv)[0])
        raise AssertionError(f"{name}: validity differs at row {bad}: "
                             f"card {gv[bad]}, numpy {wv[bad]}")
    gd, wd = gd[gv], np.asarray(wd)[wv]
    if kind == "ulp":
        d = ulp_distance(gd.astype(np.float64), wd.astype(np.float64))
        inf_bad = np.isinf(gd) != np.isinf(wd)
        if d.max(initial=0) > ULPS or inf_bad.any():
            bad = int(np.argmax(d))
            raise AssertionError(f"{name}: {d.max():.0f} ulps at a valid "
                                 f"row: card {gd[bad]!r}, numpy {wd[bad]!r}")
        return float(d.max(initial=0))
    if kind == "exact":
        same = gd.astype(np.float64).view(np.int64) == \
            wd.astype(np.float64).view(np.int64)
        same |= np.isnan(gd) & np.isnan(wd)
    else:
        same = gd.astype(np.int64) == wd.astype(np.int64)
    if not same.all():
        bad = int(np.flatnonzero(~same)[0])
        raise AssertionError(f"{name}: card {gd[bad]!r}, numpy {wd[bad]!r} "
                             f"at a valid row")
    return 0.0


def close(name: str, got: np.ndarray, want: np.ndarray, rtol: float = RTOL,
          scale=None):
    """Within rtol of numpy's value; with `scale` (a covariance's or
    correlation's cancelled magnitude, per group), within rtol of that
    instead where it is larger: the moment form sxy - sx sy / n subtracts
    terms of that size, so its rounding is relative to them, not to a
    near-zero difference."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = rtol * np.abs(want)
    if scale is not None:
        tol = np.maximum(tol, rtol * np.asarray(scale, np.float64))
    ok = (np.abs(got - want) <= tol) | (np.isnan(got) & np.isnan(want))
    if not ok.all():
        raise AssertionError(f"{name}: card {got}, numpy {want} (rtol "
                             f"{rtol}{'' if scale is None else ' of the scale'}"
                             f" {scale})")
