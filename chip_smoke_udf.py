"""The udf phase of chip_smoke.py: the UDFs on the card, at SF10 on the
data phase's TPC-H columns.

Cases (each a cold and a warm run through TpuSession() on cuda,
printing its walls, the peak device memory, the plan's exec names and
its kernel launches), each checked against numpy or plain Python
computed independently:

  * udf_q1: q1 with disc_price and charge written as Python lambdas and
    compiled by the udf-compiler (plan/udf_compiler.py) over lineitem's
    rows: the compiled trees equal q1's hand-written expressions, the
    answer equals q1's numpy answer, the launches equal q1's in the path
    phase of the same run, and under wholePlan=ON its decision equals
    q1's (a structure hit on q1's graph is printed if one happens);
  * tpuudf_q3: q3 with its two date filters and its revenue as TpuUDFs
    over torch tensors (the decimals cast to DOUBLE first): q3's keys
    and order, the DOUBLE revenue within 1e-12 relative of the exact
    decimal answer, the launches q3's in the path phase; again under
    wholePlan=ON, captured, its decision printed;
  * hive_q3: the same with the revenue as a TpuHiveUDF's columnar form;
    hive_supp: a row-based HiveSimpleUDF over supplier's s_name values
    (the CPU engine, an island in a device plan) feeding a join into
    lineitem's aggregation, with the island's host ms and its
    transitions' bytes (`host_profile`);
  * pyudf_part: an untranslatable `udf()` (a loop) over part's p_name,
    the PythonUDF fallback on the CPU engine, then a device group-by with
    SUM and MAX of p_size (the port's part table has no p_retailprice);
  * worker_wire: orders' rows of four lanes (one dictionary-coded)
    through a forked worker over the numpy wire and back unchanged,
    after the card has been used: no pandas needed; its launches counted
    as every case's are (none);
  * where `import pandas` succeeds: map_pd_orders (map_in_pandas),
    scalar_pd_orders (with_pandas_udf), apply_pd_priority
    (apply_in_pandas over o_orderpriority's five groups), agg_pd_nation
    (agg_in_pandas over customer by c_nationkey), window_pd_supp
    (with_window_pandas_udf over supplier) and cogroup_pd_nation
    (customer with supplier), each followed by a device group-by; the
    orders cases over the first PANDAS_ORDERS rows of orders (a pandas
    exec is host bound: its depth costs the smoke's clock and shows no
    device behaviour).  Without pandas they do not run, and the phase
    says so.

Imports torch only at module level.
"""
from __future__ import annotations

import datetime as pydt
import decimal
import time

import numpy as np
import torch

TABLE_COLUMNS = {
    "lineitem": ("l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice",
                 "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                 "l_shipdate"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
               "o_orderpriority"),
    "customer": ("c_custkey", "c_mktsegment", "c_nationkey"),
    "part": ("p_partkey", "p_name", "p_size"),
    "supplier": ("s_suppkey", "s_nationkey", "s_name"),
}
CASES = ("udf_q1", "tpuudf_q3", "hive_q3", "hive_supp", "pyudf_part",
         "worker_wire")
PANDAS_CASES = ("map_pd_orders", "scalar_pd_orders", "apply_pd_priority",
                "agg_pd_nation", "window_pd_supp", "cogroup_pd_nation")
#: the data phase's numpy results the phase reads, and the path phase's
#: launches it holds udf_q1, tpuudf_q3 and hive_q3 to
WANTS = ("q1", "q3")
Q3_DATE = (pydt.date(1995, 3, 15) - pydt.date(1970, 1, 1)).days
#: hive_supp keeps the suppliers whose name's number is a multiple
SUPP_EVERY = 10
WIRE_ROWS = 1 << 22
#: the rows of orders the pandas cases read (an eighth at SF10)
PANDAS_ORDERS = 1_875_000


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


def _col(name):
    from spark_rapids_tpu_torch.session import col
    return col(name)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

def disc_price_fn(p, d):
    return p * (1 - d)


def charge_fn(p, d, x):
    return p * (1 - d) * (1 + x)


def after_fn(d):
    return d > Q3_DATE


def before_fn(d):
    return d < Q3_DATE


def revenue_fn(p, d):
    return p * (1 - d)


def _hive_classes():
    from spark_rapids_tpu_torch.plan.hive_udf import TpuHiveUDF

    class Revenue(TpuHiveUDF):
        """q3's revenue: columnar on the card, row form on the CPU."""

        def evaluate(self, p, d):
            return None if p is None or d is None else p * (1 - d)

        def evaluate_columnar(self, p, d):
            return p * (1 - d)

    class NameKey:
        """A plain hive UDF: the number in `Supplier#000012345`."""

        def evaluate(self, name):
            return None if name is None else int(name.rsplit("#", 1)[1])
    return Revenue, NameKey


def vowel_words(name):
    """Words of a part name that start with a vowel (a loop: the
    udf-compiler cannot translate it)."""
    n = 0
    for w in name.split(" "):
        if w[:1] in ("a", "e", "i", "o", "u"):
            n += 1
    return n


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------

def udf_exprs(schema):
    from spark_rapids_tpu_torch.plan.udf_compiler import compile_udf
    p, d, x = (_col(n) for n in ("l_extendedprice", "l_discount", "l_tax"))
    return (compile_udf(disc_price_fn, [p, d], schema),
            compile_udf(charge_fn, [p, d, x], schema))


def udf_q1(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Average, Count, Sum
    cutoff = (pydt.date(1998, 12, 1) - pydt.date(1970, 1, 1)).days - 90
    li = s.from_host(t["lineitem"])
    disc_price, charge = udf_exprs(li.schema)
    return (li.filter(E.LessThanOrEqual(_col("l_shipdate"),
                                        E.Literal(cutoff, T.DATE)))
            .group_by("l_returnflag", "l_linestatus")
            .agg((Sum(_col("l_quantity")), "sum_qty"),
                 (Sum(_col("l_extendedprice")), "sum_base_price"),
                 (Sum(disc_price), "sum_disc_price"),
                 (Sum(charge), "sum_charge"),
                 (Average(_col("l_quantity")), "avg_qty"),
                 (Average(_col("l_extendedprice")), "avg_price"),
                 (Average(_col("l_discount")), "avg_disc"),
                 (Count(None), "count_order"))
            .sort("l_returnflag", "l_linestatus"))


def _q3_with(s, t, revenue):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    from spark_rapids_tpu_torch.plan.udf import TpuUDF
    cust = s.from_host(t["customer"]).filter(
        E.EqualTo(_col("c_mktsegment"), E.Literal("BUILDING")))
    orders = s.from_host(t["orders"]).filter(
        TpuUDF(before_fn, T.BOOLEAN, _col("o_orderdate")))
    li = s.from_host(t["lineitem"]).filter(
        TpuUDF(after_fn, T.BOOLEAN, _col("l_shipdate")))
    j = cust.join(orders, left_on=["c_custkey"], right_on=["o_custkey"]) \
        .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
    dbl = [E.Cast(_col(n), T.DOUBLE) for n in ("l_extendedprice",
                                               "l_discount")]
    return (j.group_by("o_orderkey", "o_orderdate", "o_shippriority")
            .agg((Sum(revenue(*dbl)), "revenue"))
            .sort(("revenue", False, False), ("o_orderdate", True, True))
            .limit(10))


def tpuudf_q3(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.udf import TpuUDF
    return _q3_with(s, t, lambda p, d: TpuUDF(revenue_fn, T.DOUBLE, p, d))


_HIVE = {}


def hive_q3(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.hive_udf import HiveSimpleUDF
    if "revenue" not in _HIVE:
        rev, key = _hive_classes()
        _HIVE["revenue"], _HIVE["key"] = rev(), key()
    return _q3_with(s, t, lambda p, d: HiveSimpleUDF(_HIVE["revenue"],
                                                     T.DOUBLE, p, d))


def hive_supp(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.plan.hive_udf import HiveSimpleUDF
    if "key" not in _HIVE:
        rev, key = _hive_classes()
        _HIVE["revenue"], _HIVE["key"] = rev(), key()
    supp = s.from_host(t["supplier"]).select(
        HiveSimpleUDF(_HIVE["key"], T.LONG, _col("s_name")),
        names=["nk"]).filter(E.EqualTo(E.Remainder(
            _col("nk"), E.Literal(SUPP_EVERY)), E.Literal(0)))
    return s.from_host(t["lineitem"]).join(
        supp, left_on=["l_suppkey"], right_on=["nk"]).agg(
        (Sum(_col("l_quantity")), "qty"), (Count(None), "n"))


def pyudf_part(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.aggregates import Max, Sum
    from spark_rapids_tpu_torch.plan.udf_compiler import udf
    part = s.from_host(t["part"])
    return part.select(udf(vowel_words, T.LONG, _col("p_name"),
                           schema=part.schema), _col("p_size"),
                       names=["v", "p"]) \
        .group_by("v").agg((Sum(_col("p")), "sp"), (Max(_col("p")), "mp")) \
        .sort("v")


def map_pd_orders(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    schema = T.StructType([T.StructField("m", T.LONG),
                           T.StructField("o_custkey", T.LONG)])
    return s.from_host(t["orders"]).select(
        _col("o_orderkey"), _col("o_custkey"),
        names=["o_orderkey", "o_custkey"]).map_in_pandas(
        lambda it: (df.assign(m=df.o_orderkey % 7)[["m", "o_custkey"]]
                    for df in it), schema) \
        .group_by("m").agg((Count(None), "n"), (Sum(_col("o_custkey")), "c")) \
        .sort("m")


def scalar_pd_orders(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    return s.from_host(t["orders"]).select(_col("o_orderkey"),
                                           names=["o_orderkey"]) \
        .with_pandas_udf("h", lambda k: k % 5, ["o_orderkey"], T.LONG) \
        .group_by("h").agg((Count(None), "n"),
                           (Sum(_col("o_orderkey")), "k")).sort("h")


def _per_priority(df):
    import pandas as pd
    return pd.DataFrame({"p": [df["o_orderpriority"].iloc[0]],
                         "n": [len(df)], "c": [int(df["o_custkey"].sum())]})


def apply_pd_priority(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    schema = T.StructType([T.StructField("p", T.STRING),
                           T.StructField("n", T.LONG),
                           T.StructField("c", T.LONG)])
    return s.from_host(t["orders"]).select(
        _col("o_orderpriority"), _col("o_custkey"),
        names=["o_orderpriority", "o_custkey"]) \
        .group_by("o_orderpriority").apply_in_pandas(_per_priority, schema) \
        .group_by("p").agg((Sum(_col("n")), "n"), (Sum(_col("c")), "c")) \
        .sort("p")


def agg_pd_nation(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    return s.from_host(t["customer"]).select(
        _col("c_nationkey"), _col("c_custkey"),
        names=["c_nationkey", "c_custkey"]).group_by("c_nationkey") \
        .agg_in_pandas((lambda k: int(k.sum()), ["c_custkey"], "ks", T.LONG)) \
        .group_by(E.Alias(E.Remainder(_col("c_nationkey"), E.Literal(5)),
                          "g")) \
        .agg((Sum(_col("ks")), "ks")).sort("g")


def window_pd_supp(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    return s.from_host(t["supplier"]).select(
        _col("s_suppkey"), _col("s_nationkey"),
        names=["s_suppkey", "s_nationkey"]).with_window_pandas_udf(
        "r", lambda k: k - k.min(), ["s_suppkey"], T.LONG,
        partition_by=["s_nationkey"], order_by=["s_suppkey"]) \
        .group_by("s_nationkey").agg((Sum(_col("r")), "r")) \
        .sort("s_nationkey")


def _pair(c, su):
    import pandas as pd
    nk = c["c_nationkey"].iloc[0] if len(c) else su["s_nationkey"].iloc[0]
    return pd.DataFrame({"nk": [int(nk)], "nc": [len(c)], "ns": [len(su)]})


def cogroup_pd_nation(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    schema = T.StructType([T.StructField("nk", T.LONG),
                           T.StructField("nc", T.LONG),
                           T.StructField("ns", T.LONG)])
    cust = s.from_host(t["customer"]).select(
        _col("c_nationkey"), _col("c_custkey"),
        names=["c_nationkey", "c_custkey"])
    supp = s.from_host(t["supplier"]).select(
        _col("s_nationkey"), _col("s_suppkey"),
        names=["s_nationkey", "s_suppkey"])
    return cust.group_by("c_nationkey").cogroup(supp.group_by("s_nationkey")) \
        .apply_in_pandas(_pair, schema) \
        .agg((Sum(_col("nc")), "nc"), (Sum(_col("ns")), "ns"),
             (Count(None), "groups"))


BUILDS = {"udf_q1": udf_q1, "tpuudf_q3": tpuudf_q3, "hive_q3": hive_q3,
          "hive_supp": hive_supp, "pyudf_part": pyudf_part,
          "map_pd_orders": map_pd_orders,
          "scalar_pd_orders": scalar_pd_orders,
          "apply_pd_priority": apply_pd_priority,
          "agg_pd_nation": agg_pd_nation, "window_pd_supp": window_pd_supp,
          "cogroup_pd_nation": cogroup_pd_nation}


# ---------------------------------------------------------------------------
# numpy and plain-Python results
# ---------------------------------------------------------------------------

def _data(t, table, name):
    return t[table].column_by_name(name).data


def expected(name: str, t):
    if name == "hive_supp":
        names = t["supplier"].column_by_name("s_name").to_pylist()
        nk = np.array([int(v.rsplit("#", 1)[1]) for v in names], np.int64)
        keep = nk[nk % SUPP_EVERY == 0]
        m = np.isin(_data(t, "lineitem", "l_suppkey"), keep)
        qty = int(_data(t, "lineitem", "l_quantity")[m].sum())
        return {"qty": [decimal.Decimal(qty).scaleb(-2)],
                "n": [int(m.sum())]}
    if name == "pyudf_part":
        v = np.array([vowel_words(n) for n in
                      t["part"].column_by_name("p_name").to_pylist()])
        p = _data(t, "part", "p_size").astype(np.int64)
        keys = np.unique(v)
        return {"v": keys.tolist(),
                "sp": [int(p[v == k].sum()) for k in keys],
                "mp": [int(p[v == k].max()) for k in keys]}
    ok = _data(t, "orders", "o_orderkey")
    oc = _data(t, "orders", "o_custkey")
    if name == "map_pd_orders":
        m = ok % 7
        keys = np.unique(m)
        return {"m": keys.tolist(),
                "n": np.bincount(m)[keys].tolist(),
                "c": [int(oc[m == k].sum()) for k in keys]}
    if name == "scalar_pd_orders":
        h = ok % 5
        keys = np.unique(h)
        return {"h": keys.tolist(), "n": np.bincount(h)[keys].tolist(),
                "k": [int(ok[h == k].sum()) for k in keys]}
    if name == "apply_pd_priority":
        pr = t["orders"].column_by_name("o_orderpriority")
        codes = np.unique(pr.data)
        return {"p": [str(pr.dictionary[c]) for c in codes],
                "n": [int((pr.data == c).sum()) for c in codes],
                "c": [int(oc[pr.data == c].sum()) for c in codes]}
    cn = _data(t, "customer", "c_nationkey")
    ck = _data(t, "customer", "c_custkey")
    sn = _data(t, "supplier", "s_nationkey")
    sk = _data(t, "supplier", "s_suppkey")
    if name == "agg_pd_nation":
        g = cn % 5
        return {"g": list(range(5)),
                "ks": [int(ck[g == k].sum()) for k in range(5)]}
    if name == "window_pd_supp":
        keys = np.unique(sn)
        return {"s_nationkey": keys.tolist(),
                "r": [int((sk[sn == k] - sk[sn == k].min()).sum())
                      for k in keys]}
    if name == "cogroup_pd_nation":
        return {"nc": [len(ck)], "ns": [len(sk)],
                "groups": [len(np.union1d(np.unique(cn), np.unique(sn)))]}
    raise KeyError(name)


def _check_q3_double(C, name, got, want_q3):
    """q3's keys and order; the DOUBLE revenue within 1e-12 relative of
    the exact decimal sums (scale 4)."""
    top, _tied = want_q3
    d = got.to_pydict()
    keys = ("o_orderkey", "o_orderdate", "o_shippriority")
    for k in keys:
        vals = d[k] if k != "o_orderdate" else [
            (v - pydt.date(1970, 1, 1)).days for v in d[k]]
        C.check(vals == top[k], f"{name}: {k} {vals} differs from q3's "
                f"numpy {top[k]}")
    exact = np.array(top["revenue"], np.float64) / 1e4
    rel = np.abs(np.array(d["revenue"]) - exact) / np.abs(exact)
    C.check(len(rel) == len(exact) and bool(np.all(rel <= 1e-12)),
            f"{name}: revenue {d['revenue']} beyond 1e-12 relative of "
            f"{exact.tolist()} (max {rel.max() if len(rel) else None})")
    return float(rel.max())


# ---------------------------------------------------------------------------
# the phase
# ---------------------------------------------------------------------------

def _session(conf=None):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(conf)


def _walk(node):
    yield node
    for c in getattr(node, "children", ()):
        yield from _walk(c)
    for c in (getattr(node, "device_child", None),
              getattr(node, "host_child", None)):
        if c is not None:
            yield from _walk(c)


def _execs(q) -> list:
    return sorted({type(n).__name__ for n in _walk(q.root)})


def _island(ctx) -> str:
    from spark_rapids_tpu_torch.exec.host_exec import host_profile
    prof = host_profile(ctx)
    ops = {k.split("#")[0]: round(v * 1e3, 1) for k, v in prof.items()
           if "#" in k}
    return (f"CPU operators' host ms {ops}; host-to-device "
            f"{prof['h2d_bytes']} bytes in {prof['h2d_s'] * 1e3:.1f} ms, "
            f"device-to-host {prof['d2h_bytes']} bytes in "
            f"{prof['d2h_s'] * 1e3:.1f} ms")


def _run(C, s, name, t, extra_fn=None):
    """One case: cold and warm walls, peak, execs, launches, logged."""
    got, ctx, cold, warm, peak, ln = C._timed(s, BUILDS[name], t, reps=1)
    q = BUILDS[name](s, t).physical()
    extra = f"; execs {_execs(q)}"
    if extra_fn is not None:
        extra += extra_fn(got, ctx)
    C._check_launches(name, ln)
    C._query_log(name, got.num_rows, cold, warm, peak, ln, extra, tag="udf")
    return got, ctx, ln


def _wire(C, t):
    """orders' four lanes through a forked worker and back."""
    from spark_rapids_tpu_torch.exec import python_exec as PE
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    hb = t["orders"].select(["o_orderkey", "o_custkey", "o_orderpriority",
                             "o_orderdate"])
    ctx = ExecContext()
    n = hb.num_rows
    parts = [hb.slice(i, min(WIRE_ROWS, n - i))
             for i in range(0, n, WIRE_ROWS)]
    t0 = time.perf_counter()
    back = list(PE.worker_stream(ctx, (((p,), None) for p in parts),
                                 lambda frames: (b[0] for b, _x in frames)))
    wall = time.perf_counter() - t0
    C.check(sum(b.num_rows for b in back) == n,
            f"worker_wire: {sum(b.num_rows for b in back)} rows came back, "
            f"not {n}")
    off = 0
    for b in back:
        for name, c in zip(b.names, b.columns):
            src = hb.column_by_name(name).slice(off, b.num_rows)
            C.check(np.array_equal(c.data, src.data) and np.array_equal(
                c.valid_mask(), src.valid_mask()) and (
                c.dictionary is None or np.array_equal(
                    c.dictionary, src.dictionary)),
                f"worker_wire: column {name} changed on the wire")
        off += b.num_rows
    nbytes = ctx.metrics["python_wire_out_bytes"] + \
        ctx.metrics["python_wire_in_bytes"]
    C.log(f"[udf] worker_wire: {n} rows of 4 lanes (o_orderpriority "
          f"dictionary-coded) through a forked worker and back unchanged "
          f"in {wall * 1e3:.1f} ms: {nbytes} bytes on the wire both ways, "
          f"{nbytes / wall / 1e6:.1f} MB/s; workers started "
          f"{ctx.metrics['python_workers_started']}")


def udf_phase(C, tables, want, path_launches) -> dict:
    """Every case on the card; `path_launches` are q1's and q3's from
    the path phase of this run.  -> launches by case."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.exec import compiled as CP
    from spark_rapids_tpu_torch.plan import expressions as E
    t_phase = time.perf_counter()
    t = tables
    s = _session()
    launches = {}
    # udf_q1: the compiled trees are q1's, the answer and launches too
    li = s.from_host(t["lineitem"])
    disc, charge = udf_exprs(li.schema)
    p, d, x = (_col(n) for n in ("l_extendedprice", "l_discount", "l_tax"))
    q1_disc = E.Multiply(p, E.Subtract(E.Literal(1), d))
    q1_charge = E.Multiply(q1_disc, E.Add(E.Literal(1), x))
    C.check(repr(disc) == repr(q1_disc) and repr(charge) == repr(q1_charge),
            f"udf_q1: compiled trees {disc!r}, {charge!r} are not q1's")
    C.log(f"[udf] udf_q1 compiled trees equal q1's: {disc!r}; {charge!r}")
    got, _ctx, ln = _run(C, s, "udf_q1", t)
    C.check(C.lanes_of(got) == want["q1"], "udf_q1 differs from q1's numpy")
    C.check(ln == path_launches["q1"], f"udf_q1 launched {ln}, q1 "
            f"{path_launches['q1']}")
    launches["udf_q1"] = ln
    # tpuudf_q3 and hive_q3: q3's path through TpuUDF / TpuHiveUDF
    for name in ("tpuudf_q3", "hive_q3"):
        got, _ctx, ln = _run(C, s, name, t)
        rel = _check_q3_double(C, name, got, want["q3"])
        C.log(f"[udf] {name}: revenue within {rel:.2e} relative of the "
              "exact decimal sums")
        C.check(ln == path_launches["q3"], f"{name} launched {ln}, q3 "
                f"{path_launches['q3']}")
        launches[name] = ln
    # hive_supp: the row-based hive UDF as a CPU island
    supp_want = expected("hive_supp", t)
    got, ctx, ln = _run(C, s, "hive_supp", t,
                        lambda g, c: "; " + _island(c))
    C.check(got.to_pydict() == supp_want, f"hive_supp {got.to_pydict()} "
            f"differs from numpy {supp_want}")
    launches["hive_supp"] = ln
    # pyudf_part: udf() falls back to PythonUDF
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.udf import PythonUDF
    from spark_rapids_tpu_torch.plan.udf_compiler import udf
    C.check(isinstance(udf(vowel_words, T.LONG, _col("p_name")), PythonUDF),
            "pyudf_part: the loop did not fall back to PythonUDF")
    part_want = expected("pyudf_part", t)
    got, ctx, ln = _run(C, s, "pyudf_part", t,
                        lambda g, c: "; " + _island(c))
    C.check(got.to_pydict() == part_want, f"pyudf_part {got.to_pydict()} "
            f"differs from plain Python {part_want}")
    launches["pyudf_part"] = ln
    # whole-plan capture: udf_q1's decision is q1's, tpuudf_q3 captures
    CP.clear_caches()
    on = _session({"spark.rapids.tpu.sql.compile.wholePlan": "ON"})
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    decisions = {}
    for name, build in (("q1", tpch.q1), ("udf_q1", udf_q1),
                        ("tpuudf_q3", tpuudf_q3), ("hive_q3", hive_q3),
                        ("hive_supp", hive_supp)):
        q = build(on, t).physical()
        walls, hits = [], 0
        for _ in range(2):
            ctx = ExecContext(q.conf, q.device)
            t0 = time.perf_counter()
            res = q.collect(ctx)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            hits += ctx.metrics.get("whole_plan_structure_hits", 0)
        decisions[name] = CP.decision(q)
        if name == "udf_q1":
            C.check(C.lanes_of(res) == want["q1"],
                    "udf_q1 under wholePlan=ON differs from q1's numpy")
        elif name in ("tpuudf_q3", "hive_q3"):
            _check_q3_double(C, name, res, want["q3"])
        elif name == "hive_supp":
            C.check(res.to_pydict() == supp_want,
                    "hive_supp under wholePlan=ON differs from numpy")
        C.log(f"[udf] {name} wholePlan=ON: decision {decisions[name]}; "
              f"first run {walls[0]:.1f} ms, second {walls[1]:.1f} ms; "
              f"structure hits {hits}")
    C.check(decisions["udf_q1"] == decisions["q1"],
            f"udf_q1's decision {decisions['udf_q1']} is not q1's "
            f"{decisions['q1']}")
    for name in ("tpuudf_q3", "hive_q3"):
        C.check(decisions[name] == "whole" or
                decisions[name].startswith("split"),
                f"{name} under wholePlan=ON was not captured: "
                f"{decisions[name]}")
    CP.clear_caches()
    # the numpy wire through a forked worker, after the card's work
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    reset_launch_counts()
    _wire(C, t)
    launches["worker_wire"] = dict(LAUNCHES)
    C.check(not any(launches["worker_wire"].values()), f"worker_wire "
            f"launched {launches['worker_wire']}, not nothing")
    try:
        import pandas
    except ImportError:
        C.log("[udf] pandas: absent; the six pandas cases do not run here "
              "(tier-1 holds them on the CPU)")
    else:
        C.log(f"[udf] pandas: {pandas.__version__}; the orders cases over "
              f"{min(PANDAS_ORDERS, t['orders'].num_rows)} rows of orders")
        t_pd = dict(t, orders=t["orders"].slice(0, PANDAS_ORDERS))
        for name in PANDAS_CASES:
            exp = expected(name, t_pd)
            got, ctx, ln = _run(C, s, name, t_pd,
                                lambda g, c: "; " + _island(c))
            C.check(got.to_pydict() == exp, f"{name} {got.to_pydict()} "
                    f"differs from numpy {exp}")
            launches[name] = ln
    C.log(f"[udf] phase {time.perf_counter() - t_phase:.1f} s")
    return launches

