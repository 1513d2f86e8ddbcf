"""The nested phase of chip_smoke.py: ARRAY columns and the holistic
aggregates on the card, at SF10 on the data phase's TPC-H columns.

Cases (each a cold run and 3 warm runs through TpuSession() on cuda,
printing its walls, the peak device memory, the plan's exec names, its
kernel launches and, for a ragged output, its values lane's bytes):

  * pct_q1: lineitem with l_shipdate <= 1998-09-02 grouped by
    (l_returnflag, l_linestatus): percentile(l_quantity, 0.25),
    median(l_extendedprice), percentile(l_discount, 0.9) through
    PercentileAggregateExec; each value within 4 ulps of numpy's exact
    lerp;
  * approx_q1: the same groups, and the global form, with
    approx_percentile(l_extendedprice, 0.5) and (..., 0.99) over every
    lineitem batch (the sketched PARTIAL/FINAL path): each answer's rank
    in its group's sorted values within count x 2 / (2 (K - 1)) of
    q x (count - 1), two merge levels at K = 129;
  * collect_q3: q3's join (BUILDING customers, orders before 1995-03-15,
    lineitem after) grouped by l_orderkey with collect_list(l_partkey)
    and collect_set(l_shipmode) through CollectAggregateExec; a device
    projection applies size, sort_array, element_at(sort_array, 1) and
    array_max to the list, and a projection on the CPU engine
    array_contains(set, 'MAIL') (an ARRAY<STRING> input: the reference
    places it there); equal to numpy, sets compared sorted;
  * explode_q3: collect_q3's sets exploded by GenerateExec, grouped by
    the element with a COUNT, equal to numpy's count over the join; its
    posexplode form grouped by pos; and explode_q3 once more under
    `sql.compile.wholePlan=ON`, printing its decision, equal to eager;
  * collect_sf10: collect_list(l_partkey) grouped by l_suppkey over every
    lineitem row (100,000 lists, a 60M-value ragged lane): each group's
    size equal to numpy's count, and an order-free digest of its values
    (the wrapping sum of splitmix64 of each) equal to numpy's.

The numpy results (`WANTS`, `expected`) are computed in the data phase's
fork pool, before the card is used.  The phase fails when a case
differs, or when a case's kernels (chip_smoke.PATH_KERNELS) were not
launched.  Imports torch only at module level.
"""
from __future__ import annotations

import datetime as pydt
import time

import numpy as np
import torch

#: the TPC-H columns the phase reads (chip_smoke keeps them from the data
#: phase)
TABLE_COLUMNS = {
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                 "l_extendedprice", "l_discount", "l_returnflag",
                 "l_linestatus", "l_shipdate", "l_shipmode"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
    "customer": ("c_custkey", "c_mktsegment"),
}
CASES = ("pct_q1", "approx_q1", "approx_global", "collect_q3",
         "explode_q3", "posexplode_q3", "collect_sf10")
#: the numpy results the data phase's pool computes
WANTS = ("nested pct_q1", "nested approx_q1", "nested collect_q3",
         "nested collect_sf10")
#: the percentage of each pct_q1 output
PCT = (("p_qty", "l_quantity", 0.25), ("med_price", "l_extendedprice", 0.5),
       ("p_disc", "l_discount", 0.9))
APPROX_Q = (("a50", 0.5), ("a99", 0.99))
SKETCH_K = 129
Q1_CUTOFF = (pydt.date(1998, 9, 2) - pydt.date(1970, 1, 1)).days
Q3_DATE = (pydt.date(1995, 3, 15) - pydt.date(1970, 1, 1)).days
ULPS = 4


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


# ---------------------------------------------------------------------------
# the queries (the port's DataFrame API)
# ---------------------------------------------------------------------------

def _col(name):
    from spark_rapids_tpu_torch.session import col
    return col(name)


def pct_q1(s, t):
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch import types as T
    li = s.from_host(t["lineitem"]).filter(E.LessThanOrEqual(
        _col("l_shipdate"), E.Literal(Q1_CUTOFF, T.DATE)))
    return li.group_by("l_returnflag", "l_linestatus").agg(
        *[(A.Median(_col(c)) if q == 0.5 else A.Percentile(_col(c), q), n)
          for n, c, q in PCT])


def approx_q1(s, t, keys=("l_returnflag", "l_linestatus")):
    from spark_rapids_tpu_torch.plan import aggregates as A
    df = s.from_host(t["lineitem"])
    if keys:
        df = df.group_by(*keys)
    return df.agg(*[(A.ApproximatePercentile(_col("l_extendedprice"), q), n)
                    for n, q in APPROX_Q])


def approx_global(s, t):
    return approx_q1(s, t, keys=())


def _q3_join(s, t):
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch import types as T
    date = E.Literal(Q3_DATE, T.DATE)
    cust = s.from_host(t["customer"]).filter(
        E.EqualTo(_col("c_mktsegment"), E.Literal("BUILDING")))
    orders = s.from_host(t["orders"]).filter(
        E.LessThan(_col("o_orderdate"), date))
    li = s.from_host(t["lineitem"]).filter(
        E.GreaterThan(_col("l_shipdate"), date))
    return cust.join(orders, left_on=["c_custkey"],
                     right_on=["o_custkey"]) \
        .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])


def _q3_collect(s, t):
    from spark_rapids_tpu_torch.plan import aggregates as A
    return _q3_join(s, t).group_by("l_orderkey").agg(
        (A.CollectList(_col("l_partkey")), "parts"),
        (A.CollectSet(_col("l_shipmode")), "modes"))


def collect_q3(s, t):
    from spark_rapids_tpu_torch.plan import collections as C
    g = _q3_collect(s, t)
    sorted_parts = C.SortArray(_col("parts"))
    dev = g.select(_col("l_orderkey"), C.Size(_col("parts")), sorted_parts,
                   C.ElementAt(C.SortArray(_col("parts")), 1),
                   C.ArrayMax(_col("parts")), _col("modes"),
                   names=["l_orderkey", "n", "sorted", "first", "mx",
                          "modes"])
    return dev.select(*[_col(n) for n in ("l_orderkey", "n", "sorted",
                                          "first", "mx", "modes")],
                      C.ArrayContains(_col("modes"), "MAIL"),
                      names=["l_orderkey", "n", "sorted", "first", "mx",
                             "modes", "mail"])


def _exploded(s, t, pos: bool):
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import collections as C
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.session import DataFrame
    g = _q3_collect(s, t).select(_col("l_orderkey"), _col("modes"),
                                 names=["l_orderkey", "modes"])
    names = ["pos", "mode"] if pos else ["mode"]
    gen = L.LogicalGenerate(C.ExplodeGen(E.ColumnRef("modes"), pos=pos),
                            g._plan, names)
    key = names[0]
    proj = L.LogicalProject([E.ColumnRef(key)], gen, [key])
    return DataFrame(proj, s).group_by(key).agg((A.Count(None), "n"))


def explode_q3(s, t):
    return _exploded(s, t, pos=False)


def posexplode_q3(s, t):
    return _exploded(s, t, pos=True)


def collect_sf10(s, t):
    from spark_rapids_tpu_torch.plan import aggregates as A
    return s.from_host(t["lineitem"]).group_by("l_suppkey").agg(
        (A.CollectList(_col("l_partkey")), "parts"))


BUILDS = {"pct_q1": pct_q1, "approx_q1": approx_q1,
          "approx_global": approx_global, "collect_q3": collect_q3,
          "explode_q3": explode_q3, "posexplode_q3": posexplode_q3,
          "collect_sf10": collect_sf10}


# ---------------------------------------------------------------------------
# numpy results
# ---------------------------------------------------------------------------

def _strings(c) -> np.ndarray:
    return np.asarray(c.dictionary)[c.data]


def mix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over int64 values, as uint64."""
    x = x.astype(np.int64).view(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _order_stats(v: np.ndarray, ranks) -> dict:
    """{rank: the rank-th smallest of v} by one partition."""
    ranks = sorted(set(int(r) for r in ranks))
    part = np.partition(v, ranks)
    return {r: float(part[r]) for r in ranks}


def _lerp(v: np.ndarray, q: float) -> float:
    """Spark's exact percentile, as the device computes it."""
    n = len(v)
    pos = (n - 1) * q
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    st = _order_stats(v, (lo, hi))
    frac = pos - lo
    return st[lo] if frac == 0.0 else st[lo] + (st[hi] - st[lo]) * frac


def _q1_groups(li, mask=None):
    """{(returnflag, linestatus): row indices}."""
    rf, ls = _strings(li.column_by_name("l_returnflag")), \
        _strings(li.column_by_name("l_linestatus"))
    code = li.column_by_name("l_returnflag").data.astype(np.int64) * 64 + \
        li.column_by_name("l_linestatus").data
    if mask is not None:
        idx = np.flatnonzero(mask)
    else:
        idx = np.arange(len(code))
    out = {}
    order = idx[np.argsort(code[idx], kind="stable")]
    cuts = np.flatnonzero(np.diff(code[order])) + 1
    for part in np.split(order, cuts):
        if len(part):
            out[(str(rf[part[0]]), str(ls[part[0]]))] = part
    return out


def _money(li, name) -> np.ndarray:
    return li.column_by_name(name).data.astype(np.float64) / 100.0


def expected(name: str, tables):
    li = tables["lineitem"]
    if name == "nested pct_q1":
        groups = _q1_groups(li, li.column_by_name("l_shipdate").data <=
                            Q1_CUTOFF)
        vals = {c: _money(li, c) for _n, c, _q in PCT}
        return {k: {n: _lerp(vals[c][rows], q) for n, c, q in PCT}
                for k, rows in groups.items()}
    if name == "nested approx_q1":
        price = _money(li, "l_extendedprice")
        groups = _q1_groups(li)
        groups[()] = np.arange(li.num_rows)
        out = {}
        for k, rows in groups.items():
            v = price[rows]
            n = len(v)
            tol = n * 2 / (2 * (SKETCH_K - 1))
            bounds = {}
            for col, q in APPROX_Q:
                lo = max(0, int(np.floor(q * (n - 1) - tol)))
                hi = min(n - 1, int(np.ceil(q * (n - 1) + tol)))
                st = _order_stats(v, (lo, hi))
                bounds[col] = (st[lo], st[hi])
            out[k] = (n, bounds)
        return out
    if name == "nested collect_q3":
        cust, orders = tables["customer"], tables["orders"]
        seg = _strings(cust.column_by_name("c_mktsegment"))
        custs = cust.column_by_name("c_custkey").data[seg == "BUILDING"]
        o_ok = np.isin(orders.column_by_name("o_custkey").data, custs) & \
            (orders.column_by_name("o_orderdate").data < Q3_DATE)
        okeys = orders.column_by_name("o_orderkey").data[o_ok]
        lk = li.column_by_name("l_orderkey").data
        rows = np.flatnonzero(np.isin(lk, okeys) &
                              (li.column_by_name("l_shipdate").data >
                               Q3_DATE))
        keys = lk[rows]
        parts = li.column_by_name("l_partkey").data[rows]
        modes = _strings(li.column_by_name("l_shipmode"))[rows]
        order = np.lexsort((parts, keys))
        keys, parts, modes = keys[order], parts[order], modes[order]
        cuts = np.flatnonzero(np.diff(keys)) + 1
        out = {}
        for ks, ps, ms in zip(np.split(keys, cuts), np.split(parts, cuts),
                              np.split(modes, cuts)):
            out[int(ks[0])] = (ps.tolist(), sorted(set(ms.tolist())))
        return out
    if name == "nested collect_sf10":
        supp = li.column_by_name("l_suppkey").data
        parts = li.column_by_name("l_partkey").data
        order = np.argsort(supp, kind="stable")
        s_supp = supp[order]
        starts = np.flatnonzero(np.r_[True, s_supp[1:] != s_supp[:-1]])
        counts = np.diff(np.r_[starts, len(s_supp)])
        digest = np.add.reduceat(mix64(parts[order]), starts)
        return s_supp[starts], counts, digest
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _ulps_close(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return abs(a - b) <= ULPS * np.spacing(max(abs(a), abs(b)))


def _check_pct(C, got, want):
    d = got.to_pydict()
    seen = {}
    for i in range(got.num_rows):
        k = (d["l_returnflag"][i], d["l_linestatus"][i])
        seen[k] = {n: d[n][i] for n, _c, _q in PCT}
    C.check(set(seen) == set(want), f"pct_q1 groups {sorted(seen)} against "
            f"{sorted(want)}")
    for k, vals in want.items():
        for n, w in vals.items():
            C.check(_ulps_close(seen[k][n], w), f"pct_q1 {k} {n}: "
                    f"{seen[k][n]!r} against numpy {w!r} (> {ULPS} ulps)")


def _check_approx(C, name, got, want):
    d = got.to_pydict()
    keys = [()] if name == "approx_global" else [
        (d["l_returnflag"][i], d["l_linestatus"][i])
        for i in range(got.num_rows)]
    C.check(len(keys) == got.num_rows and set(keys) <= set(want),
            f"{name} groups {keys}")
    if name == "approx_q1":
        C.check(set(keys) == set(want) - {()}, f"{name} groups {keys}")
    for i, k in enumerate(keys):
        _n, bounds = want[k]
        for col, q in APPROX_Q:
            lo, hi = bounds[col]
            v = d[col][i]
            C.check(v is not None and lo <= v <= hi, f"{name} {k} {col}: "
                    f"{v!r} outside the rank window [{lo!r}, {hi!r}]")


def _check_collect_q3(C, got, want):
    d = got.to_pydict()
    C.check(got.num_rows == len(want), f"collect_q3 {got.num_rows} orders "
            f"against numpy {len(want)}")
    for i, k in enumerate(d["l_orderkey"]):
        parts, modes = want[k]
        row = (d["n"][i], d["sorted"][i], d["first"][i], d["mx"][i],
               sorted(d["modes"][i]), d["mail"][i])
        C.check(row == (len(parts), parts, parts[0], parts[-1], modes,
                        "MAIL" in modes),
                f"collect_q3 order {k}: {row} against numpy "
                f"{(parts, modes)}")


def _check_explode(C, name, got, want):
    counts: dict = {}
    for parts, modes in want.values():
        for p, m in enumerate(modes):
            key = p if name == "posexplode_q3" else m
            counts[key] = counts.get(key, 0) + 1
    d = got.to_pydict()
    key = "pos" if name == "posexplode_q3" else "mode"
    seen = dict(zip(d[key], d["n"]))
    C.check(seen == counts, f"{name}: {seen} against numpy {counts}")


def _check_collect_sf10(C, got, want):
    keys, counts, digest = want
    order = np.argsort(got.columns[0].data, kind="stable")
    col = got.columns[1]
    C.check(np.array_equal(got.columns[0].data[order], keys),
            "collect_sf10 supplier keys differ from numpy")
    off = col.offsets.astype(np.int64)
    sizes = np.diff(off)
    C.check(np.array_equal(sizes[order], counts),
            "collect_sf10 list sizes differ from numpy's counts")
    C.check(col.elem_valid is None or bool(col.elem_valid.all()),
            "collect_sf10 holds a null element")
    C.check(bool((sizes > 0).all()), "collect_sf10 holds an empty list")
    got_digest = np.add.reduceat(mix64(col.data), off[:-1])
    C.check(np.array_equal(got_digest[order], digest),
            "collect_sf10 value digests differ from numpy")


def _session(conf=None):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(conf)


def nested_phase(C, tables, want) -> dict:
    """Every case on the card; -> launches by case."""
    from spark_rapids_tpu_torch.exec import compiled as CP
    s = _session()
    launches = {}
    t_phase = time.perf_counter()
    eager_explode = None
    for name in CASES:
        got, ctx, cold, warm, peak, ln = C._timed(s, BUILDS[name], tables)
        q = BUILDS[name](s, tables).physical()
        execs = sorted({type(n).__name__ for n in _walk(q.root)})
        ragged = [c for c in got.columns if c.offsets is not None]
        extra = ""
        if ragged:
            extra = "; ragged value lanes " + ", ".join(
                f"{n} {len(c.data)} values ({c.data.nbytes} bytes on the "
                f"host)" for n, c in zip(got.names, got.columns)
                if c.offsets is not None)
        if name == "pct_q1":
            _check_pct(C, got, want["nested pct_q1"])
        elif name in ("approx_q1", "approx_global"):
            _check_approx(C, name, got, want["nested approx_q1"])
        elif name == "collect_q3":
            _check_collect_q3(C, got, want["nested collect_q3"])
        elif name in ("explode_q3", "posexplode_q3"):
            _check_explode(C, name, got, want["nested collect_q3"])
            if name == "explode_q3":
                eager_explode = got.to_pydict()
        else:
            _check_collect_sf10(C, got, want["nested collect_sf10"])
        C._check_launches(name, ln)
        launches[name] = ln
        C._query_log(name, got.num_rows, cold, warm, peak, ln,
                     f"; execs {execs}{extra}", tag="nested")
    # explode_q3 under whole-plan capture: its decision, equal to eager
    CP.clear_caches()
    on = _session({"spark.rapids.tpu.sql.compile.wholePlan": "ON"})
    q = explode_q3(on, tables).physical()
    t0 = time.perf_counter()
    got = q.collect()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    C.check(got.to_pydict() == eager_explode,
            "explode_q3 under wholePlan=ON differs from eager")
    C.log(f"[nested] explode_q3 wholePlan=ON: decision {CP.decision(q)}; "
          f"{ms:.1f} ms, equal to eager")
    C.log(f"[nested] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _walk(node):
    yield node
    for c in getattr(node, "children", ()):
        yield from _walk(c)
    for c in (getattr(node, "device_child", None),
              getattr(node, "host_child", None)):
        if c is not None:
            yield from _walk(c)
