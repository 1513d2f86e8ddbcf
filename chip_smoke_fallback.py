"""The fallback phase of chip_smoke.py: the CPU engine and plans that mix
host and card operators.

  (a) cpu_q1 ... cpu_q22 — the 22 TPC-H queries with
      `spark.rapids.tpu.sql.enabled=false` at SF1 (CPU_SCALE), run by the
      port's CPU engine (numpy) in a spawned process that starts with the
      phase, beside the card's work; each equal to the card's result of
      the same query at the same scale in the same run.  When the CPU part
      passes CPU_LIMIT_S seconds, it and the card's side run at CUT_SCALE
      instead, and the cut is printed.
  (b) three plans at SF10 whose placement mixes the engines, each equal
      to an independent numpy result, launching its PATH_KERNELS:
      * fb_concat_groupby — customer's concat(c_mktsegment,
        cast(c_nationkey as string)) on the CPU engine (two non-literal
        operands, a cast to STRING), uploaded (HostToDeviceExec), joined
        on the card with orders and grouped there by that string (125
        groups) into SUM, COUNT(*), MIN and MAX;
      * fb_q16_mix — q16's partsupp / supplier anti join and part join on
        the card, fetched (DeviceToHostExec), grouped by (p_brand,
        p_type, p_size) on the CPU engine into COUNT(DISTINCT
        ps_suppkey) beside SUM(ps_availqty) and MIN(p_container) (a
        string MIN), then sorted on the card;
      * fb_q3_format — q3 on the card (its top-N) under a CPU projection
        that adds cast(o_orderdate as string) and format_number(revenue,
        2).

Run by chip_smoke.py (`fallback_phase`); imports numpy only at module
level.  The tests (tests/test_torch_overrides.py) hand the frames the
JAX package's modules as well.
"""
from __future__ import annotations

import datetime as pydt
import time

import numpy as np

CPU_SCALE = 1.0
CUT_SCALE = 0.1
CPU_LIMIT_S = 120.0
FB_QUERIES = ("fb_concat_groupby", "fb_q16_mix", "fb_q3_format")
#: the logical nodes each fb_* query places on the CPU engine (explain's
#: '!' lines, in order); every other node runs on the card
HOST_NODES = {"fb_concat_groupby": ["Project"],
              "fb_q16_mix": ["Aggregate"],
              "fb_q3_format": ["Project"]}
#: the transitions each fb_* plan holds, top down
TRANSITIONS = {"fb_concat_groupby": ["HostToDeviceExec", "DeviceToHostExec"],
               "fb_q16_mix": ["HostToDeviceExec", "DeviceToHostExec"],
               "fb_q3_format": ["DeviceToHostExec"]}
#: the columns each fb_* query reads, by table (chip_smoke keeps them
#: from the TPC-H tables for this phase)
TABLE_COLUMNS = {
    "customer": ("c_custkey", "c_mktsegment", "c_nationkey"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
               "o_totalprice"),
    "lineitem": ("l_orderkey", "l_extendedprice", "l_discount",
                 "l_shipdate"),
    "part": ("p_partkey", "p_brand", "p_type", "p_size", "p_container"),
    "partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty"),
    "supplier": ("s_suppkey", "s_comment")}
Q3_DATE = pydt.date(1995, 3, 15)
Q16_SIZES = [49, 14, 23, 45, 19, 3, 36, 9]


def _port():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan import strings as S
    from spark_rapids_tpu_torch.session import col
    return T, E, S, A, col


# ---------------------------------------------------------------------------
# The frames, over DataFrames of a package whose modules are handed in
# ---------------------------------------------------------------------------

def concat_groupby_frame(E, S, A, T, col, customer, orders):
    key = S.Concat(col("c_mktsegment"),
                   E.Cast(col("c_nationkey"), T.STRING))
    cust = customer.select(col("c_custkey"), E.Alias(key, "seg_nation"))
    j = orders.join(cust, left_on=["o_custkey"], right_on=["c_custkey"])
    return (j.group_by("seg_nation")
            .agg((A.Sum(col("o_totalprice")), "revenue"),
                 (A.Count(None), "orders"),
                 (A.Min(col("o_orderdate")), "first_order"),
                 (A.Max(col("o_totalprice")), "max_price"))
            .sort("seg_nation"))


def q16_mix_frame(E, S, A, T, col, partsupp, part, supplier):
    complaints = E.And(S.Contains(col("s_comment"), "Customer"),
                       S.Contains(col("s_comment"), "Complaints"))
    bad_supp = supplier.filter(complaints)
    p = part.filter(
        E.And(E.Not(E.EqualTo(col("p_brand"), E.Literal("Brand#45"))),
              E.And(E.Not(S.StartsWith(col("p_type"), "MEDIUM POLISHED")),
                    E.In(E.Cast(col("p_size"), T.INT), Q16_SIZES))))
    ps = (partsupp.join(bad_supp, how="left_anti", left_on=["ps_suppkey"],
                        right_on=["s_suppkey"])
          .join(p, left_on=["ps_partkey"], right_on=["p_partkey"]))
    return (ps.group_by("p_brand", "p_type", "p_size")
            .agg((A.CountDistinct(col("ps_suppkey")), "supplier_cnt"),
                 (A.Sum(col("ps_availqty")), "availqty"),
                 (A.Min(col("p_container")), "min_container"))
            .sort(("supplier_cnt", False, False), ("p_brand", True, True),
                  ("p_type", True, True), ("p_size", True, True)))


def q3_format_frame(E, S, A, T, col, customer, orders, lineitem):
    cust = customer.filter(E.EqualTo(col("c_mktsegment"),
                                     E.Literal("BUILDING")))
    o = orders.filter(E.LessThan(col("o_orderdate"), E.Literal(Q3_DATE)))
    li = lineitem.filter(E.GreaterThan(col("l_shipdate"),
                                       E.Literal(Q3_DATE)))
    j = cust.join(o, left_on=["c_custkey"], right_on=["o_custkey"]) \
        .join(li, left_on=["o_orderkey"], right_on=["l_orderkey"])
    revenue = E.Multiply(col("l_extendedprice"),
                         E.Subtract(E.Literal(1), col("l_discount")))
    top = (j.group_by("o_orderkey", "o_orderdate", "o_shippriority")
           .agg((A.Sum(revenue), "revenue"))
           .sort(("revenue", False, False), ("o_orderdate", True, True))
           .limit(10))
    return top.select(col("o_orderkey"),
                      E.Alias(E.Cast(col("o_orderdate"), T.STRING),
                              "orderdate"),
                      col("o_shippriority"), col("revenue"),
                      E.Alias(S.FormatNumber(col("revenue"), 2),
                              "revenue_text"))


def frame(name: str, s, t, modules=None):
    """An fb_* query over the tables `t` through session `s` (the port's
    modules unless `modules` = (T, E, S, A, col) says otherwise)."""
    T, E, S, A, col = modules or _port()
    src = {n: (s.from_arrow if hasattr(t[n], "column_names")
               else s.from_host)(t[n]) for n in TABLE_COLUMNS if n in t}
    if name == "fb_concat_groupby":
        return concat_groupby_frame(E, S, A, T, col, src["customer"],
                                    src["orders"])
    if name == "fb_q16_mix":
        return q16_mix_frame(E, S, A, T, col, src["partsupp"], src["part"],
                             src["supplier"])
    if name == "fb_q3_format":
        return q3_format_frame(E, S, A, T, col, src["customer"],
                               src["orders"], src["lineitem"])
    raise KeyError(name)


def narrow(tables) -> dict:
    """The columns of TABLE_COLUMNS of each TPC-H table (HostBatches)."""
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def placement_errors(name: str, explain: str, tree: str,
                     host_nodes=None, transitions=None) -> list:
    """What differs from the stated placement (HOST_NODES, TRANSITIONS
    unless given): the explain lines' '!' nodes, every other line '*',
    and the transitions of the physical tree, top down."""
    host_nodes = HOST_NODES if host_nodes is None else host_nodes
    transitions = TRANSITIONS if transitions is None else transitions
    errors = []
    host = [line.strip()[1:].split(">")[0].replace("Exec <", "")
            for line in explain.splitlines() if line.strip().startswith("!")]
    if host != host_nodes[name]:
        errors.append(f"CPU nodes {host}, stated {host_nodes[name]}")
    if any(not line.strip().startswith(("*", "!"))
           for line in explain.splitlines() if line.strip()):
        errors.append("an explain line is neither '*' nor '!'")
    trans = [line.strip() for line in tree.splitlines()
             if line.strip() in ("HostToDeviceExec", "DeviceToHostExec")]
    if trans != transitions[name]:
        errors.append(f"transitions {trans}, stated {transitions[name]}")
    return errors


# ---------------------------------------------------------------------------
# numpy results (independent of the port)
# ---------------------------------------------------------------------------

def _col(hb, name):
    return hb.column_by_name(name)


def _rows_by_key(keys: np.ndarray, probe: np.ndarray):
    """(row of `keys` holding each probe value, found mask)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    pos = np.clip(np.searchsorted(sk, probe), 0, max(len(sk) - 1, 0))
    found = sk[pos] == probe if len(sk) else np.zeros(len(probe), bool)
    return order[pos], found


def expected_concat_groupby(t) -> dict:
    cust, orders = t["customer"], t["orders"]
    seg = _col(cust, "c_mktsegment")
    nation = _col(cust, "c_nationkey").data.astype(np.int64)
    crow, found = _rows_by_key(_col(cust, "c_custkey").data,
                               _col(orders, "o_custkey").data)
    crow = crow[found]
    combo = seg.data[crow].astype(np.int64) * (1 << 20) + nation[crow]
    keys, gid = np.unique(combo, return_inverse=True)
    text = np.array([str(seg.dictionary[k >> 20]) + str(k & ((1 << 20) - 1))
                     for k in keys.tolist()])
    rank = np.argsort(text, kind="stable")
    price = _col(orders, "o_totalprice").data[found]
    date = _col(orders, "o_orderdate").data[found]
    n = len(keys)
    revenue = np.zeros(n, np.int64)
    np.add.at(revenue, gid, price)
    first = np.full(n, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(first, gid, date)
    top = np.full(n, np.iinfo(np.int64).min, np.int64)
    np.maximum.at(top, gid, price)
    return {"seg_nation": text[rank].tolist(),
            "revenue": revenue[rank].tolist(),
            "orders": np.bincount(gid, minlength=n)[rank].tolist(),
            "first_order": first[rank].tolist(),
            "max_price": top[rank].tolist()}


def expected_q16_mix(t) -> dict:
    supp, part, ps = t["supplier"], t["part"], t["partsupp"]
    comment = _col(supp, "s_comment")
    d = comment.dictionary
    bad_entry = (np.char.find(d, "Customer") >= 0) & \
        (np.char.find(d, "Complaints") >= 0)
    bad_keys = _col(supp, "s_suppkey").data[bad_entry[comment.data]]
    brand, ptype = _col(part, "p_brand"), _col(part, "p_type")
    cont = _col(part, "p_container")
    size = _col(part, "p_size").data.astype(np.int64)
    keep = (brand.dictionary[brand.data] != "Brand#45") & \
        ~np.char.startswith(ptype.dictionary, "MEDIUM POLISHED")[
            ptype.data] & np.isin(size, Q16_SIZES)
    sk = _col(ps, "ps_suppkey").data
    prow, found = _rows_by_key(_col(part, "p_partkey").data,
                               _col(ps, "ps_partkey").data)
    rows = np.flatnonzero(found & ~np.isin(sk, bad_keys))
    rows = rows[keep[prow[rows]]]
    p = prow[rows]
    nt = len(ptype.dictionary)
    group = (brand.data[p].astype(np.int64) * nt + ptype.data[p]) * 128 + \
        size[p]
    keys, gid = np.unique(group, return_inverse=True)
    n = len(keys)
    pairs = np.unique(gid.astype(np.int64) * (int(sk.max()) + 1 if len(sk)
                                              else 1) + sk[rows])
    per = int(sk.max()) + 1 if len(sk) else 1
    distinct = np.bincount(pairs // per, minlength=n)
    avail = np.zeros(n, np.int64)
    np.add.at(avail, gid, _col(ps, "ps_availqty").data[rows])
    mincont = np.full(n, len(cont.dictionary), np.int64)
    np.minimum.at(mincont, gid, cont.data[p])
    b, ty, sz = keys // 128 // nt, keys // 128 % nt, keys % 128
    rank = np.lexsort((sz, ty, b, -distinct))
    return {"p_brand": [str(v) for v in brand.dictionary[b[rank]]],
            "p_type": [str(v) for v in ptype.dictionary[ty[rank]]],
            "p_size": sz[rank].tolist(),
            "supplier_cnt": distinct[rank].tolist(),
            "availqty": avail[rank].tolist(),
            "min_container": [str(v) for v in
                              cont.dictionary[mincont[rank]]]}


def format_number_2(unscaled: int, scale: int) -> str:
    """format_number(x, 2) of a decimal's unscaled value: HALF_EVEN to
    two places, thousands separated by commas."""
    import decimal as pydec
    q = pydec.Decimal(unscaled).scaleb(-scale).quantize(
        pydec.Decimal("0.01"), rounding=pydec.ROUND_HALF_EVEN)
    return f"{q:,.2f}"


def expected_q3_format(q3_lanes: dict) -> dict:
    """fb_q3_format's columns from q3's (o_orderkey, o_orderdate days,
    o_shippriority, revenue unscaled at scale 4)."""
    epoch = pydt.date(1970, 1, 1)
    return {"o_orderkey": q3_lanes["o_orderkey"],
            "orderdate": [(epoch + pydt.timedelta(days=int(d))).isoformat()
                          for d in q3_lanes["o_orderdate"]],
            "o_shippriority": q3_lanes["o_shippriority"],
            "revenue": q3_lanes["revenue"],
            "revenue_text": [format_number_2(int(r), 4)
                             for r in q3_lanes["revenue"]]}


# ---------------------------------------------------------------------------
# (a): the CPU engine in a process of its own
# ---------------------------------------------------------------------------

def cpu_engine_queries(scale: float, seed: int, limit_s: float):
    """The 22 TPC-H queries with sql.enabled=false at `scale`, run in
    order until their summed walls pass `limit_s`: ({query: (result,
    wall seconds)}, seconds generating the tables, completed)."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.session import TpuSession
    t0 = time.perf_counter()
    tables = tpch.gen_tables(scale, seed)
    gen_s = time.perf_counter() - t0
    cpu = TpuSession({"spark.rapids.tpu.sql.enabled": "false"},
                     device="cpu")
    out, spent = {}, 0.0
    for name in sorted(tpch.QUERIES, key=lambda q: int(q[1:])):
        q = tpch.QUERIES[name](cpu, tables).physical()
        if q.kind != "host":
            raise AssertionError(f"cpu_{name} did not run on the CPU engine")
        t0 = time.perf_counter()
        res = q.collect()
        wall = time.perf_counter() - t0
        out[name] = (res, wall)
        spent += wall
        if spent > limit_s:
            return out, gen_s, False
    return out, gen_s, True


def results_equal(a, b, rtol: float = 1e-9) -> str:
    """'' when two HostBatches hold equal rows (DOUBLE columns within
    rtol, every other value exactly), in order or, where tied sort keys
    leave the order open, as multisets; else what differs."""
    if a.names != b.names or a.num_rows != b.num_rows:
        return f"{a.names} x {a.num_rows} rows against {b.names} x " \
               f"{b.num_rows}"

    def close(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return x == y or (x != x and y != y) or \
                abs(x - y) <= rtol * max(abs(x), abs(y))
        return x == y

    ra = list(zip(*(c.to_pylist() for c in a.columns)))
    rb = list(zip(*(c.to_pylist() for c in b.columns)))
    if all(close(x, y) for r, s in zip(ra, rb) for x, y in zip(r, s)):
        return ""
    key = lambda r: tuple((v is None, str(v)) for v in r)   # noqa: E731
    sa, sb = sorted(ra, key=key), sorted(rb, key=key)
    if all(close(x, y) for r, s in zip(sa, sb) for x, y in zip(r, s)):
        return ""
    bad = next(i for i, (r, s) in enumerate(zip(ra, rb))
               if not all(close(x, y) for x, y in zip(r, s)))
    return f"row {bad}: {ra[bad]} against {rb[bad]}"


# ---------------------------------------------------------------------------
# The phase
# ---------------------------------------------------------------------------

def fallback_phase(C, fb_tables, seed: int) -> dict:
    """The fallback phase; `C` is the chip_smoke module (its log, check
    and timing helpers), `fb_tables` the narrowed TPC-H SF10 tables.
    -> {query: launches}."""
    import concurrent.futures
    import multiprocessing
    import torch
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.exec.host_exec import host_profile
    t_phase = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    cpu_job = pool.submit(cpu_engine_queries, CPU_SCALE, seed, CPU_LIMIT_S)
    s = C._cuda_session()
    launches = {}

    # (b) mixed placements at SF10, while the CPU engine runs (a)
    want = {"fb_concat_groupby": expected_concat_groupby(fb_tables),
            "fb_q16_mix": expected_q16_mix(fb_tables)}
    q3_top = C.expected_q3(fb_tables)
    for name in FB_QUERIES:
        df = frame(name, s, fb_tables)
        q = df.physical()
        explain, tree = q.explain(), q.physical_tree()
        for line in explain.splitlines():
            C.log(f"[fallback] {name} explain: {line}")
        errors = placement_errors(name, explain, tree)
        C.check(not errors, f"{name} placement: {errors}")
        got, ctx, cold, warm, peak, launches[name] = C._timed(
            s, lambda sess, t, n=name: frame(n, sess, t), fb_tables)
        lanes = C.lanes_of(got)
        if name == "fb_q3_format":
            q3_part = {k: lanes[k] for k in ("o_orderkey", "o_orderdate",
                                             "o_shippriority", "revenue")
                       if k in lanes}
            q3_part["o_orderdate"] = [
                (pydt.date.fromisoformat(d) - pydt.date(1970, 1, 1)).days
                for d in lanes["orderdate"]]
            C.check_top(name, q3_part, q3_top)
            exp = expected_q3_format(q3_part)
            C.check(lanes == exp, f"{name} differs from numpy:\n{lanes}\n"
                    f"{exp}")
        else:
            C.check(lanes == want[name], f"{name} differs from numpy:\n"
                    f"{lanes}\n{want[name]}")
        C._check_launches(name, launches[name])
        prof = host_profile(ctx)
        ops = {k.split("#")[0]: round(v * 1e3, 1) for k, v in prof.items()
               if "#" in k}
        C._query_log(name, got.num_rows, cold, warm, peak, launches[name],
                     f"; CPU operators ms {ops}; upload "
                     f"{prof['h2d_bytes']} B in {prof['h2d_s'] * 1e3:.1f} "
                     f"ms, fetch {prof['d2h_bytes']} B in "
                     f"{prof['d2h_s'] * 1e3:.1f} ms (the cold run)",
                     tag="fallback")

    # (a) the card's side: the 22 queries at the CPU engine's scale
    scale = CPU_SCALE
    res, gen_s, complete = cpu_job.result()
    if not complete:
        C.log(f"[fallback] CUT: the CPU engine passed {CPU_LIMIT_S:.0f} s "
              f"at SF{CPU_SCALE:g}; part (a) runs at SF{CUT_SCALE:g}")
        scale = CUT_SCALE
        res, gen_s, complete = pool.submit(
            cpu_engine_queries, scale, seed, float("inf")).result()
    pool.shutdown()
    tables = tpch.gen_tables(scale, seed)
    cpu_total = dev_total = 0.0
    for name in sorted(tpch.QUERIES, key=lambda q: int(q[1:])):
        cpu_res, cpu_wall = res[name]
        got, _ctx, cold, warm, _peak, _l = C._timed(
            s, tpch.QUERIES[name], tables, reps=1)
        msg = results_equal(cpu_res, got)
        C.check(not msg, f"cpu_{name} differs from the card's {name}: {msg}")
        cpu_total += cpu_wall
        dev_total += warm / 1e3
        C.log(f"[fallback] cpu_{name}: {got.num_rows} rows equal the card's "
              f"at SF{scale:g}; CPU engine {cpu_wall * 1e3:.1f} ms, card "
              f"cold {cold:.1f} ms, warm {warm:.1f} ms; CPU / card warm "
              f"{cpu_wall * 1e3 / max(warm, 1e-9):.1f}")
    C.log(f"[fallback] cpu_q1..q22 at SF{scale:g}: CPU engine "
          f"{cpu_total:.1f} s in all (its tables {gen_s:.1f} s, in its own "
          f"process), the card's warm walls {dev_total:.2f} s; ratio "
          f"{cpu_total / max(dev_total, 1e-9):.1f}")
    del tables
    torch.cuda.empty_cache()
    C.log(f"[fallback] phase body {time.perf_counter() - t_phase:.1f} s")
    return launches
