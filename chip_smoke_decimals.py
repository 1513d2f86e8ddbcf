"""The decimals phase of chip_smoke.py: the wide decimal lane, the CPU
window operator and the aggregate-twin CSE at SF10.

  * dec_q1 — TPC-H q1: its DECIMAL sums and averages (result types
    DECIMAL(22,2) ... DECIMAL(34,6)) run as two 32-bit half lanes each
    through `seg_sums`; equal to numpy; its `seg_sums` lane tiles beside
    the one-lane count of earlier trees (Q1_OLD_TILES).
  * dec_wrap — SUM and AVG of CAST(l_extendedprice AS DECIMAL(18,8)) over
    all of lineitem by (l_returnflag, l_linestatus): DECIMAL(28,8) sums
    of about 5.7e19 unscaled units, past 2^63, where one int64 lane
    wraps; equal to numpy's Python-int sums.
  * dec_rank — per-supplier revenue SUM(l_extendedprice * (1 -
    l_discount)) (100,000 groups, DECIMAL(36,4)) on the card, fetched
    (DeviceToHostExec), ranked by RANK() OVER (ORDER BY revenue DESC) on
    the CPU engine (CpuWindowExec: a decimal128 order key, which the
    reference places on its CPU too).
  * dec_ds_window — TPC-DS q98 with its window function disabled
    (`spark.rapids.tpu.sql.expression.WinSum=false`): the card joins and
    aggregates, CpuWindowExec takes the class totals, the card projects,
    sorts and limits; equal to the tpcds phase's numpy result.  It runs
    while the TPC-DS tables are loaded (`ds_window_phase`).
  * cse_q15 — TPC-H q15, whose revenue view the CSE shares: the view's
    aggregate runs once, its group-by calls halved against the same
    plan with the sharing switched off, in the same run.

Each query prints its cold wall, the median of 3 warm walls, its peak,
its launches, its CPU operators' ms and each transition's bytes and ms,
and holds its placement to the stated one from its explain lines and
physical tree.  Imports numpy only at module level.
"""
from __future__ import annotations

import time

import numpy as np

DEC_QUERIES = ("dec_q1", "dec_wrap", "dec_rank", "cse_q15")
#: q1's seg_sums lane tiles with one int64 lane a DECIMAL sum (the
#: launches-by-query table of PERF.md before the half lanes)
Q1_OLD_TILES = 16
#: the logical nodes each query places on the CPU engine (explain's '!'
#: lines, in order) and the transitions of its physical tree, top down
HOST_NODES = {"dec_q1": [], "dec_wrap": [], "dec_rank": ["Window"],
              "dec_ds_window": ["Window"], "cse_q15": []}
TRANSITIONS = {"dec_q1": [], "dec_wrap": [], "dec_rank": ["DeviceToHostExec"],
               "dec_ds_window": ["HostToDeviceExec", "DeviceToHostExec"],
               "cse_q15": []}
#: the TPC-H columns the phase reads (chip_smoke keeps them from the data
#: phase)
TABLE_COLUMNS = {
    "lineitem": ("l_suppkey", "l_quantity", "l_extendedprice", "l_discount",
                 "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"),
    "supplier": ("s_suppkey", "s_name", "s_address", "s_phone")}
WRAP_TYPE = (18, 8)


def _port():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan import window as W
    from spark_rapids_tpu_torch.session import col
    return T, E, A, W, col


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


# ---------------------------------------------------------------------------
# The frames
# ---------------------------------------------------------------------------

def wrap_frame(s, t):
    T, E, A, _W, col = _port()
    price = E.Cast(col("l_extendedprice"), T.DecimalType(*WRAP_TYPE))
    return (s.from_host(t["lineitem"])
            .select(col("l_returnflag"), col("l_linestatus"),
                    E.Alias(price, "price"))
            .group_by("l_returnflag", "l_linestatus")
            .agg((A.Sum(col("price")), "sum_price"),
                 (A.Average(col("price")), "avg_price"))
            .sort("l_returnflag", "l_linestatus"))


def rank_frame(s, t):
    T, E, A, W, col = _port()
    revenue = E.Multiply(col("l_extendedprice"),
                         E.Subtract(E.Literal(1), col("l_discount")))
    rev = (s.from_host(t["lineitem"]).group_by("l_suppkey")
           .agg((A.Sum(revenue), "revenue")))
    return rev.window([(W.Rank(), "rnk")],
                      order_by=[("revenue", False, False)])


def frame(name: str, s, t):
    from spark_rapids_tpu_torch import tpch
    if name == "dec_q1":
        return tpch.q1(s, t)
    if name == "dec_wrap":
        return wrap_frame(s, t)
    if name == "dec_rank":
        return rank_frame(s, t)
    return tpch.q15(s, t)


# ---------------------------------------------------------------------------
# numpy results (independent of the port)
# ---------------------------------------------------------------------------

def _col(hb, name):
    return hb.column_by_name(name)


def _half_up(num: int, den: int) -> int:
    mag = (2 * abs(num) + den) // (2 * den)
    return -mag if num < 0 else mag


def expected_wrap(li) -> dict:
    rf, ls = _col(li, "l_returnflag"), _col(li, "l_linestatus")
    nls = len(ls.dictionary)
    key = rf.data.astype(np.int64) * nls + ls.data
    cents = _col(li, "l_extendedprice").data.astype(np.int64)
    counts = np.bincount(key, minlength=len(rf.dictionary) * nls)
    keys = np.flatnonzero(counts)
    sums = {int(k): int(cents[key == k].sum()) for k in keys}
    up = 10 ** (WRAP_TYPE[1] - 2)
    out = {"l_returnflag": [str(rf.dictionary[k // nls]) for k in keys],
           "l_linestatus": [str(ls.dictionary[k % nls]) for k in keys],
           "sum_price": [int(sums[k]) * up for k in keys],
           "avg_price": [_half_up(int(sums[k]) * up * 10 ** 4,
                                  int(counts[k])) for k in keys]}
    return out


def expected_rank(li) -> dict:
    """{suppkey: (revenue at scale 4, rank)} over every supplier."""
    supp = _col(li, "l_suppkey").data.astype(np.int64)
    rev = _col(li, "l_extendedprice").data.astype(np.int64) * \
        (100 - _col(li, "l_discount").data.astype(np.int64))
    # every row's revenue is an integer below 2^31 and each supplier's
    # sum below 2^53, so float64 bincount sums are exact
    keys = np.flatnonzero(np.bincount(supp))
    sums = np.bincount(supp, weights=rev.astype(np.float64))[keys] \
        .astype(np.int64)
    order = np.argsort(-sums, kind="stable")
    srt = sums[order]
    # RANK: one plus the rows strictly ahead
    first = np.searchsorted(-srt, -srt, side="left")
    rank = np.empty(len(keys), np.int64)
    rank[order] = first + 1
    return {"l_suppkey": keys, "revenue": sums, "rnk": rank}


def check_rank(C, got, want) -> None:
    supp = np.asarray(got.column_by_name("l_suppkey").data, np.int64)
    rev = got.column_by_name("revenue")
    rnk = np.asarray(got.column_by_name("rnk").data, np.int64)
    C.check(len(supp) == len(want["l_suppkey"]),
            f"dec_rank: {len(supp)} suppliers, numpy {len(want['l_suppkey'])}")
    order = np.argsort(supp)
    C.check(np.array_equal(supp[order], want["l_suppkey"]),
            "dec_rank: the suppliers differ from numpy")
    vals = np.array([int(v) for v in rev.unscaled()], object)[order]
    C.check(all(int(a) == int(b) for a, b in zip(vals, want["revenue"])),
            "dec_rank: a revenue differs from numpy")
    C.check(np.array_equal(rnk[order], want["rnk"]),
            "dec_rank: a rank differs from numpy")
    C.check(bool(np.all(np.diff(rnk) >= 0)),
            "dec_rank: the rows are not in rank order")


# ---------------------------------------------------------------------------
# The phase
# ---------------------------------------------------------------------------

def _log_query(C, name, got, ctx, cold, warm, peak, launches, extra=""):
    from spark_rapids_tpu_torch.exec.host_exec import host_profile
    prof = host_profile(ctx)
    ops = {k.split("#")[0]: round(v * 1e3, 1) for k, v in prof.items()
           if "#" in k}
    C._query_log(name, got.num_rows, cold, warm, peak, launches,
                 f"{extra}; CPU operators ms {ops}; upload "
                 f"{prof['h2d_bytes']} B in {prof['h2d_s'] * 1e3:.1f} ms, "
                 f"fetch {prof['d2h_bytes']} B in {prof['d2h_s'] * 1e3:.1f} "
                 "ms (the cold run)", tag="decimals")


def _placed(C, name, q):
    from chip_smoke_fallback import placement_errors
    explain, tree = q.explain(), q.physical_tree()
    for line in explain.splitlines():
        C.log(f"[decimals] {name} explain: {line}")
    errors = placement_errors(name, explain, tree, HOST_NODES, TRANSITIONS)
    C.check(not errors, f"{name} placement: {errors}")


def ds_window_phase(C, ds_tables, ds_want) -> dict:
    """dec_ds_window, while the TPC-DS tables are loaded.  -> {query:
    launches}."""
    import chip_smoke_tpcds as D
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.session import TpuSession
    s = TpuSession({"spark.rapids.tpu.sql.expression.WinSum": "false"})
    _placed(C, "dec_ds_window", tpcds.q98(s, ds_tables).physical())
    got, ctx, cold, warm, peak, launches = C._timed(s, tpcds.q98, ds_tables)
    msg = D.compare("q98", D.result_columns(got), ds_want["q98"])
    C.check(not msg, f"dec_ds_window differs from the numpy reference: {msg}")
    C._check_launches("dec_ds_window", launches)
    _log_query(C, "dec_ds_window", got, ctx, cold, warm, peak, launches)
    return {"dec_ds_window": launches}


def _groupby_calls() -> int:
    from spark_rapids_tpu_torch.exec.aggregate import GROUPBY_TIERS
    return sum(GROUPBY_TIERS.values())


def _cse_off(q) -> None:
    """Switch the sharing off in a converted plan: each reader runs the
    view again (the plan before the CSE)."""
    stack = [q.root]
    while stack:
        node = stack.pop()
        if hasattr(node, "shared_readers"):
            node.shared_readers = 1
        stack.extend(node.children)


def cse_check(C, s, t) -> str:
    """The q15 view's group-by calls with the CSE and without it, and the
    two runs' warm walls, in this run."""
    import statistics
    import torch
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.exec.aggregate import reset_groupby_tiers
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    out = {}
    for mode in ("shared", "unshared"):
        walls = []
        for _ in range(3):
            q = tpch.q15(s, t).physical()
            if mode == "unshared":
                _cse_off(q)
            reset_groupby_tiers()
            ctx = ExecContext(q.conf, q.device)
            t0 = time.perf_counter()
            res = q.collect(ctx)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[mode] = (_groupby_calls(), statistics.median(walls),
                     ctx.metrics.get("shared_subtree_runs", 0), res)
    C.check(C.lanes_of(out["shared"][3]) == C.lanes_of(out["unshared"][3]),
            "cse_q15: the shared and unshared plans differ")
    C.check(out["shared"][0] * 2 == out["unshared"][0] and
            out["shared"][2] == 1,
            f"cse_q15: group-by calls {out['shared'][0]} shared, "
            f"{out['unshared'][0]} unshared: not halved")
    return (f"; group-by calls {out['shared'][0]} shared against "
            f"{out['unshared'][0]} with the CSE off, warm "
            f"{out['shared'][1]:.1f} against {out['unshared'][1]:.1f} ms")


def decimals_phase(C, dec_tables) -> dict:
    """dec_q1, dec_wrap, dec_rank and cse_q15 at SF10; `C` is the
    chip_smoke module.  -> {query: launches}."""
    t_phase = time.perf_counter()
    s = C._cuda_session()
    li = dec_tables["lineitem"]
    want = {"dec_q1": C.expected_q1(li), "dec_wrap": expected_wrap(li),
            "dec_rank": expected_rank(li),
            "cse_q15": C.expected_q15(dec_tables)}
    launches = {}
    for name in DEC_QUERIES:
        _placed(C, name, frame(name, s, dec_tables).physical())
        got, ctx, cold, warm, peak, launches[name] = C._timed(
            s, lambda sess, t, n=name: frame(n, sess, t), dec_tables)
        extra = ""
        if name == "dec_rank":
            check_rank(C, got, want[name])
        elif name == "cse_q15":
            C.check_later("q15", C.lanes_of(got), want[name])
            extra = cse_check(C, s, dec_tables)
        else:
            lanes = C.lanes_of(got)
            C.check(lanes == want[name], f"{name} differs from numpy:\n"
                    f"{lanes}\n{want[name]}")
        if name == "dec_q1":
            extra = (f"; seg_sums lane tiles {launches[name]['seg_sums']} "
                     f"(one int64 lane a DECIMAL sum: {Q1_OLD_TILES})")
        if name == "dec_wrap":
            top = max(abs(v) for v in want[name]["sum_price"])
            C.check(top >= 2 ** 63, "dec_wrap's sums stay inside int64")
            extra = f"; largest |sum| {top} unscaled (2^63 = {2 ** 63})"
        C._check_launches(name, launches[name])
        _log_query(C, name, got, ctx, cold, warm, peak, launches[name], extra)
    C.log(f"[decimals] phase body {time.perf_counter() - t_phase:.1f} s")
    return launches
