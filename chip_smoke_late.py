"""The late phase of chip_smoke.py: selection vectors, thin join batches
and encoded execution on the card, at SF10 on the data phase's TPC-H
columns.

Cases: q1, q6, q3, q5, q7 and q9 (each with a sub-partitioned join, k
2), q10, q18_300, m2m, outer, semi and bloom_sel (lineitem ⋈ one month of
orders, chip_smoke_joins.bloom_sel), each in two modes:

  * on  — the defaults: `sql.join.lazySelection`,
    `sql.join.lateMaterialization.enabled` and
    `sql.encoded.execution.enabled` (narrow lanes AUTO) all on;
  * off — the three keys false, the plans and launches of the tree
    before them.

Each case must equal the data phase's numpy result in both modes (DOUBLE
columns within rtol 1e-12, the rest exactly) and prints its cold wall
and the median of 3 warm walls, the peak device memory, its kernel
launches, the counters (`join_deferred_gathers`,
`join_thin_early_materialized`, `late_gather_rows` and `_bytes`, the
encoded dispatches by site and outcome, the decode bytes) and the
host-to-device bytes `to_device` counted (columnar/device.UPLOADS) with
the host ms of narrowing, cold and warm: each case's "on" runs read
tables whose narrowed-lane cache starts empty, so its cold run narrows
and its warm runs reuse the cache.

The phase fails when a case differs from numpy; when no join-chain case
deferred a gather under on; when q1's host-to-device bytes under on are
not below its bytes under off; when an off case launches other than
`EXPECT_OFF`, the launches the tree before these keys made at SF10
(PERF.md's launches-by-query table with the bloom stages of that tree);
or when compaction_order never launched inside `lanes.compact_thin`.
Imports torch only at module level.
"""
from __future__ import annotations

import statistics
import time

import torch

#: the TPC-H columns the phase reads (chip_smoke keeps them from the data
#: phase)
TABLE_COLUMNS = {
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                 "l_linestatus", "l_shipdate", "l_shipmode"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
               "o_totalprice"),
    "customer": ("c_custkey", "c_mktsegment", "c_nationkey"),
    "nation": ("n_nationkey", "n_name", "n_regionkey"),
    "region": ("r_regionkey", "r_name"),
    "supplier": ("s_suppkey", "s_nationkey"),
    "part": ("p_partkey", "p_name"),
    "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
}
CASES = ("q1", "q6", "q3", "q5", "q7", "q9", "q10", "q18_300", "m2m",
         "outer", "semi", "bloom_sel")
#: the cases whose plans chain joins (one of them must defer a gather)
JOIN_CHAINS = ("q3", "q5", "q7", "q9", "q10", "q18_300")
OFF = {"spark.rapids.tpu.sql.join.lazySelection": "false",
       "spark.rapids.tpu.sql.join.lateMaterialization.enabled": "false",
       "spark.rapids.tpu.sql.encoded.execution.enabled": "false"}
_Z = {"seg_sums": 0, "seg_reduce": 0, "compaction_order": 0,
      "build_table": 0, "probe_first": 0, "probe_counts": 0,
      "expand_pairs": 0}
#: the off mode's launches at SF10: what the tree before these three keys
#: launched (PERF.md's launches by query, the bracketed counts: the bloom
#: stages' compactions in q7, q9 and semi included, bloom_sel's run with
#: its filter on)
EXPECT_OFF = {
    "q1": {**_Z, "seg_sums": 16},
    "q6": dict(_Z),
    "q3": {**_Z, "compaction_order": 38, "build_table": 4,
           "probe_first": 19},
    "q5": {**_Z, "seg_sums": 16, "compaction_order": 72, "build_table": 10,
           "probe_first": 36},
    "q7": {**_Z, "compaction_order": 346, "build_table": 12,
           "probe_first": 120},
    "q9": {**_Z, "compaction_order": 346, "build_table": 12,
           "probe_first": 105},
    "q10": {**_Z, "compaction_order": 68, "build_table": 6,
            "probe_first": 34},
    "q18_300": {**_Z, "compaction_order": 320, "build_table": 6,
                "probe_first": 16},
    "m2m": {**_Z, "seg_sums": 16, "compaction_order": 30, "build_table": 2,
            "probe_counts": 15, "expand_pairs": 15},
    "outer": {**_Z, "compaction_order": 32, "build_table": 2,
              "probe_counts": 15, "expand_pairs": 15},
    "semi": {**_Z, "compaction_order": 60, "build_table": 2,
             "probe_first": 15},
    "bloom_sel": {**_Z, "compaction_order": 166, "build_table": 4,
                  "probe_first": 30},
}


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


def _fresh(tables) -> dict:
    """The tables as new HostBatch objects whose statistics are the
    originals' without the narrowed lanes: the next run narrows cold."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    out = {}
    for n, hb in tables.items():
        fresh = HostBatch(hb.columns, hb.names)
        fresh._stats = {k: v for k, v in hb._stats.items()
                        if k[0] != "narrowed"}
        out[n] = fresh
    return out


def _build(C, name):
    from spark_rapids_tpu_torch import tpch
    if name == "bloom_sel":
        import chip_smoke_joins as J
        return J.bloom_sel
    if name in tpch.JOIN_QUERIES:
        return tpch.JOIN_QUERIES[name]
    if name in ("q1", "q3", "q6"):
        return tpch.QUERIES[name]
    return C.later_query(name, 10.0)


def _equal(C, name, got, want) -> None:
    lanes = C.lanes_of(got)
    if name == "q3":
        C.check_top(name, lanes, want)
    elif name in C.LATER_QUERIES:
        C.check_later(name, lanes, want)
    else:
        C.check(lanes == want, f"{name} differs from the numpy reference:"
                f"\n{lanes}\n{want}")


def _counters(ctx) -> dict:
    m = ctx.metrics
    keys = [k for k in m if k.startswith(("encoded_", "late_gather_")) or
            k in ("join_deferred_gathers", "join_thin_early_materialized",
                  "join_subpartition_fallbacks", "bloom_filtered_rows")]
    return {k: int(m[k]) for k in sorted(keys)}


def _session(conf):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(dict(conf))


def _run(C, name, s, tables, thin_launches):
    """One case in one session: the cold run (launches, counters, upload
    bytes and narrowing ms), then 3 warm runs."""
    from spark_rapids_tpu_torch.columnar.device import (UPLOADS,
                                                        reset_upload_counts)
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    build = _build(C, name)
    reset_launch_counts()
    reset_upload_counts()
    thin_before = thin_launches[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = build(s, tables).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    launches = dict(LAUNCHES)
    upload = dict(UPLOADS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    via_thin = thin_launches[0] - thin_before
    runs = []
    for _ in range(3):
        reset_upload_counts()
        t0 = time.perf_counter()
        build(s, tables).collect()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return got, ctx, cold, statistics.median(runs), peak, launches, \
        upload, dict(UPLOADS), via_thin


def late_phase(C, tables, want, path_walls) -> dict:
    """Every case in both modes; -> launches by case ("late_<q>_on",
    "late_<q>_off")."""
    from spark_rapids_tpu_torch.columnar import lanes as L
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES
    cold5, warm5 = path_walls
    launches = {}
    # compaction_order launches made inside compact_thin
    thin_launches = [0]
    real = L.compact_thin

    def counted(db, keep, conf=None):
        before = LAUNCHES["compaction_order"]
        out = real(db, keep) if conf is None else real(db, keep, conf)
        thin_launches[0] += LAUNCHES["compaction_order"] - before
        return out
    L.compact_thin = counted
    t_phase = time.perf_counter()
    deferred = {}
    h2d = {}
    via_thin = {}
    try:
        for mode, conf in (("on", {}), ("off", OFF)):
            s = _session(conf)
            for name in CASES:
                tabs = _fresh(tables) if mode == "on" else tables
                got, ctx, cold, warm, peak, ln, up, up_warm, thin = _run(
                    C, name, s, tabs, thin_launches)
                _equal(C, name, got, want[name])
                key = f"late_{name}_{mode}"
                launches[key] = ln
                counters = _counters(ctx)
                h2d[(name, mode)] = up["bytes"]
                via_thin[(name, mode)] = thin
                if mode == "on":
                    deferred[name] = counters.get("join_deferred_gathers", 0)
                else:
                    C.check(ln == EXPECT_OFF[name], f"late {name} off "
                            f"launched {ln}, not {EXPECT_OFF[name]}")
                    C.check(not [k for k in counters
                                 if k.startswith(("encoded_", "late_"))] and
                            "join_deferred_gathers" not in counters,
                            f"late {name} off counted {counters}")
                p5 = f"; phase 5: cold {cold5[name]:.1f} ms, warm median " \
                     f"{warm5[name]:.1f} ms" if name in cold5 else ""
                C.log(f"[late] {name} {mode}: {got.num_rows} rows equal "
                      f"numpy; cold {cold:.1f} ms, warm median "
                      f"{warm:.1f} ms{p5}; peak device memory {peak:.2f} "
                      f"GiB; launches {ln} (compaction_order inside "
                      f"compact_thin {thin}); counters {counters}; "
                      f"host-to-device {up['bytes']} bytes in "
                      f"{up['batches']} batches, narrowing cold "
                      f"{up['narrow_ns'] / 1e6:.1f} ms, warm "
                      f"{up_warm['narrow_ns'] / 1e6:.1f} ms "
                      f"({up_warm['bytes']} bytes)")
    finally:
        L.compact_thin = real
    C.check(any(deferred.get(q, 0) > 0 for q in JOIN_CHAINS),
            f"no join-chain case deferred a gather under on: {deferred}")
    C.check(h2d[("q1", "on")] < h2d[("q1", "off")],
            f"q1 uploaded {h2d[('q1', 'on')]} bytes on, not below "
            f"{h2d[('q1', 'off')]} off")
    C.check(any(v > 0 for (n, m), v in via_thin.items() if m == "on"),
            "compaction_order never launched inside compact_thin")
    C.log(f"[late] host-to-device bytes on / off: " + ", ".join(
        f"{n} {h2d[(n, 'on')]} / {h2d[(n, 'off')]}" for n in CASES))
    C.log(f"[late] deferred gathers under on: {deferred}; "
          f"compaction_order launches inside compact_thin: "
          f"{ {n: v for (n, m), v in via_thin.items() if m == 'on'} } "
          f"({time.perf_counter() - t_phase:.1f} s)")
    torch.cuda.synchronize()
    return launches
