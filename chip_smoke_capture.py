"""The capture phase of chip_smoke.py: whole-plan capture as CUDA graphs
(spark_rapids_tpu_torch/exec/compiled.py) on the card, at SF10 on the
data phase's TPC-H columns, and TPC-DS q3 (`ds_q3`) while the TPC-DS
tables are loaded.

Cases q1, q6, q3, m2m, q5, q18_300 and ds_q3, each with
`sql.compile.wholePlan` ON and OFF in one call:

  * the result equals the numpy result in both modes (DOUBLE columns
    within rtol 1e-12, the rest exactly), so ON equals OFF;
  * the decision is printed: whole, split with its segments, or the
    fallback with its error; q1, q6, q3 and ds_q3 must capture (whole or
    split), with no fallback;
  * the cold wall (the shared scan upload and the capture included) and
    the median of 3 warm walls (replays of the cached graph: each warm
    run plans the query again, and the plan cache hands it the graph),
    the peak device memory, the graphs and their pool bytes;
  * the kernel launches of one warm run, counted from torch.profiler's
    CUDA kernel events by each kernel's function names
    (`KERNEL_FUNCTIONS`), ON and OFF: OFF's profiled count must equal
    its wrappers' LAUNCHES (the names are right), and ON's, the kernels
    the replays really launched, must equal OFF's and hold PATH_KERNELS,
    where the OFF run sub-partitioned no join (a capture builds one
    table where the eager engine's out-of-core tier splits the build:
    both counts are printed).  The counts a replay re-adds from its
    capture (`graph_launches.*` in the context's metrics) are not
    launches and are not used;
  * `dispatch_floor_ms`: one replay of a trivial graph plus a
    synchronize.

Then q6 with two sets of literals: one graph (one capture, one
structure-cache hit), two replays, each equal to its numpy result; the
device-busy share of one warm run of q1 and of q3 under torch.profiler,
ON against OFF; and the three look-back kernels (compaction_order,
build_table, probe_counts) each captured into a graph at the kernel
phase's shapes and replayed 3 times with new inputs copied into its
static buffers, each replay equal to the plain version.

Imports torch only at module level.
"""
from __future__ import annotations

import datetime as pydt
import statistics
import time

import numpy as np
import torch

ON = {"spark.rapids.tpu.sql.compile.wholePlan": "ON"}
OFF = {"spark.rapids.tpu.sql.compile.wholePlan": "OFF"}
CASES = ("q1", "q6", "q3", "m2m", "q5", "q18_300")
#: cases that must capture (whole or split) on the card
MUST_CAPTURE = ("q1", "q6", "q3", "ds_q3")
#: the phase's time limit, in seconds
LIMIT_S = 150.0
#: the CUDA functions each wrapper launches, one each a LAUNCHES count
KERNEL_FUNCTIONS = {
    "seg_sums": ("seg_sums_kernel",), "seg_reduce": ("seg_reduce_kernel",),
    "compaction_order": ("compact_order_kernel", "compact_tail_kernel"),
    "build_table": ("layout_final_kernel", "layout_slots_kernel"),
    "probe_first": ("probe_first_kernel",),
    "probe_counts": ("probe_counts_kernel",),
    "expand_pairs": ("expand_pairs_kernel",)}
#: q6's second literal set: (ship date from, to, discount lo, hi, quantity)
Q6_VARIANT = (pydt.date(1995, 1, 1), pydt.date(1996, 1, 1), "0.04", "0.06",
              "25")


def narrow(tables) -> dict:
    import chip_smoke_late as LT
    return LT.narrow(tables)


def _session(conf):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(dict(conf))


def q6_with(lo: pydt.date, hi: pydt.date, d_lo: str, d_hi: str, qty: str):
    """tpch.q6 with other literals (the same plan shape)."""
    import decimal as pydec
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    from spark_rapids_tpu_torch.session import col

    def build(s, t):
        li = s.from_host(t["lineitem"])
        cond = E.And(
            E.And(E.GreaterThanOrEqual(col("l_shipdate"), E.Literal(
                tpch._days(lo), tpch.DTYPE_DATE)),
                E.LessThan(col("l_shipdate"), E.Literal(
                    tpch._days(hi), tpch.DTYPE_DATE))),
            E.And(E.And(E.GreaterThanOrEqual(col("l_discount"), E.Literal(
                pydec.Decimal(d_lo))),
                E.LessThanOrEqual(col("l_discount"), E.Literal(
                    pydec.Decimal(d_hi)))),
                E.LessThan(col("l_quantity"), E.Literal(
                    pydec.Decimal(qty)))))
        revenue = E.Multiply(col("l_extendedprice"), col("l_discount"))
        return li.filter(cond).agg((Sum(revenue), "revenue"))
    return build


def expected_q6_with(C, li, lo, hi, d_lo: str, d_hi: str, qty: str):
    ship = C._col(li, "l_shipdate").data
    disc = C._col(li, "l_discount").data
    q = C._col(li, "l_quantity").data
    mask = (ship >= C._days(lo)) & (ship < C._days(hi)) & \
        (disc >= round(float(d_lo) * 100)) & \
        (disc <= round(float(d_hi) * 100)) & (q < round(float(qty) * 100))
    price = C._col(li, "l_extendedprice").data
    return {"revenue": [int(np.sum(price[mask] * disc[mask]))]}


def _build(C, name):
    import chip_smoke_late as LT
    return LT._build(C, name)


def _equal(C, name, got, want) -> None:
    if name == "ds_q3":
        import chip_smoke_tpcds as D
        msg = D.compare("q3", D.result_columns(got), want)
        C.check(not msg, f"TPC-DS q3 differs from the numpy reference: "
                f"{msg}")
        return
    import chip_smoke_late as LT
    LT._equal(C, name, got, want)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _run(C, name, build, s, tables):
    """One mode of one case: the cold run, then 3 warm runs (each plans
    the query again).  -> (result, cold ms, warm median ms, the last
    warm run's launches, peak GiB, the cold plan, the cold context)."""
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    dev = s.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = build(s, tables).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx)
    _sync(dev)
    cold = (time.perf_counter() - t0) * 1e3
    runs = []
    for _ in range(3):
        reset_launch_counts()
        t0 = time.perf_counter()
        build(s, tables).collect()
        _sync(dev)
        runs.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    return got, cold, statistics.median(runs), dict(LAUNCHES), peak, q, ctx


def profiled_launches(build, s, tables) -> dict:
    """The kernel launches of one warm run, counted from torch.profiler's
    CUDA kernel events (a graph's replayed kernels among them).  Off the
    card (a dry run) there are none: the wrappers' counts instead."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if s.device.type != "cuda":
        from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
            reset_launch_counts
        reset_launch_counts()
        build(s, tables).collect()
        return dict(LAUNCHES)
    pats = {k: re.compile(r"\b(" + "|".join(fns) + r")\b")
            for k, fns in KERNEL_FUNCTIONS.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        build(s, tables).collect()
        _sync(s.device)
        # padding launches after a pause: a record the profiler drops at
        # the trace's end is one of theirs (they match no kernel name)
        time.sleep(0.002)
        pad = torch.zeros(1, device=s.device)
        for _ in range(4):
            pad.add_(1)
        _sync(s.device)
    out = dict.fromkeys(KERNEL_FUNCTIONS, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, pat in pats.items():
                if pat.search(e.name):
                    out[k] += 1
    return out


def _graphs(Cc, q) -> str:
    progs = Cc.plan_programs(q)
    stages = "; ".join(
        f"capture {p.capture_ms:.1f} ms (warm-up "
        f"{p.stages.get('warmup_ms', 0.0):.1f}, record "
        f"{p.stages.get('record_ms', 0.0):.1f}), pool "
        f"{p.pool_bytes / 2 ** 20:.1f} MiB" for p in progs)
    return f"{len(progs)} graph(s): {stages}"


def case(C, name, tables, want, sessions, check_launches=True) -> dict:
    """ON and OFF of one case; -> {mode: profiled launches}."""
    from spark_rapids_tpu_torch.exec import compiled as Cc
    build = _build(C, name) if name != "ds_q3" else _ds_q3()
    res = {}
    for mode in ("on", "off"):
        got, cold, warm, ln, peak, q, ctx = _run(C, name, build,
                                                 sessions[mode], tables)
        _equal(C, name, got, want)
        prof = profiled_launches(build, sessions[mode], tables)
        res[mode] = (ln, prof, ctx, q)
        dec = Cc.decision(q) if mode == "on" else "eager"
        extra = f"; {_graphs(Cc, q)}" if mode == "on" else ""
        C.log(f"[capture] {name} {mode}: {got.num_rows} rows equal numpy; "
              f"{dec}; cold {cold:.1f} ms, warm median {warm:.1f} ms; "
              f"peak device memory {peak:.2f} GiB; a warm run's launches "
              f"by the wrappers {ln}, by the profiler {prof}; "
              f"{C.ooc_counts(ctx)}{extra}")
    _on_ln, on_prof, _on_ctx, on_q = res["on"]
    off_ln, off_prof, off_ctx, _ = res["off"]
    C.check(off_prof == off_ln, f"{name}: the profiler counted {off_prof} "
            f"kernel launches of an eager run, its wrappers {off_ln}")
    dec = Cc.decision(on_q)
    if name in MUST_CAPTURE:
        C.check(dec.startswith(("whole", "split")),
                f"{name} did not capture: {dec}")
    sub = off_ctx.metrics.get("join_subpartition_fallbacks", 0)
    if check_launches and dec.startswith(("whole", "split")):
        if sub:
            C.log(f"[capture] {name}: launches ON {on_prof} vs OFF "
                  f"{off_prof} (OFF sub-partitioned {sub} join(s); the "
                  "capture builds one table)")
        else:
            # the profiler can lose kernel records of a trace (late in the
            # smoke's process q5's trace has lost one, and three, of its
            # launches), never invent one, and a replay launches the same
            # kernels each time: trace the warm ON run again, at most four
            # more times, keeping each kernel's largest count, before the
            # counts are held to OFF's
            traces = 1
            while on_prof != off_prof and traces < 5:
                again = profiled_launches(build, sessions["on"], tables)
                on_prof = {k: max(v, again[k]) for k, v in on_prof.items()}
                traces += 1
            if traces > 1:
                C.log(f"[capture] {name}: {traces} traces of a warm ON run, "
                      f"each kernel's largest count: {on_prof}")
            C.check(on_prof == off_prof, f"{name}: a warm ON run launched "
                    f"{on_prof}, not OFF's {off_prof}")
            key = name if name in C.PATH_KERNELS else None
            if key is not None:
                C._check_launches(key, on_prof)
    return {f"capture_{name}_on": on_prof, f"capture_{name}_off": off_ln}


def _ds_q3():
    from spark_rapids_tpu_torch import tpcds
    return tpcds.QUERIES["q3"]


def literal_variants(C, tables, s) -> None:
    """q6 twice with other literals: one capture, one structure hit."""
    from spark_rapids_tpu_torch.exec import compiled as Cc
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    li = tables["lineitem"]
    sets = [(pydt.date(1994, 1, 1), pydt.date(1995, 1, 1), "0.05", "0.07",
             "24"), Q6_VARIANT]
    progs, ms = [], []
    for i, lits in enumerate(sets):
        q = q6_with(*lits)(s, tables).physical()
        ctx = ExecContext(q.conf, q.device)
        t0 = time.perf_counter()
        got = q.collect(ctx)
        _sync(s.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        want = expected_q6_with(C, li, *lits)
        C.check(C.lanes_of(got) == want, f"q6 literal set {i} gave "
                f"{C.lanes_of(got)}, not {want}")
        progs += Cc.plan_programs(q)
        C.log(f"[capture] q6 literal set {i} {lits}: {C.lanes_of(got)} "
              f"equals numpy; {Cc.decision(q)}; "
              f"compile_cache_misses {ctx.metrics.get('compile_cache_misses', 0)}"
              f", whole_plan_structure_hits "
              f"{ctx.metrics.get('whole_plan_structure_hits', 0)}; "
              f"{ms[-1]:.1f} ms")
    C.check(len(progs) == 2 and progs[0] is progs[1],
            "the two q6 literal sets did not share one graph")


def busy_share(C, name, build, s, tables):
    """(wall ms, device busy ms) of one warm run under torch.profiler;
    busy None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    build(s, tables).collect()
    _sync(s.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build(s, tables).collect()
        _sync(s.device)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, (busy or None)


def idle_shares(C, tables, sessions) -> None:
    for name in ("q1", "q3"):
        build = _build(C, name)
        parts = []
        for mode in ("on", "off"):
            wall, busy = busy_share(C, name, build, sessions[mode], tables)
            parts.append(f"{mode}: wall {wall:.1f} ms, " + (
                "device time not measured" if busy is None else
                f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%, "
                f"idle {100 - 100 * busy / wall:.1f}%)"))
        C.log(f"[capture] {name} idle share, one warm run: "
              + "; ".join(parts))


def _replayed(C, dev, what, inputs, fn, plain, variants) -> None:
    """Capture fn(*static inputs) into a graph, then for each variant
    copy its inputs into the static buffers, replay, and hold the
    outputs equal to plain(*variant)."""
    from spark_rapids_tpu_torch.ops.hopper import capture_scratch
    static = [x.clone() for x in inputs]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*static)                          # warm-up, eager
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with capture_scratch(dev) as scratch:
        with torch.cuda.graph(g, stream=side):
            out = fn(*static)
    C.check(scratch[0] is not None or what == "none",
            f"{what}: the graph launched no look-back kernel")
    for i, v in enumerate(variants):
        for s, x in zip(static, v):
            s.copy_(x)
        g.replay()
        torch.cuda.synchronize()
        want = plain(*v)
        for k, (a, b) in enumerate(zip(out, want)):
            C._exact(a, b, f"{what} replay {i} output {k}")
    C.log(f"[capture] {what}: {len(variants)} replays of one graph with "
          "new inputs equal the plain version")
    del out
    g.reset()


def kernel_replays(C, dev, tables) -> None:
    """compaction_order, build_table and probe_counts, each captured at
    the kernel phase's shapes and replayed 3 times with new inputs."""
    from spark_rapids_tpu_torch.ops.hopper import compact as CP
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as HJ
    lane, valid, probe, pvalid = C.q3_join_inputs(tables, dev)
    g = torch.Generator(device=dev).manual_seed(19)

    def masks(n, p):
        return [torch.rand(n, generator=g, device=dev) < q for q in p]
    keeps = masks(probe.numel(), (0.5, 0.01, 0.99))
    _replayed(C, dev, "compaction_order", [keeps[0]],
              lambda k: CP.compaction_order(k),
              lambda k: CP.compaction_order_plain(k),
              [[k] for k in keeps])
    nbits, span = HJ.table_geometry(lane.numel())

    def build_plain(ln, vl):
        return [HJ.build_layout_plain(*HJ.hash_order(ln, vl, nbits), span)]
    perms = [torch.randperm(lane.numel(), generator=g, device=dev)
             for _ in range(2)]
    builds = [(lane, valid)] + [(lane[p].contiguous(), valid[p].contiguous())
                                for p in perms]
    _replayed(C, dev, "build_table", list(builds[0]),
              lambda ln, vl: [HJ.build_table(ln, vl).slots], build_plain,
              [list(b) for b in builds])
    m_lane, m_valid, m_probe, m_pvalid = C.m2m_join_inputs(tables, dev)
    table = HJ.build_table(m_lane, m_valid)

    def counts_plain(p, v):
        first, counts = HJ.probe_counts_plain(table, p, v)
        return [first, counts, HJ.inclusive_cumsum(counts)]
    probes = [(m_probe, m_pvalid)] + [
        (m_probe[p].contiguous(), m_pvalid.roll(i + 1).contiguous())
        for i, p in enumerate(torch.randperm(m_probe.numel(), generator=g,
                                             device=dev)
                              for _ in range(2))]
    _replayed(C, dev, "probe_counts", list(probes[0]),
              lambda p, v: list(HJ.probe_counts(table, p, v)), counts_plain,
              [list(p) for p in probes])


def capture_phase(C, tables, want) -> dict:
    """The TPC-H cases, the literal variants, the idle shares and the
    kernel replays; -> launches by case."""
    from spark_rapids_tpu_torch.exec import compiled as Cc
    t_phase = time.perf_counter()
    before = _allocated()
    sessions = {"on": _session(ON), "off": _session(OFF)}
    dev = sessions["on"].device
    C.log(f"[capture] dispatch floor (one replay of a trivial graph and a "
          f"synchronize): {Cc.dispatch_floor_ms(dev):.4f} ms")
    launches = {}
    try:
        for name in CASES:
            launches.update(case(C, name, tables, want[name], sessions))
            _free(Cc)                   # each case's graphs and uploads
        literal_variants(C, tables, sessions["on"])
        idle_shares(C, tables, sessions)
        if dev.type == "cuda":
            kernel_replays(C, dev, tables)
    finally:
        _free(Cc)
    _check_freed(C, before)
    secs = time.perf_counter() - t_phase
    C.log(f"[capture] phase {secs:.1f} s (limit {LIMIT_S:g} s)")
    C.check(secs < LIMIT_S, f"the capture phase took {secs:.1f} s, past "
            f"its {LIMIT_S:g} s")
    return launches


def ds_capture_phase(C, ds_tables, ds_want) -> dict:
    """ds_q3 ON and OFF while the TPC-DS tables are loaded."""
    from spark_rapids_tpu_torch.exec import compiled as Cc
    before = _allocated()
    sessions = {"on": _session(ON), "off": _session(OFF)}
    try:
        launches = case(C, "ds_q3", ds_tables, ds_want["q3"], sessions)
    finally:
        _free(Cc)
    _check_freed(C, before)
    return launches


def _allocated() -> int:
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def _free(Cc) -> None:
    """Release every graph, pool and scan upload, so what runs next sees
    the card as it was."""
    import gc
    Cc.clear_caches()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _check_freed(C, before: int) -> None:
    """Fail unless the allocated device bytes are back within 64 MiB of
    `before`, the phase's start."""
    after = _allocated()
    C.log(f"[capture] device memory allocated before the phase "
          f"{before / 2 ** 20:.1f} MiB, after it {after / 2 ** 20:.1f} MiB")
    C.check(after <= before + (64 << 20), "the capture phase left "
            f"{(after - before) / 2 ** 20:.1f} MiB allocated")
