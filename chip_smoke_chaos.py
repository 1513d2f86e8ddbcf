"""The chaos phase of chip_smoke.py: the recovery ladder on the card, at
SF10 on the data phase's TPC-H tables.

  * recoverable faults — q6 and q3 under each of `execute:oom:nth=1`,
    `h2d:ioerror:nth=1`, `d2h:ioerror:nth=1` and `reserve:oom:nth=5`,
    and the MIN/MAX group-by under `reserve:oom:nth=5`: each result
    equal to the clean run's and to numpy, and each rule's site fired
    (a plan that holds no batch across a blocking point, as q6, makes no
    reservation: its `reserve` rule counts 0 hits, printed as such).
  * kernel sheds — q1 under `kernel:oom:nth=1` (its first segagg
    election sheds to the sorted group-by) and q3 under the `kernel:oom`
    rule whose nth is its first hash-table join election (read from a
    spy on the clean run's elections); each equal to numpy, with its
    launches beside the clean run's.
  * families off — q3, m2m, outer and semi with
    `sql.kernels.pallas.join=OFF` (the sorted join tier), then with
    `…compact=OFF` (the argsort compaction): each equal to numpy and
    launching none of the family's kernels, its warm wall (median of 3)
    beside the kernel path's, measured here.
  * out of core — q18_300 under chip_smoke.OOC_CONF (1 GiB budget):
    `ooc:oom:nth=1` equal to the clean run; `spill_read:corrupt:nth=1`
    classified `corruption` with no budget byte left;
    `deadline:timeout:nth=1` raising InjectedDeadlineExceeded with every
    reservation released.
  * a real allocator OOM — q18_300's peak reserved memory in core,
    measured here; the process capped by
    torch.cuda.set_per_process_memory_fraction at CAP_SHARE of it and the
    budget given the whole card, so that q18 fails in core with
    torch.cuda.OutOfMemoryError; the query rung escalates out of core
    (query_ooc_escalations == 1), its budget re-based on what the
    allocator could hold, and the result equals numpy.  The fraction is
    restored after.
  * fatal errors — q1 under `execute:fatal:nth=1` raises
    FatalDeviceError whose dump is classified `fatal_device`, names the
    card and holds the fault record; in a spawned child, an out-of-range
    gather's device-side assert under crash_capture leaves a dump
    classified `fatal_device` and a non-zero exit; the parent reads the
    dump and runs on with its own context.
  * semaphore — two threads run q6 with concurrentTpuTasks=1 (one waits:
    semaphore_wait_ms > 0) and with 2; every result equal to numpy.

Each case prints its wall and its launches; the phase prints its
seconds.  Imports numpy and torch only at module level.
"""
from __future__ import annotations

import glob
import json
import multiprocessing
import os
import statistics
import tempfile
import threading
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
    "customer": ("c_custkey", "c_mktsegment", "c_name"),
    "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
}
#: the numpy results the phase compares with (from the data phase)
WANTS = ("q1", "q6", "q3", "minmax", "m2m", "outer", "semi", "q18_300")
RECOVERABLE = ("execute:oom:nth=1", "h2d:ioerror:nth=1", "d2h:ioerror:nth=1",
               "reserve:oom:nth=5")
NO_BACKOFF = {"spark.rapids.tpu.retry.io.backoffMs": "0"}
JOIN_KERNELS = ("build_table", "probe_first", "probe_counts", "expand_pairs")


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


def _build(C, name):
    from spark_rapids_tpu_torch import tpch
    if name == "minmax":
        return C.minmax_query
    if name in tpch.JOIN_QUERIES:
        return tpch.JOIN_QUERIES[name]
    return C.later_query(name, 10.0) if name == "q18_300" \
        else tpch.QUERIES[name]


def _equal(C, name, got, want) -> None:
    lanes = C.lanes_of(got)
    if name == "q3":
        C.check_top(name, lanes, want)
    elif name == "q18_300":
        C.check_later(name, lanes, want)
    else:
        C.check(lanes == want, f"chaos {name} differs from the numpy "
                f"reference:\n{lanes}\n{want}")


def _session(conf):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(dict(conf))


def _run(C, name, tables, conf, faults=None):
    """(result, ctx, session, wall ms, launches) of one cold run on a
    fresh session; launch counts zeroed just before it."""
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    conf = dict(conf)
    if faults:
        conf["spark.rapids.tpu.test.faults"] = faults
    s = _session(conf)
    reset_launch_counts()
    t0 = time.perf_counter()
    q = _build(C, name)(s, tables).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx)
    torch.cuda.synchronize()
    return got, ctx, s, (time.perf_counter() - t0) * 1e3, dict(LAUNCHES)


def _log(case, wall, launches, extra=""):
    used = {k: v for k, v in launches.items() if v}
    print(f"[chaos] {case}: {wall:.1f} ms{extra}; kernel launches {used}",
          flush=True)


def _fired(s):
    from spark_rapids_tpu_torch.runtime.faults import get_injector
    inj = get_injector(s.conf)
    return inj, [r["site"] for r in inj.log]


def _lanes_equal(C, a, b) -> bool:
    return C.lanes_of(a) == C.lanes_of(b)


# ---------------------------------------------------------------------------
# recoverable faults and kernel sheds
# ---------------------------------------------------------------------------

def recoverable_cases(C, tables, want, launches) -> None:
    for name in ("q6", "q3"):
        clean, _, _, wall, ln = _run(C, name, tables, NO_BACKOFF)
        _equal(C, name, clean, want[name])
        _log(f"{name} clean", wall, ln)
        launches[f"chaos_{name}_clean"] = ln
        for faults in RECOVERABLE:
            got, ctx, s, wall, ln = _run(C, name, tables, NO_BACKOFF, faults)
            _equal(C, name, got, want[name])
            C.check(_lanes_equal(C, got, clean), f"chaos {name} under "
                    f"{faults} differs from its clean run")
            inj, sites = _fired(s)
            site = faults.split(":")[0]
            hits = sum(r.hits for r in inj.rules)
            C.check(site in sites or (site == "reserve" and hits == 0 and
                                      name == "q6"),
                    f"chaos {name}: the {site} site did not fire "
                    f"({hits} hits)")
            m = ctx.metrics
            _log(f"{name} under {faults}", wall, ln,
                 f" (site {site}: {hits} hits, fired {sites.count(site)}; "
                 f"escalations {m.get('query_ooc_escalations', 0)}, "
                 f"replays {m.get('query_oom_replays', 0)}, operator OOM "
                 f"retries {m.get('memory.oom_retries', 0)}, IO retries "
                 f"{m.get('memory.io_retries', 0)}); equal to the clean "
                 f"run and numpy")
            launches[f"chaos_{name}_{site}"] = ln
    got, ctx, s, wall, ln = _run(C, "minmax", tables, NO_BACKOFF,
                                 "reserve:oom:nth=5")
    _equal(C, "minmax", got, want["minmax"])
    inj, sites = _fired(s)
    _log("minmax under reserve:oom:nth=5", wall, ln,
         f" (reserve hits {sum(r.hits for r in inj.rules)}, fired "
         f"{sites.count('reserve')}); equal to numpy")
    launches["chaos_minmax_reserve"] = ln


def shed_cases(C, tables, want, launches) -> None:
    from spark_rapids_tpu_torch.ops import hopper as H
    # q1: its first segagg election sheds to the sorted group-by
    clean, _, _, wall, ln0 = _run(C, "q1", tables, NO_BACKOFF)
    _equal(C, "q1", clean, want["q1"])
    got, ctx, s, wall, ln = _run(C, "q1", tables, NO_BACKOFF,
                                 "kernel:oom:nth=1")
    _equal(C, "q1", got, want["q1"])
    inj, _sites = _fired(s)
    C.check(inj.log and inj.log[0]["kernel"] == "segagg" and
            ctx.metrics.get("kernel_fallback.segagg.oom") == 1,
            f"q1's first segagg election did not shed: {inj.log}")
    C.check(ln["seg_sums"] < ln0["seg_sums"], "q1's shed launched as many "
            f"seg_sums tiles as its clean run ({ln['seg_sums']})")
    _log("q1 under kernel:oom:nth=1 (segagg shed)", wall, ln,
         f" against the clean run's seg_sums {ln0['seg_sums']}; equal "
         "to numpy")
    launches["chaos_q1_segagg_shed"] = ln
    # q3: the rule's nth is the first hash-table join election of a clean
    # run (a spy on the elections gives their order)
    order = []
    real = H.elect

    def spy(conf, kernel):
        order.append(kernel)
        return real(conf, kernel)
    H.elect = spy
    try:
        clean, _, _, _w, ln0 = _run(C, "q3", tables, NO_BACKOFF)
    finally:
        H.elect = real
    nth = order.index("hash_probe_join") + 1
    got, ctx, s, wall, ln = _run(C, "q3", tables, NO_BACKOFF,
                                 f"kernel:oom:nth={nth}")
    _equal(C, "q3", got, want["q3"])
    inj, _sites = _fired(s)
    C.check(inj.log and inj.log[0]["kernel"] == "hash_probe_join" and
            ctx.metrics.get("kernel_fallback.hash_probe_join.oom") == 1,
            f"q3's join election did not shed: {inj.log}")
    C.check(ln["build_table"] < ln0["build_table"], "q3's shed built as "
            "many hash tables as its clean run")
    _log(f"q3 under kernel:oom:nth={nth} (hash_probe_join shed; "
         f"elections {order})", wall, ln,
         f" against the clean run's {ln0}; equal to numpy")
    launches["chaos_q3_join_shed"] = ln


def families_off_cases(C, tables, want, launches) -> None:
    """Each query with a family off equals numpy and launches none of
    the family's kernels; warm walls beside the kernel path's."""
    modes = (("kernels", {}),
             ("join=OFF", {"spark.rapids.tpu.sql.kernels.pallas.join": "OFF"}),
             ("compact=OFF",
              {"spark.rapids.tpu.sql.kernels.pallas.compact": "OFF"}))
    for name in ("q3", "m2m", "outer", "semi"):
        walls = {}
        for mode, conf in modes:
            got, _ctx, s, cold, ln = _run(C, name, tables, conf)
            _equal(C, name, got, want[name])
            off = {"join=OFF": JOIN_KERNELS,
                   "compact=OFF": ("compaction_order",)}.get(mode, ())
            for k in off:
                C.check(ln[k] == 0, f"{name} with {mode} launched {k}")
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                _build(C, name)(s, tables).collect()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            walls[mode] = statistics.median(runs)
            _log(f"{name} {mode}", cold, ln,
                 f" cold, warm median {walls[mode]:.1f} ms; equal to numpy")
            if mode != "kernels":
                launches[f"chaos_{name}_{mode.split('=')[0]}_off"] = ln
        print(f"[chaos] {name} warm walls: " + ", ".join(
            f"{m} {w:.1f} ms" for m, w in walls.items()), flush=True)


# ---------------------------------------------------------------------------
# out of core and the real allocator OOM
# ---------------------------------------------------------------------------

def ooc_cases(C, tables, want, launches) -> None:
    from spark_rapids_tpu_torch.exec.plan import InjectedDeadlineExceeded
    from spark_rapids_tpu_torch.runtime.failure import CORRUPTION, classify
    from spark_rapids_tpu_torch.runtime.memory import CorruptBlockError
    conf = {**C.OOC_CONF, **NO_BACKOFF}
    clean, ctx0, _, wall, ln = _run(C, "q18_300", tables, conf)
    _equal(C, "q18_300", clean, want["q18_300"])
    C.check(ctx0.metrics.get("ooc.agg_elections", 0) > 0,
            "q18_300 under the 1 GiB budget did not run out of core")
    _log("q18_300 out of core, clean", wall, ln,
         f" (disk batches {ctx0.budget.metrics['disk_batches']})")
    got, ctx, s, wall, ln = _run(C, "q18_300", tables, conf,
                                 "ooc:oom:nth=1")
    C.check(_lanes_equal(C, got, clean), "q18_300 under ooc:oom:nth=1 "
            "differs from its clean run")
    inj, sites = _fired(s)
    C.check(sites[:1] == ["ooc"], f"the ooc site did not fire: {sites}")
    _log("q18_300 under ooc:oom:nth=1", wall, ln,
         f" (record {inj.log[0]}; escalations "
         f"{ctx.metrics.get('query_ooc_escalations', 0)}, replays "
         f"{ctx.metrics.get('query_oom_replays', 0)}); equal to the clean "
         "run")
    launches["chaos_q18_ooc_oom"] = ln
    for faults, exc_type, want_class in (
            ("spill_read:corrupt:nth=1", CorruptBlockError, CORRUPTION),
            ("deadline:timeout:nth=1", InjectedDeadlineExceeded, "query")):
        from spark_rapids_tpu_torch.exec.plan import ExecContext
        s = _session({**conf, "spark.rapids.tpu.test.faults": faults})
        q = _build(C, "q18_300")(s, tables).physical()
        ctx = ExecContext(q.conf, q.device)
        t0 = time.perf_counter()
        err = None
        try:
            q.collect(ctx)
        except exc_type as e:
            err = e
        wall = (time.perf_counter() - t0) * 1e3
        C.check(err is not None, f"q18_300 under {faults} raised nothing")
        C.check(classify(err) == want_class, f"q18_300 under {faults}: "
                f"classified {classify(err)}, not {want_class}")
        del err
        import gc
        gc.collect()
        C.check(ctx.budget.live == 0, f"q18_300 under {faults} left "
                f"{ctx.budget.live} budget bytes reserved")
        print(f"[chaos] q18_300 under {faults}: {exc_type.__name__} "
              f"classified {want_class} after {wall:.1f} ms; 0 budget "
              "bytes left", flush=True)


#: the per-process memory cap of the allocator OOM case, as a share of
#: q18_300's in-core peak reserved memory (5.75 GiB at SF10): low enough
#: that the in-core run fails, high enough that the out-of-core replay's
#: working set fits beside its rebased budget
CAP_SHARE = 0.8


def allocator_oom_case(C, tables, want, launches) -> None:
    """A real torch.cuda.OutOfMemoryError in core, recovered by the
    query rung's out-of-core replay on a budget re-based to what the
    allocator could hold (exec/ooc.escalate)."""
    total = torch.cuda.mem_get_info()[1]
    whole = {"spark.rapids.tpu.memory.tpu.budgetBytes": str(total)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, ctx, _s, wall, _ln = _run(C, "q18_300", tables, whole)
    core = torch.cuda.max_memory_reserved()
    _equal(C, "q18_300", got, want["q18_300"])
    C.check(not ctx.metrics.get("query_ooc_escalations"), "q18_300 under "
            "the whole card's budget escalated")
    del got, ctx
    cap = int(core * CAP_SHARE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        got, ctx, _s, capped, ln = _run(C, "q18_300", tables, whole)
        peak = torch.cuda.max_memory_reserved()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    _equal(C, "q18_300", got, want["q18_300"])
    m = ctx.metrics
    C.check(m.get("query_ooc_escalations") == 1, "the capped q18_300 did "
            f"not escalate out of core: {m.get('query_ooc_escalations')}")
    _log(f"q18_300 with the process capped at {cap / 2**30:.2f} GiB "
         f"({CAP_SHARE} x its in-core peak reserved {core / 2**30:.2f} GiB, "
         f"{wall:.1f} ms in core)", capped, ln,
         f" (escalations 1, budget re-based to "
         f"{m.get('query_budget_rebased_bytes', 0) / 2**30:.2f} GiB, "
         f"replays {m.get('query_oom_replays', 0)}, operator OOM retries "
         f"{m.get('memory.oom_retries', 0)}, spilled batches "
         f"{m.get('memory.spilled_batches', 0)}; peak reserved "
         f"{peak / 2**30:.2f} GiB); equal to numpy")
    launches["chaos_q18_allocator_oom"] = ln


# ---------------------------------------------------------------------------
# fatal errors and the semaphore
# ---------------------------------------------------------------------------

def _assert_child(dump_dir: str) -> None:
    """A device-side assert (an out-of-range gather) under crash_capture,
    in a process of its own: the dump is written, FatalDeviceError ends
    the process with a non-zero code."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.runtime.failure import crash_capture
    conf = TpuConf({"spark.rapids.tpu.coredump.path": dump_dir})
    ctx = ExecContext(conf, "cuda")
    with crash_capture(conf, ctx):
        x = torch.arange(1 << 20, device="cuda")
        idx = torch.tensor([0, 1 << 30], device="cuda")
        y = x[idx]
        torch.cuda.synchronize()
        print(y.sum().item())


def fatal_cases(C, tables, launches) -> None:
    from spark_rapids_tpu_torch.runtime.failure import (FATAL_DEVICE,
                                                        FatalDeviceError)
    dump_dir = tempfile.mkdtemp(prefix="srtpu_dumps_")
    conf = {"spark.rapids.tpu.coredump.path": dump_dir}
    err = None
    t0 = time.perf_counter()
    try:
        _run(C, "q1", tables, conf, "execute:fatal:nth=1")
    except FatalDeviceError as e:
        err = e
    wall = (time.perf_counter() - t0) * 1e3
    C.check(err is not None and err.dump_path, "q1 under execute:fatal "
            "raised no FatalDeviceError with a dump")
    dump = json.load(open(err.dump_path))
    C.check(dump["classification"] == FATAL_DEVICE and
            dump["device"].get("name") == torch.cuda.get_device_name(0) and
            dump["injected_faults"][0]["site"] == "execute",
            f"q1's dump is not a classified fatal_device dump naming the "
            f"card and the fault: {dump}")
    print(f"[chaos] q1 under execute:fatal:nth=1: FatalDeviceError after "
          f"{wall:.1f} ms, dump classified {dump['classification']}, card "
          f"{dump['device']['name']}, fault record "
          f"{dump['injected_faults'][0]}", flush=True)
    child_dir = tempfile.mkdtemp(prefix="srtpu_dumps_child_")
    t0 = time.perf_counter()
    proc = multiprocessing.get_context("spawn").Process(
        target=_assert_child, args=(child_dir,))
    proc.start()
    proc.join(300)
    wall = (time.perf_counter() - t0) * 1e3
    if proc.is_alive():
        proc.kill()
        proc.join()
    dumps = glob.glob(os.path.join(child_dir, "tpu-coredump-*.json"))
    C.check(proc.exitcode not in (0, None) and len(dumps) == 1,
            f"the device-side assert child exited {proc.exitcode} with "
            f"{len(dumps)} dumps")
    dump = json.load(open(dumps[0]))
    C.check(dump["classification"] == FATAL_DEVICE, "the device-side "
            f"assert was classified {dump['classification']}")
    # the parent's own context is healthy
    x = torch.arange(10, device="cuda")
    C.check(int(x.sum()) == 45, "the parent's CUDA context is not healthy")
    print(f"[chaos] spawned device-side assert: child exit code "
          f"{proc.exitcode} after {wall:.1f} ms, dump classified "
          f"{dump['classification']} ({dump['exception_class']}: "
          f"{dump['exception'][:120]}); the parent's context runs on",
          flush=True)


def semaphore_cases(C, tables, want, launches) -> None:
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    for tasks in (1, 2):
        s = _session({"spark.rapids.tpu.sql.concurrentTpuTasks": str(tasks)})
        gate = threading.Barrier(2)
        out, errors = [], []

        def worker():
            try:
                q = _build(C, "q6")(s, tables).physical()
                ctx = ExecContext(q.conf, q.device)
                gate.wait()
                t0 = time.perf_counter()
                got = q.collect(ctx)
                torch.cuda.synchronize()
                out.append((got, ctx.metrics["semaphore_wait_ms"],
                            (time.perf_counter() - t0) * 1e3))
            except BaseException as e:             # noqa: BLE001
                errors.append(e)
        ths = [threading.Thread(target=worker) for _ in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(600)
        C.check(not errors and len(out) == 2, f"semaphore threads failed: "
                f"{errors}")
        for got, _w, _t in out:
            _equal(C, "q6", got, want["q6"])
        waits = sorted(w for _g, w, _t in out)
        if tasks == 1:
            C.check(waits[-1] > 0.0, "neither q6 thread waited for the "
                    "one permit")
        print(f"[chaos] q6 in two threads, concurrentTpuTasks={tasks}: "
              f"semaphore_wait_ms {waits[0]:.3f} and {waits[1]:.3f}, walls "
              + " and ".join(f"{t:.1f} ms" for _g, _w, t in out)
              + "; both equal to numpy", flush=True)


def chaos_phase(C, tables, want) -> dict:
    """Every case; -> {case: its launches}."""
    launches: dict = {}
    recoverable_cases(C, tables, want, launches)
    shed_cases(C, tables, want, launches)
    families_off_cases(C, tables, want, launches)
    ooc_cases(C, tables, want, launches)
    allocator_oom_case(C, tables, want, launches)
    fatal_cases(C, tables, launches)
    semaphore_cases(C, tables, want, launches)
    return launches
