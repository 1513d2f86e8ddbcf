"""TPC-H q18_300 at SF10 under per-process memory caps on one NVIDIA GPU:
how the query-level out-of-core rung recovers a real allocator OOM.

    python3 chip_oom_sweep.py            # from the repository root

The budget is given the whole card (`memory.tpu.budgetBytes`), so only
the CUDA caching allocator can fail.  Prints q18_300's peak reserved
memory in core and forced out of core (`sql.ooc.force`), then, for each
`sql.ooc.residentFraction` (the share of the allocator's reserved bytes
that `MemoryBudget.rebase` gives the budget on an allocator OOM) and
each cap (a share of the in-core peak, set with
torch.cuda.set_per_process_memory_fraction), whether the query recovered,
its rungs (escalations, replays), its re-based budget, its spills, its
peak, its wall and the allocated bytes at the start of each attempt.
Every result is held to numpy (chip_smoke's).  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import gc
import multiprocessing
import os
import sys
import time

import torch


def _gib(x) -> str:
    return f"{x / 2 ** 30:.2f}"


def _capped_run(C, CH, tables, conf, want):
    """(outcome line, allocated GiB at each attempt's start)."""
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    starts = []
    s = CH._session(conf)
    q = C.later_query("q18_300", 10.0)(s, tables).physical()
    ctx = ExecContext(q.conf, q.device)
    inner = q.root.collect

    def collect(c):
        starts.append(_gib(torch.cuda.memory_allocated()))
        return inner(c)
    q.root.collect = collect
    t0 = time.perf_counter()
    try:
        got = q.collect(ctx)
    except torch.cuda.OutOfMemoryError:
        return (f"OutOfMemoryError after "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms"), starts
    wall = (time.perf_counter() - t0) * 1e3
    CH._equal(C, "q18_300", got, want)
    m = ctx.metrics
    return (f"recovered in {wall:.1f} ms, equal to numpy; escalations "
            f"{m.get('query_ooc_escalations', 0)}, replays "
            f"{m.get('query_oom_replays', 0)}, budget re-based to "
            f"{_gib(m.get('query_budget_rebased_bytes', 0))} GiB, operator "
            f"OOM retries {m.get('memory.oom_retries', 0)}, spilled batches "
            f"{m.get('memory.spilled_batches', 0)}, peak reserved "
            f"{_gib(torch.cuda.max_memory_reserved())} GiB"), starts


def _peak(CH, C, tables, conf, want):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, _ctx, _s, wall, _ln = CH._run(C, "q18_300", tables, conf)
    CH._equal(C, "q18_300", got, want)
    return torch.cuda.max_memory_reserved(), wall


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", default="0.8,0.6")
    ap.add_argument("--resident", default="0.85,0.5,0.3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_oom_sweep: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as C
    import chip_smoke_chaos as CH
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.ops.hopper import build_libraries
    print(f"[sweep] {C.smi_line()}", flush=True)
    build_libraries()
    tables = tpch.gen_tables(10.0, 20240706)
    C._WANT_TABLES = (tables, 10.0)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("fork")) as pool:
        want = pool.submit(C._want, "q18_300").result()[0]
    C._WANT_TABLES = None
    tables = CH.narrow(tables)
    total = torch.cuda.mem_get_info()[1]
    whole = {"spark.rapids.tpu.memory.tpu.budgetBytes": str(total)}
    core, wall = _peak(CH, C, tables, whole, want)
    forced, wall_f = _peak(CH, C, tables,
                           {**whole, "spark.rapids.tpu.sql.ooc.force": "true"},
                           want)
    print(f"[sweep] q18_300 peak reserved: in core {_gib(core)} GiB "
          f"({wall:.1f} ms), forced out of core {_gib(forced)} GiB "
          f"({wall_f:.1f} ms)", flush=True)
    for share in (float(x) for x in args.resident.split(",")):
        for f in (float(x) for x in args.caps.split(",")):
            gc.collect()
            cap = int(core * f)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.set_per_process_memory_fraction(cap / total)
            try:
                line, starts = _capped_run(
                    C, CH, tables,
                    {**whole, "spark.rapids.tpu.sql.ooc.residentFraction":
                     str(share)}, want)
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)
                torch.cuda.empty_cache()
            print(f"[sweep] residentFraction {share}, cap {f} x = "
                  f"{_gib(cap)} GiB: {line}; allocated GiB at each "
                  f"attempt's start {starts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
