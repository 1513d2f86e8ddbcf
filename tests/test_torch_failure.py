"""The port's failure classes, crash dumps, device semaphore and
query-level OOM rungs (runtime/failure.py, runtime/semaphore.py,
plan/overrides.py PhysicalQuery.collect), on CPU tensors.

`classify` over a table of CUDA error codes and the text PyTorch raises
them with; the dump's fields; two threads sharing one permit; and the
query rungs: an OOM escaping every operator retry escalates out of core
first and replays the whole query last.
"""
import json
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.ops.hopper import CudaLaunchError, check_launch
from spark_rapids_tpu_torch.runtime import failure as F
from spark_rapids_tpu_torch.runtime.faults import InjectedIOError
from spark_rapids_tpu_torch.runtime.memory import (CorruptBlockError,
                                                   TpuRetryOOM,
                                                   TpuSplitAndRetryOOM)
from spark_rapids_tpu_torch.runtime.semaphore import device_permit
from spark_rapids_tpu_torch.session import TpuSession as PSession


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB")


CASES = [
    (CudaLaunchError("probe_first", 700), F.FATAL_DEVICE),
    (CudaLaunchError("seg_sums", 710), F.FATAL_DEVICE),
    (CudaLaunchError("expand_pairs", 719), F.FATAL_DEVICE),
    (CudaLaunchError("build_table", 214), F.FATAL_DEVICE),
    (CudaLaunchError("compaction_order", 2), F.RETRYABLE),
    (CudaLaunchError("seg_reduce", 1), F.QUERY),       # invalid value
    (CudaLaunchError("seg_reduce", 9), F.QUERY),       # invalid config
    (RuntimeError("CUDA error: an illegal memory access was "
                  "encountered"), F.FATAL_DEVICE),
    (RuntimeError("CUDA error: device-side assert triggered\nCUDA "
                  "kernel errors might be asynchronously reported"),
     F.FATAL_DEVICE),
    (RuntimeError("CUDA error: unspecified launch failure"), F.FATAL_DEVICE),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     F.FATAL_DEVICE),
    (RuntimeError("shape mismatch"), F.QUERY),
    (_oom(), F.RETRYABLE),
    (TpuRetryOOM("budget"), F.RETRYABLE),
    (TpuSplitAndRetryOOM("splits"), F.RETRYABLE),
    (CorruptBlockError("bad block", "/x/spill_1.blk"), F.CORRUPTION),
    (OSError("disk"), F.IO),
    (InjectedIOError("injected"), F.IO),
    (ValueError("bad"), F.QUERY),
    (F.InjectedFatalError("injected"), F.FATAL_DEVICE),
    (F.FatalDeviceError("wedged"), F.FATAL_DEVICE),
]


@pytest.mark.parametrize("exc,want", CASES,
                         ids=[f"{type(e).__name__}-{w}-{i}"
                              for i, (e, w) in enumerate(CASES)])
def test_classify(exc, want):
    assert F.classify(exc) == want


def test_check_launch_raises_a_typed_error_with_its_code():
    check_launch(0, "probe_first")
    with pytest.raises(CudaLaunchError) as ei:
        check_launch(700, "probe_first")
    assert ei.value.cuda_code == 700 and ei.value.kernel == "probe_first"
    assert "CUDA error 700" in str(ei.value)
    if hasattr(torch, "AcceleratorError"):
        # newer torch raises its CUDA errors as AcceleratorError
        err = torch.AcceleratorError("CUDA error: device-side assert "
                                     "triggered")
        assert F.classify(err) == F.FATAL_DEVICE


def test_crash_dump_fields(tmp_path):
    conf = TpuConf({"spark.rapids.tpu.coredump.path": str(tmp_path),
                    "spark.rapids.tpu.test.faults": "execute:fatal:nth=1",
                    "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 20})
    ctx = ExecContext(conf, "cpu")
    ctx.bump("rows", 3)
    ctx.budget.reserve(100)
    from spark_rapids_tpu_torch.runtime.faults import get_injector
    with pytest.raises(F.FatalDeviceError) as ei:
        with F.crash_capture(conf, ctx):
            get_injector(conf).fire("execute")
    assert isinstance(ei.value.__cause__, F.InjectedFatalError)
    dump = json.load(open(ei.value.dump_path))
    for key in ("ts", "pid", "exception", "exception_class", "traceback",
                "classification", "flight_recorder", "device",
                "torch_version", "cuda_version", "query_metrics",
                "memory_budget", "injected_faults"):
        assert key in dump, key
    assert dump["classification"] == F.FATAL_DEVICE
    assert dump["exception_class"] == "InjectedFatalError"
    assert dump["flight_recorder"] is None
    assert dump["device"] == {"type": "cpu"}
    assert dump["torch_version"] == torch.__version__
    assert dump["query_metrics"]["rows"] == 3
    assert dump["memory_budget"]["live"] == 100
    assert dump["memory_budget"]["limit"] == 1 << 20
    assert dump["injected_faults"][0]["site"] == "execute"
    # a QUERY-class error passes through untouched, with no dump
    with pytest.raises(ValueError):
        with F.crash_capture(conf, ctx):
            raise ValueError("plain")
    assert len(list(tmp_path.iterdir())) == 1
    # no dump directory: still FatalDeviceError, with no path
    with pytest.raises(F.FatalDeviceError) as ei:
        with F.crash_capture(TpuConf(), None):
            raise CudaLaunchError("seg_sums", 719)
    assert ei.value.dump_path is None


def test_inject_fatal_error_conf_counts_root_batches(tmp_path):
    t = PTPCH.gen_tables(0.001)
    s = PSession({"spark.rapids.tpu.test.injectFatalError": 1,
                  "spark.rapids.tpu.coredump.path": str(tmp_path)},
                 device="cpu")
    with pytest.raises(F.FatalDeviceError) as ei:
        PTPCH.q1(s, t).collect()
    dump = json.load(open(ei.value.dump_path))
    assert dump["classification"] == F.FATAL_DEVICE
    assert "injectFatalError" in dump["exception"]


def _q6(s, t):
    return PTPCH.q6(s, t)


def test_semaphore_blocks_a_second_query_while_one_permit_is_held():
    """With concurrentTpuTasks=1 a query waits for the held permit, and
    its wait shows in semaphore_wait_ms; with 2 it does not wait."""
    t = PTPCH.gen_tables(0.001)
    want = _q6(PSession(device="cpu"), t).to_pydict()
    for tasks, blocked in ((1, True), (2, False)):
        conf = {"spark.rapids.tpu.sql.concurrentTpuTasks": tasks}
        s = PSession(conf, device="cpu")
        out = {}

        def worker():
            q = _q6(s, t).physical()
            ctx = ExecContext(q.conf, q.device)
            out["got"] = q.collect(ctx).to_pydict()
            out["wait"] = ctx.metrics["semaphore_wait_ms"]
        with device_permit(TpuConf(conf)):
            th = threading.Thread(target=worker)
            th.start()
            time.sleep(0.3)
        th.join(60)
        assert out["got"] == want
        if blocked:
            assert out["wait"] >= 200.0
        else:
            assert out["wait"] < 200.0


def test_two_threads_share_one_permit():
    """Two threads run q6 with concurrentTpuTasks=1: both results are
    right and one of them waited for the other's permit."""
    t = PTPCH.gen_tables(0.001)
    want = _q6(PSession(device="cpu"), t).to_pydict()
    s = PSession({"spark.rapids.tpu.sql.concurrentTpuTasks": 1},
                 device="cpu")
    gate = threading.Barrier(2)
    waits, results = [], []

    def worker():
        q = _q6(s, t).physical()
        ctx = ExecContext(q.conf, q.device)
        inner = q.root.collect

        def slow(c):
            time.sleep(0.2)            # hold the permit a while
            return inner(c)
        q.root.collect = slow
        gate.wait()
        results.append(q.collect(ctx).to_pydict())
        waits.append(ctx.metrics["semaphore_wait_ms"])
    ths = [threading.Thread(target=worker) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)
    assert results == [want, want]
    assert max(waits) >= 100.0


def _failing_root(q, errors):
    """Make the root's collect raise each of `errors` in turn, then run."""
    inner = q.root.collect
    calls = []

    def collect(ctx):
        calls.append(ctx.ooc_force)
        if errors:
            raise errors.pop(0)
        return inner(ctx)
    q.root.collect = collect
    return calls


def _table():
    rng = np.random.default_rng(3)
    return pa.table({"k": pa.array(rng.integers(0, 9, 500), pa.int64()),
                     "v": pa.array(rng.standard_normal(500))})


def test_query_rungs_escalate_then_replay():
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    from spark_rapids_tpu_torch.session import col
    tbl = _table()

    def build(s):
        return s.from_arrow(tbl).group_by("k").agg((Sum(col("v")), "s")) \
            .sort(("k", True, True))
    want = build(PSession(device="cpu")).to_pydict()
    # an escaped OOM escalates out of core; a second escaped OOM takes the
    # last rung, one whole-query replay
    for errors, esc, rep in (([TpuRetryOOM("x")], 1, None),
                             ([_oom(), TpuSplitAndRetryOOM("y")], 1, 1)):
        q = build(PSession(device="cpu")).physical()
        ctx = ExecContext(q.conf, q.device)
        calls = _failing_root(q, list(errors))
        assert q.collect(ctx).to_pydict() == want
        assert ctx.metrics.get("query_ooc_escalations") == esc
        assert ctx.metrics.get("query_oom_replays") == rep
        assert calls == [False] + [True] * len(errors)
    # a third OOM is past the last rung: it propagates, classified
    q = build(PSession(device="cpu")).physical()
    _failing_root(q, [TpuRetryOOM("a"), TpuRetryOOM("b"), TpuRetryOOM("c")])
    with pytest.raises(TpuRetryOOM):
        q.collect(ExecContext(q.conf, q.device))
    # the out-of-core tier off: straight to the replay rung
    q = build(PSession({"spark.rapids.tpu.sql.ooc.enabled": "false"},
                       device="cpu")).physical()
    ctx = ExecContext(q.conf, q.device)
    _failing_root(q, [TpuRetryOOM("x")])
    assert q.collect(ctx).to_pydict() == want
    assert ctx.metrics.get("query_oom_replays") == 1
    # anything but an OOM propagates at once
    q = build(PSession(device="cpu")).physical()
    calls = _failing_root(q, [ValueError("bad")])
    with pytest.raises(ValueError):
        q.collect(ExecContext(q.conf, q.device))
    assert calls == [False]
    # sql.retry.enabled false: no rung
    q = build(PSession({"spark.rapids.tpu.sql.retry.enabled": "false"},
                       device="cpu")).physical()
    calls = _failing_root(q, [TpuRetryOOM("x")])
    with pytest.raises(TpuRetryOOM):
        q.collect(ExecContext(q.conf, q.device))
    assert calls == [False]


def test_retry_disabled_rethrows_at_once():
    from spark_rapids_tpu_torch.runtime.retry import with_retry
    conf = TpuConf({"spark.rapids.tpu.sql.retry.enabled": "false"})
    budget = ExecContext(conf, "cpu").budget
    calls = []

    def attempt():
        calls.append(1)
        raise TpuRetryOOM("x")
    with pytest.raises(TpuRetryOOM):
        with_retry(budget, conf, attempt)
    assert calls == [1]
    calls.clear()
    with pytest.raises(TpuRetryOOM):
        with_retry(ExecContext(TpuConf(), "cpu").budget, TpuConf(), attempt)
    assert calls == [1, 1]                      # maxAttempts 2


def test_recovery_keys_are_honoured():
    import warnings
    from spark_rapids_tpu_torch import config as C
    for key in ("spark.rapids.tpu.sql.retry.enabled",
                "spark.rapids.tpu.sql.test.injectRetryOOM",
                "spark.rapids.tpu.test.faults",
                "spark.rapids.tpu.sql.concurrentTpuTasks",
                "spark.rapids.tpu.coredump.path",
                "spark.rapids.tpu.test.injectFatalError"):
        assert key in C.HONOURED_KEYS, key
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TpuConf({"spark.rapids.tpu.coredump.path": "/x",
                 "spark.rapids.tpu.sql.concurrentTpuTasks": 1})


def test_budget_rebase_lowers_the_limit_only():
    from spark_rapids_tpu_torch.runtime.memory import MemoryBudget
    unlimited = MemoryBudget(TpuConf(), torch.device("cpu"))
    assert unlimited.limit == 0
    unlimited.rebase(1000)
    assert unlimited.limit == 500             # ooc.residentFraction 0.5
    small = MemoryBudget(TpuConf({
        "spark.rapids.tpu.memory.tpu.budgetBytes": 500}), torch.device("cpu"))
    small.rebase(1000)
    assert small.limit == 500
    # an allocator OOM on a CPU context escalates without a rebase
    from spark_rapids_tpu_torch.exec import ooc as O
    ctx = ExecContext(TpuConf(), "cpu")
    assert O.escalate(ctx, _oom()) and ctx.ooc_force
    assert ctx.budget.limit == 0
    assert "query_budget_rebased_bytes" not in ctx.metrics
    assert not O.escalate(ctx, _oom())             # already forced


def test_a_replay_drops_the_failed_attempts_shared_subtree():
    """q15's view is one aggregate shared by two readers (ctx.shared); an
    OOM replay must start with no entry of the failed attempt left."""
    t = PTPCH.gen_tables(0.001)
    want = PTPCH.q15(PSession(device="cpu"), t).to_pydict()
    s = PSession({"spark.rapids.tpu.test.faults": "execute:oom:nth=1"},
                 device="cpu")
    q = PTPCH.q15(s, t).physical()
    ctx = ExecContext(q.conf, q.device)
    assert q.collect(ctx).to_pydict() == want
    assert ctx.metrics["query_ooc_escalations"] == 1
    assert ctx.metrics["shared_subtree_runs"] == 2


def test_semaphore_bounds_concurrent_holders_under_stress():
    """Sixteen threads take a permit of concurrentTpuTasks=2 a hundred
    times each, with a short switch interval: never more than two hold
    one at once, and every wait is counted."""
    import sys
    conf = TpuConf({"spark.rapids.tpu.sql.concurrentTpuTasks": 2})
    lock = threading.Lock()
    state = {"holders": 0, "most": 0}
    metrics = [{} for _ in range(16)]

    def worker(m):
        for _ in range(100):
            with device_permit(conf, m):
                with lock:
                    state["holders"] += 1
                    state["most"] = max(state["most"], state["holders"])
                time.sleep(0)
                with lock:
                    state["holders"] -= 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=worker, args=(m,)) for m in metrics]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert state == {"holders": 0, "most": 2}
    assert all("semaphore_wait_ms" in m for m in metrics)
