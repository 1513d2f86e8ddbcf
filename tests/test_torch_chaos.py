"""The port's chaos suite: site-addressable fault injection through real
queries, against the JAX package's clean results.

Port copies of the tier-1 cases of tests/test_chaos.py that reach the
sites the port fires (runtime/faults.PORTED_SITES): reserve, execute,
h2d, d2h, spill_write, spill_read, ooc, kernel and deadline.  A
recoverable fault must give a result bit-identical to the port's clean
run AND to the reference's clean result on the same tables (TPC-H at
0.001, TPC-DS at 0.0005, the reference's results computed once per
module); a fatal one must end in a FatalDeviceError whose dump holds
`classification == "fatal_device"` and the injected-fault record; a
corrupt spill block must be classified `corruption`.  Every site the
port does not fire yet must refuse its spec, naming its ROADMAP item.
"""
import gc
import json
import os
import re
import warnings

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import tpcds as JDS
from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import tpcds as PDS
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TEST_FAULTS, TpuConf
from spark_rapids_tpu_torch.exec.plan import (ExecContext,
                                              InjectedDeadlineExceeded,
                                              QueryDeadlineExceeded)
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.runtime.failure import (CORRUPTION, FATAL_DEVICE,
                                                    IO, QUERY,
                                                    FatalDeviceError,
                                                    classify)
from spark_rapids_tpu_torch.runtime.faults import (PORTED_SITES, SITES,
                                                   UNFIRED_SITES,
                                                   FaultInjector,
                                                   InjectedIOError,
                                                   InjectedQueryError,
                                                   get_injector, parse_spec)
from spark_rapids_tpu_torch.runtime.memory import CorruptBlockError
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

from torch_tpcds_parity import _unscaled
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

#: knobs that force the spill and retry machinery through small inputs
TINY_MEMORY = {
    "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 16,
    "spark.rapids.tpu.memory.host.spillStorageSize": 1 << 14,
    "spark.rapids.tpu.sql.batchSizeRows": 1024,
    "spark.rapids.tpu.sql.shape.minBucketRows": 256,
    "spark.rapids.tpu.retry.io.backoffMs": 0,
}
NO_BACKOFF = {"spark.rapids.tpu.retry.io.backoffMs": 0}


def run(build, conf=None, faults=None):
    """(result dict, ExecContext, session) of one query on a FRESH port
    session (fresh injector hit counters), CPU tensors."""
    settings = dict(conf or {})
    if faults:
        settings["spark.rapids.tpu.test.faults"] = faults
    s = PSession(settings, device="cpu")
    q = build(s).physical()
    ctx = ExecContext(q.conf, q.device)
    return q.collect(ctx).to_pydict(), ctx, s


def fired_sites(session):
    return {rec["site"] for rec in get_injector(session.conf).log}


def same(got, want):
    """Equal exactly, decimals as unscaled integers at their scale."""
    assert list(got) == list(want)
    assert _unscaled(got) == _unscaled(want)


def sort_tbl(n=40_000, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({"v": pa.array(rng.standard_normal(n))})


def sort_query(tbl):
    return lambda s: s.from_arrow(tbl).sort(("v", True, True))


def positive(tbl, e=PE, c=pcol):
    return lambda s: s.from_arrow(tbl).filter(
        e.GreaterThan(c("v"), e.Literal(0.0)))


@pytest.fixture(scope="module")
def sort_reference():
    """The reference's clean sort of sort_tbl() (and its 2,000-row
    filter) under TINY_MEMORY, once per module."""
    from spark_rapids_tpu.plan import expressions as JE
    from spark_rapids_tpu.session import col as jcol
    tbl = sort_tbl()
    small = sort_tbl(2_000, seed=9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        srt = JSession(TINY_MEMORY).from_arrow(tbl).sort(
            ("v", True, True)).collect().to_pydict()
        flt = positive(small, JE, jcol)(JSession()).collect().to_pydict()
    return {"sort": srt, "filter": flt}


# ---------------------------------------------------------------------------
# per site: recoverable classes are bit-identical to the clean runs
# ---------------------------------------------------------------------------

def test_reserve_oom_recovers_spilling_sort(sort_reference):
    tbl = sort_tbl()
    clean, _, _ = run(sort_query(tbl), TINY_MEMORY)
    chaos, ctx, s = run(sort_query(tbl), TINY_MEMORY,
                        faults="reserve:oom:nth=20")
    same(chaos, clean)
    same(chaos, sort_reference["sort"])
    assert "reserve" in fired_sites(s)
    m = ctx.metrics
    assert m.get("memory.oom_retries", 0) + \
        m.get("query_ooc_escalations", 0) + \
        m.get("query_oom_replays", 0) >= 1


def test_inject_retry_oom_conf_recovers():
    """sql.test.injectRetryOOM raises TpuRetryOOM once, at the Nth
    reservation; the retry ladder absorbs it."""
    tbl = sort_tbl(8_000, seed=3)
    clean, _, _ = run(sort_query(tbl), TINY_MEMORY)
    chaos, ctx, _ = run(sort_query(tbl), {
        **TINY_MEMORY, "spark.rapids.tpu.sql.test.injectRetryOOM": 3})
    same(chaos, clean)
    assert ctx.metrics["memory.oom_retries"] >= 1


def test_execute_oom_replays_query(sort_reference):
    """An OOM escaping every operator rung escalates into the
    out-of-core rung first: the replay runs with the context forced out
    of core, bit-identical, and the whole-query replay stays in
    reserve."""
    tbl = sort_tbl(2_000, seed=9)
    clean, _, _ = run(positive(tbl))
    chaos, ctx, s = run(positive(tbl), faults="execute:oom:nth=1")
    same(chaos, clean)
    same(chaos, sort_reference["filter"])
    assert "execute" in fired_sites(s)
    assert ctx.metrics.get("query_ooc_escalations") == 1
    assert ctx.ooc_force
    assert ctx.metrics.get("query_oom_replays") is None
    # with the out-of-core tier off the replay rung owns it
    chaos2, ctx2, _ = run(positive(tbl),
                          {"spark.rapids.tpu.sql.ooc.enabled": "false"},
                          faults="execute:oom:nth=1")
    same(chaos2, clean)
    assert ctx2.metrics.get("query_oom_replays") == 1
    assert ctx2.metrics.get("query_ooc_escalations") is None
    # with sql.retry.enabled false nothing replays
    with pytest.raises(Exception) as ei:
        run(positive(tbl), {"spark.rapids.tpu.sql.retry.enabled": "false"},
            faults="execute:oom:nth=1")
    assert classify(ei.value) == "retryable"


def test_h2d_ioerror_recovers(sort_reference):
    tbl = sort_tbl(3_000, seed=11)
    clean, _, _ = run(sort_query(tbl), TINY_MEMORY)
    chaos, _, s = run(sort_query(tbl), TINY_MEMORY,
                      faults="h2d:ioerror:every=3")
    same(chaos, clean)
    assert chaos["v"] == sorted(tbl.column("v").to_pylist())
    assert "h2d" in fired_sites(s)


def test_d2h_ioerror_recovers(sort_reference):
    tbl = sort_tbl(2_000, seed=9)
    clean, _, _ = run(positive(tbl))
    chaos, ctx, s = run(positive(tbl), faults="d2h:ioerror:nth=1")
    same(chaos, clean)
    same(chaos, sort_reference["filter"])
    assert "d2h" in fired_sites(s)


def test_spill_write_and_read_ioerror_recover(sort_reference):
    # tiny device and host budgets force the disk tier; a transient IO
    # fault on the write and on the read-back is absorbed by retry.io
    tbl = sort_tbl()
    clean, _, _ = run(sort_query(tbl), TINY_MEMORY)
    chaos, ctx, s = run(
        sort_query(tbl), TINY_MEMORY,
        faults="spill_write:ioerror:nth=1;spill_read:ioerror:nth=1")
    same(chaos, clean)
    same(chaos, sort_reference["sort"])
    assert {"spill_write", "spill_read"} <= fired_sites(s)
    assert ctx.metrics["memory.io_retries"] >= 2
    assert ctx.metrics["memory.disk_batches"] >= 1


# ---------------------------------------------------------------------------
# fatal and corruption classes: a classified failure and its record
# ---------------------------------------------------------------------------

def test_execute_fatal_crash_dump_has_fault_record(tmp_path):
    tbl = sort_tbl(1_000, seed=14)
    with pytest.raises(FatalDeviceError) as ei:
        run(positive(tbl), {"spark.rapids.tpu.coredump.path": str(tmp_path)},
            faults="execute:fatal:nth=1")
    assert classify(ei.value) == FATAL_DEVICE
    dump = json.load(open(ei.value.dump_path))
    assert dump["classification"] == FATAL_DEVICE
    rec = dump["injected_faults"]
    assert rec and rec[0]["site"] == "execute" and rec[0]["kind"] == "fatal"


WHOLE_PLAN = {"spark.rapids.tpu.sql.compile.wholePlan": "ON"}


@pytest.fixture
def fresh_graphs():
    """No cached capture: the `compile` site fires on the first collect."""
    from spark_rapids_tpu_torch.exec import compiled as PC
    PC.clear_caches()
    yield
    PC.clear_caches()


def test_compile_oom_falls_back_to_eager(fresh_graphs):
    tbl = sort_tbl(2_000, seed=13)
    clean, _, _ = run(positive(tbl))
    chaos, ctx, s = run(positive(tbl), WHOLE_PLAN,
                        faults="compile:oom:nth=1")
    same(chaos, clean)
    assert "compile" in fired_sites(s)
    assert ctx.metrics.get("whole_plan_fallbacks", 0) >= 1
    assert "whole_plan_compiled_queries" not in ctx.metrics


#: a split plan whose ONE speculative candidate is the bucket the seam
#: consumes: hit 1 is segment 0's inline capture, hit 2 the background
#: capture of segment 1
SPLIT_BG = {**WHOLE_PLAN,
            "spark.rapids.tpu.sql.compile.seamSplitMinRows": "1024",
            "spark.rapids.tpu.compile.background.speculateBuckets": "1"}


def _split_build(s):
    n = 1000
    t1 = pa.table({"k": (np.arange(n) % 20).astype(np.int64),
                   "v": np.arange(n, dtype=np.float64)})
    t2 = pa.table({"k": np.arange(20, dtype=np.int64),
                   "w": np.arange(20, dtype=np.float64)})
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    return (s.from_arrow(t1).join(s.from_arrow(t2), on="k")
            .filter(PE.GreaterThan(pcol("v"), PE.Literal(100.0)))
            .group_by("k").agg((Sum(pcol("w")), "sw"))
            .sort(("k", True, True)))


def test_background_compile_oom_falls_back_bit_identical(fresh_graphs):
    """An OOM injected into a BACKGROUND segment capture re-raises on the
    query thread at the seam and rides the ladder: the eager engine,
    bit-identical."""
    clean, _, _ = run(_split_build)
    chaos, ctx, s = run(_split_build, SPLIT_BG, faults="compile:oom:nth=2")
    same(chaos, clean)
    log = get_injector(s.conf).log
    assert [r["site"] for r in log] == ["compile"]
    assert log[0]["hit"] == 2
    assert ctx.metrics.get("whole_plan_fallbacks", 0) >= 1


def test_background_compile_fatal_crash_dump(tmp_path, fresh_graphs):
    """A fatal fault in the background capture surfaces as a classified
    FatalDeviceError on the query thread, its record in the crash dump."""
    with pytest.raises(FatalDeviceError) as ei:
        run(_split_build, {**SPLIT_BG,
                           "spark.rapids.tpu.coredump.path": str(tmp_path)},
            faults="compile:fatal:nth=2")
    assert classify(ei.value) == FATAL_DEVICE
    dump = json.load(open(ei.value.dump_path))
    rec = dump["injected_faults"]
    assert rec and rec[0]["site"] == "compile" and rec[0]["hit"] == 2


def test_spill_read_corrupt_fails_cleanly():
    # a corrupted spill block surfaces as a classified CorruptBlockError
    # through the block's own crc32 check, never an endless IO retry,
    # and the failed query holds no budget byte
    tbl = sort_tbl()
    s = PSession({**TINY_MEMORY,
                  "spark.rapids.tpu.test.faults": "spill_read:corrupt:nth=1"},
                 device="cpu")
    q = sort_query(tbl)(s).physical()
    ctx = ExecContext(q.conf, q.device)
    with pytest.raises(CorruptBlockError) as ei:
        q.collect(ctx)
    assert classify(ei.value) == CORRUPTION
    assert ei.value.path and "spill" in os.path.basename(ei.value.path)
    del ei
    gc.collect()
    assert ctx.budget.live == 0


def test_io_retry_exhaustion_classifies_io():
    tbl = sort_tbl(1_000, seed=16)
    with pytest.raises(OSError) as ei:
        run(positive(tbl), {"spark.rapids.tpu.retry.io.maxAttempts": 2,
                            "spark.rapids.tpu.retry.io.backoffMs": 0},
            faults="d2h:ioerror:always")
    assert isinstance(ei.value, InjectedIOError)
    assert classify(ei.value) == IO


# ---------------------------------------------------------------------------
# deterministic triggers and the grammar
# ---------------------------------------------------------------------------

def _hits(inj, n=50):
    out = []
    for _ in range(n):
        try:
            inj.fire("reserve")
            out.append(False)
        except Exception:                        # noqa: BLE001
            out.append(True)
    return out


def test_probabilistic_trigger_is_deterministic():
    a = _hits(FaultInjector("reserve:oom:p=0.3,seed=7"))
    b = _hits(FaultInjector("reserve:oom:p=0.3,seed=7"))
    assert a == b
    assert 1 <= sum(a) <= 30
    assert _hits(FaultInjector("reserve:oom:p=0.3,seed=8")) != a
    # the same draws as the reference's injector
    from spark_rapids_tpu.runtime.faults import FaultInjector as JInjector
    assert _hits(JInjector("reserve:oom:p=0.3,seed=7")) == a


def test_every_trigger_and_log_cap():
    inj = FaultInjector("reserve:ioerror:every=2")
    fired = 0
    for _ in range(10):
        try:
            inj.fire("reserve")
        except InjectedIOError:
            fired += 1
    assert fired == 5
    assert all(r["hit"] % 2 == 0 for r in inj.log)
    inj = FaultInjector("reserve:ioerror:always")
    for _ in range(300):
        with pytest.raises(InjectedIOError):
            inj.fire("reserve")
    assert len(inj.log) == 256


def test_spec_grammar_rejects_garbage():
    for bad in ("nope:oom:nth=1", "reserve:zap:nth=1", "reserve:oom",
                "reserve:oom:banana", "reserve:oom:nth=0",
                "reserve:oom:p=1.5", "shuffle_write:corrupt:nth=1",
                "reserve:timeout:nth=1", "execute:corrupt:nth=1",
                "execute:kill:nth=1", "worker:oom:nth=1"):
        with pytest.raises(ValueError):
            parse_spec(bad)
    with pytest.raises(ValueError):
        TpuConf({"spark.rapids.tpu.test.faults": "nope:oom:nth=1"}
                ).get(TEST_FAULTS)
    # the grammar is the reference's: one conf dict drives both packages
    from spark_rapids_tpu.runtime.faults import parse_spec as jparse
    for spec in ("serving:timeout:nth=1", "result_cache:corrupt:nth=1",
                 "worker:kill:nth=3", "fleet:ioerror:every=2",
                 "spill_read:corrupt:nth=1", "h2d:ioerror:p=0.1,seed=7"):
        assert [(r.site, r.kind) for r in parse_spec(spec)] == \
            [(r.site, r.kind) for r in jparse(spec)]


@pytest.mark.parametrize("site", sorted(UNFIRED_SITES))
def test_unfired_site_refuses_naming_its_item(site):
    kind = {"worker": "kill", "serving": "timeout",
            "result_cache": "corrupt"}.get(site, "fatal")
    spec = f"{site}:{kind}:nth=1"
    TpuConf({"spark.rapids.tpu.test.faults": spec}).get(TEST_FAULTS)
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"Queue 1 {UNFIRED_SITES[site]}")):
        run(lambda s: s.from_arrow(sort_tbl(100)), faults=spec)


def test_every_site_is_ported_or_refused_and_every_ported_site_tested():
    """The port's lint: each reference site is either fired by the port
    (PORTED_SITES) or refused naming its item (UNFIRED_SITES), and each
    fired site is armed by a spec somewhere in this file."""
    assert set(PORTED_SITES) | set(UNFIRED_SITES) == set(SITES)
    assert not set(PORTED_SITES) & set(UNFIRED_SITES)
    assert all(re.fullmatch(r"item \d+", v) for v in UNFIRED_SITES.values())
    src = open(__file__).read()
    armed = set(re.findall(r'"([a-z0-9_]+):[a-z]+:(?:nth|every|always|p)',
                           src))
    assert set(PORTED_SITES) <= armed, set(PORTED_SITES) - armed


# ---------------------------------------------------------------------------
# TPC-H / TPC-DS queries under the recoverable classes
# ---------------------------------------------------------------------------

RECOVERABLE_CLASSES = [
    "execute:oom:nth=1",
    "h2d:ioerror:nth=1",
    "d2h:ioerror:nth=1",
    "reserve:oom:nth=5",
]


@pytest.fixture(scope="module")
def tpch_tables():
    return JTPCH.gen_tables(0.001), PTPCH.gen_tables(0.001)


@pytest.fixture(scope="module")
def tpcds_tables():
    return JDS.gen_tables(0.0005), PDS.gen_tables(0.0005)


@pytest.fixture(scope="module")
def references(tpch_tables, tpcds_tables):
    """The reference's clean results, once per module: TPC-H q1, q6 at
    0.001 and TPC-DS q3 at 0.0005."""
    return {"q1": JTPCH.q1(JSession(), tpch_tables[0]).collect().to_pydict(),
            "q6": JTPCH.q6(JSession(), tpch_tables[0]).collect().to_pydict(),
            "ds_q3": JDS.QUERIES["q3"](JSession(), tpcds_tables[0])
            .collect().to_pydict()}


@pytest.fixture(scope="module")
def clean_runs(tpch_tables, tpcds_tables):
    """The port's clean results of the same three queries."""
    p, ds = tpch_tables[1], tpcds_tables[1]
    return {"q1": run(lambda s: PTPCH.q1(s, p), NO_BACKOFF)[0],
            "q6": run(lambda s: PTPCH.q6(s, p), NO_BACKOFF)[0],
            "ds_q3": run(lambda s: PDS.QUERIES["q3"](s, ds), NO_BACKOFF)[0]}


@pytest.mark.parametrize("faults", RECOVERABLE_CLASSES)
def test_tpch_q6_recoverable_sweep(tpch_tables, references, clean_runs,
                                   faults):
    chaos, _, _ = run(lambda s: PTPCH.q6(s, tpch_tables[1]), NO_BACKOFF,
                      faults)
    same(chaos, clean_runs["q6"])
    same(chaos, references["q6"])


@pytest.mark.parametrize("faults", RECOVERABLE_CLASSES)
def test_tpcds_q3_recoverable_sweep(tpcds_tables, references, clean_runs,
                                    faults):
    chaos, _, _ = run(lambda s: PDS.QUERIES["q3"](s, tpcds_tables[1]),
                      NO_BACKOFF, faults)
    same(chaos, clean_runs["ds_q3"])
    same(chaos, references["ds_q3"])


def test_tpch_q1_fatal_produces_classified_dump(tpch_tables, tmp_path):
    with pytest.raises(FatalDeviceError) as ei:
        run(lambda s: PTPCH.q1(s, tpch_tables[1]),
            {"spark.rapids.tpu.coredump.path": str(tmp_path)},
            faults="execute:fatal:nth=1")
    dump = json.load(open(ei.value.dump_path))
    assert dump["classification"] == FATAL_DEVICE
    assert dump["injected_faults"][0]["kind"] == "fatal"
    assert dump["flight_recorder"] is None
    assert dump["device"]["type"] == "cpu"
    assert "q1" not in dump["query_metrics"]


# ---------------------------------------------------------------------------
# the kernel site: a shed to the portable tier, never of a real failure
# ---------------------------------------------------------------------------

def _join_df(s):
    rng = np.random.default_rng(21)
    fact = s.from_arrow(pa.table({
        "fk": pa.array(rng.integers(0, 40, 3000), pa.int64()),
        "v": pa.array(rng.standard_normal(3000))}))
    dim = s.from_arrow(pa.table({
        "k": pa.array(np.arange(50), pa.int64()),
        "w": pa.array(np.arange(50) * 1.5)}))
    return fact.join(dim, left_on=["fk"], right_on=["k"],
                     how="inner").sort(("v", True, True))


def _filter_df(s):
    rng = np.random.default_rng(22)
    return s.from_arrow(pa.table({
        "v": pa.array(rng.standard_normal(3000))})).filter(
        PE.GreaterThan(pcol("v"), PE.Literal(0.0)))


#: kernel -> (a query whose first election is that kernel's, the conf)
SHED_CASES = {
    "hash_probe_join": (_join_df, {}),
    "compact": (_filter_df, {}),
    "segagg": (lambda s: PTPCH.q1(s, PTPCH.gen_tables(0.001)), {}),
}


@pytest.mark.parametrize("kernel", sorted(SHED_CASES))
def test_kernel_oom_sheds_to_portable_tier_bit_identical(kernel):
    """An injected OOM at the kernel election sheds the operator onto
    its portable tier (the sorted join, the argsort compaction, the
    sorted group-by) with a bit-identical result, counted in the
    query's metrics; the record names the kernel."""
    build, conf = SHED_CASES[kernel]
    clean, _, _ = run(build, conf)
    chaos, ctx, s = run(build, conf, faults="kernel:oom:nth=1")
    same(chaos, clean)
    log = get_injector(s.conf).log
    assert log[0]["site"] == "kernel" and log[0]["kernel"] == kernel
    assert ctx.metrics[f"kernel_fallback.{kernel}.oom"] == 1


def test_kernel_fatal_dump_names_kernel(tmp_path):
    with pytest.raises(FatalDeviceError) as ei:
        run(_join_df, {"spark.rapids.tpu.coredump.path": str(tmp_path)},
            faults="kernel:fatal:nth=1")
    assert classify(ei.value) == FATAL_DEVICE
    rec = json.load(open(ei.value.dump_path))["injected_faults"][0]
    assert rec["site"] == "kernel" and rec["kind"] == "fatal"
    assert rec["kernel"] in ("hash_probe_join", "segagg", "compact")


def test_kernel_error_kind_propagates_as_query_error():
    with pytest.raises(InjectedQueryError) as ei:
        run(_join_df, faults="kernel:error:nth=1")
    assert classify(ei.value) == QUERY


def test_a_real_kernel_failure_is_never_shed(monkeypatch, tmp_path):
    """A kernel that fails to launch raises its CudaLaunchError, which
    is classified (a sticky code is fatal, with a dump); nothing reroutes
    it onto the portable tier."""
    from spark_rapids_tpu_torch.ops.hopper import check_launch
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as HK

    def broken(lane, valid):
        check_launch(700, "build_table")
    monkeypatch.setattr(HK, "build_table", broken)
    with pytest.raises(FatalDeviceError) as ei:
        run(_join_df, {"spark.rapids.tpu.coredump.path": str(tmp_path)})
    assert ei.value.__cause__.cuda_code == 700
    dump = json.load(open(ei.value.dump_path))
    assert dump["classification"] == FATAL_DEVICE
    assert "CudaLaunchError" in dump["exception_class"]

    def refused(lane, valid):
        check_launch(1, "build_table")          # cudaErrorInvalidValue
    monkeypatch.setattr(HK, "build_table", refused)
    with pytest.raises(RuntimeError) as ei:
        run(_join_df)
    assert classify(ei.value) == QUERY


# ---------------------------------------------------------------------------
# the ooc site: chaos inside the out-of-core window
# ---------------------------------------------------------------------------

OOC_CONF = {
    "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 17,
    "spark.rapids.tpu.sql.batchSizeRows": 1024,
    "spark.rapids.tpu.sql.shape.minBucketRows": 256,
    "spark.rapids.tpu.sql.ooc.force": "true",
    "spark.rapids.tpu.retry.io.backoffMs": 0,
}


def _ooc_tables():
    rng = np.random.default_rng(43)
    fact = pa.table({"fk": pa.array(rng.integers(0, 40, 4000), pa.int64()),
                     "v": pa.array(rng.standard_normal(4000))})
    dim = pa.table({"k": pa.array(np.arange(50), pa.int64()),
                    "w": pa.array(np.arange(50) * 1.5)})
    return fact, dim


def _ooc_join_agg(s, fact, dim, agg):
    return (s.from_arrow(fact)
            .join(s.from_arrow(dim), left_on=["fk"], right_on=["k"],
                  how="inner")
            .group_by("fk").agg((agg(pcol("v")), "sv"))
            .sort(("fk", True, True)))


def test_ooc_oom_mid_join_recovers_bit_identical():
    """`ooc:oom:nth=1` fires at the first out-of-core partition pass:
    the OOM rides the ladder into the out-of-core rung, and the replay
    is bit-identical to the clean run and to the reference's."""
    from spark_rapids_tpu.plan.aggregates import Sum as JSum
    from spark_rapids_tpu.session import col as jcol
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    fact, dim = _ooc_tables()
    build = lambda s: _ooc_join_agg(s, fact, dim, Sum)     # noqa: E731
    clean, _, _ = run(build, OOC_CONF)
    chaos, ctx, s = run(build, OOC_CONF, faults="ooc:oom:nth=1")
    same(chaos, clean)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JSession(OOC_CONF)
        want = (js.from_arrow(fact)
                .join(js.from_arrow(dim), left_on=["fk"], right_on=["k"],
                      how="inner")
                .group_by("fk").agg((JSum(jcol("v")), "sv"))
                .sort(("fk", True, True))).collect().to_pydict()
    assert chaos["fk"] == want["fk"]
    np.testing.assert_allclose(chaos["sv"], want["sv"], rtol=1e-12)
    log = get_injector(s.conf).log
    assert log and log[0]["site"] == "ooc"
    assert log[0]["op"] in ("join", "agg", "sort")
    assert ctx.metrics.get("query_ooc_escalations", 0) == 1


def test_ooc_fatal_dump_embeds_bucket_state(tmp_path):
    """kind 'fatal' at the ooc site: the dump's injected-fault record
    names the operator, bucket and depth of the pass that died (the
    reference's flight-recorder tail ports with ROADMAP Queue 1 item
    10)."""
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    fact, dim = _ooc_tables()
    with pytest.raises(FatalDeviceError) as ei:
        run(lambda s: _ooc_join_agg(s, fact, dim, Sum),
            {**OOC_CONF, "spark.rapids.tpu.coredump.path": str(tmp_path)},
            faults="ooc:fatal:nth=2")
    dump = json.load(open(ei.value.dump_path))
    assert dump["classification"] == FATAL_DEVICE
    rec = dump["injected_faults"]
    assert rec and rec[0]["site"] == "ooc" and rec[0]["kind"] == "fatal"
    assert {"op", "bucket", "depth"} <= set(rec[0])
    assert dump["flight_recorder"] is None


OOC_SORT_CONF = {
    "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 16,
    "spark.rapids.tpu.memory.host.spillStorageSize": 1 << 14,
    "spark.rapids.tpu.sql.batchSizeRows": 1024,
    "spark.rapids.tpu.sql.shape.minBucketRows": 256,
    "spark.rapids.tpu.retry.io.backoffMs": 0,
}

#: never-firing counting rules: one per site whose add/merge hit split
#: the tests below need (hits count identically in every run up to the
#: first fire, so a dry run's counters place a later run's nth= inside
#: the merge window)
_COUNTING_SPEC = ("spill_read:ioerror:nth=999983;"
                  "spill_write:ioerror:nth=999983;"
                  "reserve:oom:nth=999983")


def _drive_ooc_sorter(faults, n=24_000, seed=61, conf=None):
    """Feed the OutOfCoreSorter directly, recording each armed site's hit
    counter at the add->merge boundary, then drain the merge.  Returns
    (values, ctx, injector, marks at the merge's start)."""
    from spark_rapids_tpu_torch.columnar.device import fetch_result_batch
    from spark_rapids_tpu_torch.exec.ooc_sort import OutOfCoreSorter
    from spark_rapids_tpu_torch.exec.plan import HostScanExec
    from spark_rapids_tpu_torch.ops.sort import SortKey
    conf = conf or TpuConf({**OOC_SORT_CONF,
                            "spark.rapids.tpu.test.faults": faults})
    ctx = ExecContext(conf, "cpu")
    rng = np.random.default_rng(seed)
    scan = HostScanExec(from_arrow(pa.table({
        "v": pa.array(rng.standard_normal(n))})), 1024)
    sorter = OutOfCoreSorter([SortKey(0, True, True)], ctx)
    for db in scan.execute(ctx):
        sorter.add(db)
    inj = get_injector(conf)
    marks = {}
    for r in getattr(inj, "rules", []):
        marks[r.site] = marks.get(r.site, 0) + r.hits
    out = []
    for b in sorter.results():
        out.extend(fetch_result_batch(b).to_pydict()["v"])
    return out, ctx, inj, marks


@pytest.fixture(scope="module")
def merge_marks():
    """The dry run: the merge itself drives spill reads and writes and
    budget reservations, the window the armed tests schedule into."""
    out, ctx, inj, marks = _drive_ooc_sorter(_COUNTING_SPEC)
    assert out == sorted(out) and len(out) == 24_000
    assert ctx.metrics.get("sort_merge_passes", 0) >= 1
    totals = {r.site: r.hits for r in inj.rules}
    for site in ("spill_read", "reserve"):
        assert totals[site] > marks[site], \
            f"{site} never fired inside the merge window"
    return out, marks


@pytest.mark.parametrize("site", ["spill_read", "spill_write"])
def test_spill_ioerror_mid_merge_recovers(merge_marks, site):
    clean, marks = merge_marks
    nth = marks[site] + 1
    out, ctx, inj, _ = _drive_ooc_sorter(f"{site}:ioerror:nth={nth}")
    assert out == clean
    assert inj.log and inj.log[0]["site"] == site
    assert inj.log[0]["hit"] == nth
    assert ctx.budget.metrics["io_retries"] >= 1


def test_reserve_oom_mid_merge_replays_bit_identical(merge_marks):
    """A budget OOM inside the merge window escapes the sorter; the
    query ladder's answer (spill everything, replay) reproduces the
    clean output bit for bit (the one-shot rule already fired)."""
    from spark_rapids_tpu_torch.runtime.memory import TpuRetryOOM
    clean, marks = merge_marks
    nth = marks["reserve"] + 1
    conf = TpuConf({**OOC_SORT_CONF,
                    "spark.rapids.tpu.test.faults": f"reserve:oom:nth={nth}"})
    with pytest.raises(TpuRetryOOM):
        _drive_ooc_sorter("", conf=conf)
    inj = get_injector(conf)
    assert inj.log and inj.log[0]["site"] == "reserve" and \
        inj.log[0]["hit"] == nth
    assert _drive_ooc_sorter("", conf=conf)[0] == clean


def test_spill_read_corrupt_mid_merge_classified(merge_marks):
    nth = merge_marks[1]["spill_read"] + 1
    with pytest.raises(CorruptBlockError) as ei:
        _drive_ooc_sorter(f"spill_read:corrupt:nth={nth}")
    assert classify(ei.value) == CORRUPTION
    assert ei.value.path and "spill" in os.path.basename(ei.value.path)


def test_ooc_fatal_mid_sorter_merge_dump_names_pass(tmp_path):
    """`ooc:fatal:nth=2`: the second merge pass dies; the dump's record
    names the sort window's pass."""
    from spark_rapids_tpu_torch.runtime.failure import crash_capture
    conf = TpuConf({**OOC_SORT_CONF,
                    "spark.rapids.tpu.test.faults": "ooc:fatal:nth=2",
                    "spark.rapids.tpu.coredump.path": str(tmp_path)})
    with pytest.raises(FatalDeviceError) as ei:
        with crash_capture(conf):
            _drive_ooc_sorter("", conf=conf)
    rec = json.load(open(ei.value.dump_path))["injected_faults"]
    assert rec and rec[0]["site"] == "ooc" and rec[0]["kind"] == "fatal"
    assert rec[0]["op"] == "sort" and rec[0]["merge_pass"] == "1"
    assert "runs" in rec[0]


# ---------------------------------------------------------------------------
# the deadline site: a cancellation checkpoint
# ---------------------------------------------------------------------------

def test_deadline_timeout_injected_cancels_and_releases():
    """`deadline:timeout` fires a synthetic expiry at a cancellation
    checkpoint: the query fails with InjectedDeadlineExceeded (class
    QUERY: no retry, no dump), every reservation of its budget is
    released, and the session keeps serving."""
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    fact, dim = _ooc_tables()
    build = lambda s: _ooc_join_agg(s, fact, dim, Sum)     # noqa: E731
    s = PSession({**OOC_CONF,
                  "spark.rapids.tpu.test.faults": "deadline:timeout:nth=1"},
                 device="cpu")
    q = build(s).physical()
    ctx = ExecContext(q.conf, q.device)
    with pytest.raises(InjectedDeadlineExceeded) as ei:
        q.collect(ctx)
    assert isinstance(ei.value, QueryDeadlineExceeded)
    assert classify(ei.value) == QUERY
    assert ctx.budget.live == 0
    assert "deadline" in fired_sites(s)
    # unharmed: the next query of the session completes, as a clean run
    assert build(s).to_pydict() == run(build, OOC_CONF)[0]
    # a real deadline in the past cancels at the first checkpoint
    q = build(s).physical()
    ctx = ExecContext(q.conf, q.device, deadline=1.0)
    with pytest.raises(QueryDeadlineExceeded):
        q.collect(ctx)
    assert ctx.metrics["deadline_checkpoints_cancelled"] == 1
