"""Whole-plan capture (spark_rapids_tpu_torch/exec/compiled.py): port
copies of tests/test_compiled.py, the thin pipeline of
tests/test_late_materialization.py, and the host-decision detector
(runtime/capture.py).

On the CPU there is no CUDA graph: a capture is one run under the
detector and a replay re-runs the captured plan with its literals bound,
so these tests see the capture decisions the card makes.  With
`sql.compile.wholePlan=ON` each of the 22 TPC-H queries at scale 0.002
must capture (`whole_plan_compiled_queries == 1`), equal the port's eager
answer and the reference's CPU oracle (DOUBLE columns within rtol 1e-9,
the reduction order's tail; the rest exactly), and give identical results
on two replays.
"""
import decimal
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.exec import compiled as C
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.runtime import capture as RC
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col, lit

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ON = {"spark.rapids.tpu.sql.compile.wholePlan": "ON"}
CPU = {"spark.rapids.tpu.sql.enabled": "false"}


def _session(conf=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return PSession(dict(conf or {}), device="cpu")


def _unscaled(d: dict) -> dict:
    """Decimals as (unscaled integer, scale), else as they are."""
    return {k: [(int(v.scaleb(-v.as_tuple().exponent)),
                 -v.as_tuple().exponent)
                if isinstance(v, decimal.Decimal) else v for v in vs]
            for k, vs in d.items()}


def _same(got: dict, want: dict, rtol: float = 1e-9) -> None:
    """Equal column by column: floats within `rtol` (the reduction order
    differs between a capture and the eager engine), the rest exactly
    (decimals unscaled)."""
    assert list(got) == list(want)
    got, want = _unscaled(got), _unscaled(want)
    for name in got:
        g, w = got[name], want[name]
        assert len(g) == len(w), name
        if any(isinstance(x, float) for x in g + w):
            np.testing.assert_allclose(np.array(g, float), np.array(w, float),
                                       rtol=rtol, atol=0, err_msg=name)
        else:
            assert g == w, name


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Each test starts with no cached graph or scan upload."""
    C.clear_caches()
    yield
    C.clear_caches()


@pytest.fixture(scope="module")
def ptables():
    return PTPCH.gen_tables(0.002)


@pytest.fixture(scope="module")
def jtables():
    return JTPCH.gen_tables(0.002)


@pytest.mark.parametrize("name", sorted(PTPCH.QUERIES,
                                        key=lambda q: int(q[1:])))
def test_tpch_whole_plan_captures_and_matches(name, ptables, jtables):
    s = _session(ON)
    q = PTPCH.QUERIES[name](s, ptables).physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_compiled_queries", 0) == 1, \
        f"{name} did not capture: {C.decision(q)}"
    assert not ctx.metrics.get("whole_plan_fallbacks")
    again = q.collect(ExecContext(q.conf, q.device)).to_pydict()
    assert again == out, f"{name}: two replays differ"
    eager = PTPCH.QUERIES[name](_session(), ptables).to_pydict()
    _same(out, eager)
    jdf = JTPCH.QUERIES[name](JSession(), jtables)
    oracle = JDF(jdf._plan, JSession(CPU)).collect().to_pydict()
    _same(out, oracle)


def test_compiled_plan_cached_across_collects(ptables):
    q = PTPCH.q6(_session(ON), ptables).physical()
    first = q.collect()
    plan = q._compiled_plan
    assert plan not in (None, False)
    prog = plan.program
    second = q.collect()
    assert q._compiled_plan is plan and plan.program is prog
    assert first.to_pydict() == second.to_pydict()


def test_fallback_on_host_decision_plan():
    """A multi-batch sort (the out-of-core sorter decides on the host)
    falls back to the eager engine with the right answer."""
    s = _session({**ON, "spark.rapids.tpu.sql.batchSizeRows": 1000})
    rng = np.random.default_rng(7)
    t = pa.table({"x": rng.permutation(5000).astype("int64")})
    q = s.from_arrow(t).sort(("x", True, True)).physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx)
    assert out.to_pydict()["x"] == list(range(5000))
    assert ctx.metrics.get("whole_plan_fallbacks") == 1
    assert "whole_plan_compiled_queries" not in ctx.metrics
    assert C.decision(q).startswith("fallback: HostDecision")


def test_auto_mode_stays_eager(ptables):
    """AUTO keeps the eager engine on the port (README "Whole-plan
    capture"); OFF too."""
    for mode in ({}, {"spark.rapids.tpu.sql.compile.wholePlan": "OFF"}):
        q = PTPCH.q6(_session(mode), ptables).physical()
        ctx = ExecContext(q.conf, q.device)
        q.collect(ctx)
        assert "whole_plan_compiled_queries" not in ctx.metrics
        assert C.decision(q) == "eager"


def test_compiled_groupby_string_keys(ptables, jtables):
    s = _session(ON)
    df = (s.from_host(ptables["lineitem"]).group_by("l_returnflag")
          .agg((Count(None), "n")).sort("l_returnflag"))
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_compiled_queries") == 1
    from spark_rapids_tpu.plan.aggregates import Count as JCount
    js = JSession(CPU)
    oracle = (js.from_arrow(jtables["lineitem"]).group_by("l_returnflag")
              .agg((JCount(None), "n")).sort("l_returnflag")).collect()
    assert out == oracle.to_pydict()


def _thin_tables(seed=11, n_fact=1500, n_d1=60, n_d2=35):
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "fk1": pa.array(rng.integers(0, n_d1 + 8, n_fact), pa.int64(),
                        mask=rng.random(n_fact) < 0.06),
        "fk2": pa.array(rng.integers(0, n_d2 + 8, n_fact), pa.int64(),
                        mask=rng.random(n_fact) < 0.06),
        "fv": pa.array(rng.integers(0, 1000, n_fact), pa.int64())})
    d1 = pa.table({"k1": pa.array(np.arange(n_d1), pa.int64()),
                   "p1": pa.array(rng.integers(0, 100, n_d1), pa.int64()),
                   "s1": pa.array([f"grp_{i % 7}" for i in range(n_d1)])})
    d2 = pa.table({"k2": pa.array(np.arange(n_d2), pa.int64()),
                   "p2": pa.array(rng.integers(0, 50, n_d2), pa.int64())})
    return fact, d1, d2


def test_whole_plan_compiled_thin_pipeline():
    """The graph boundary is a sink: thin outputs materialize inside the
    captured plan; the result equals the eager engine's and the
    reference's CPU oracle."""
    from spark_rapids_tpu.plan.aggregates import Count as JCount
    from spark_rapids_tpu.plan.aggregates import Sum as JSum
    from spark_rapids_tpu.session import col as jcol
    from spark_rapids_tpu.session import lit as jlit
    fact, d1, d2 = _thin_tables()

    def build(s, c, lt, sm, cnt, gt):
        j1 = s.from_arrow(fact).join(s.from_arrow(d1), how="left_outer",
                                     left_on=["fk1"], right_on=["k1"])
        j1 = j1.filter(gt(c("fv"), lt(100)))
        j2 = j1.join(s.from_arrow(d2), how="inner", left_on=["fk2"],
                     right_on=["k2"])
        return (j2.group_by("s1").agg((sm(c("fv")), "sv"),
                                      (cnt(c("p1")), "c1"))
                .sort(("s1", False)))

    from spark_rapids_tpu.plan import expressions as JE
    port = (col, lit, Sum, Count, PE.GreaterThan)
    q = build(_session(ON), *port).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_compiled_queries") == 1
    joins = [n for n in _walk(q.root) if getattr(n, "thin_payload", None)]
    assert joins, "no join was marked thin"
    assert got == build(_session(), *port).to_pydict()
    oracle = build(JSession(CPU), jcol, jlit, JSum, JCount,
                   JE.GreaterThan).collect()
    assert got == oracle.to_pydict()


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_split_plan_segments_match_eager(ptables):
    """A low `seamSplitMinRows` splits q3 at its adaptive join's build
    input (the semi join, whose keys are unique) and at its aggregate:
    one graph a segment, each seam's count read between them."""
    conf = {**ON, "spark.rapids.tpu.sql.compile.seamSplitMinRows": "1024",
            "spark.rapids.tpu.sql.batchSizeRows": "4096"}
    q = PTPCH.q3(_session(conf), ptables).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_split_queries") == 1
    assert C.decision(q) == "split:3"
    assert ctx.metrics.get("overhead.seam_count") == 2
    eager = PTPCH.q3(_session({"spark.rapids.tpu.sql.batchSizeRows":
                               "4096"}), ptables).to_pydict()
    assert got == eager


def test_sized_expansion_falls_back_once(ptables):
    """m2m's non-unique build sizes its expansion by a host read of the
    pair total: a host decision.  A re-planned query skips the capture
    attempt (the negative cache) and runs eager."""
    tables = PTPCH.gen_tables(0.001, tables=("partsupp", "lineitem"))
    s = _session(ON)
    q = PTPCH.m2m(s, tables).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_fallbacks") == 1
    assert "pair" in C.decision(q) or "ops/join.py" in C.decision(q)
    q2 = PTPCH.m2m(s, tables).physical()
    ctx2 = ExecContext(q2.conf, q2.device)
    assert q2.collect(ctx2).to_pydict() == got
    assert ctx2.metrics.get("whole_plan_fallbacks") == 1
    assert not ctx2.metrics.get("compile_ms")        # no capture attempt
    assert got == PTPCH.m2m(_session(), tables).to_pydict()


def test_oom_during_capture_stays_eligible(ptables, monkeypatch):
    """A device OOM in a capture, with no cached graph to release, runs
    eager this time without a second attempt and leaves the plan
    eligible; the next collect captures."""
    from spark_rapids_tpu_torch.runtime.memory import TpuRetryOOM
    s = _session(ON)
    q = PTPCH.q6(s, ptables).physical()
    real = C.CompiledPlan.capture
    calls = []

    def once(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise TpuRetryOOM("injected")
        return real(self, *a, **k)
    monkeypatch.setattr(C.CompiledPlan, "capture", once)
    ctx = ExecContext(q.conf, q.device)
    first = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_fallbacks") == 1
    assert len(calls) == 1 and not ctx.metrics.get("whole_plan_oom_evictions")
    assert getattr(q, "_compiled_plan", None) is None
    ctx2 = ExecContext(q.conf, q.device)
    assert q.collect(ctx2).to_pydict() == first
    assert ctx2.metrics.get("whole_plan_compiled_queries") == 1


class _FakeGraph:
    """Stands in for a cached CUDA graph: counts its resets."""
    resets = 0

    def reset(self):
        type(self).resets += 1


def test_oom_evicts_the_cached_graphs_and_retries_once(ptables, monkeypatch):
    """The plan cache is bounded by entries, not bytes: a capture that
    runs out of device memory first releases every cached graph (and its
    pool), then tries once more, and captures."""
    from spark_rapids_tpu_torch.runtime.memory import TpuRetryOOM
    stale = C._Program(torch.device("cpu"))
    stale.graph = _FakeGraph()
    C._PLAN_CACHE[("stale",)] = (stale, [])
    s = _session(ON)
    q = PTPCH.q6(s, ptables).physical()
    real = C.CompiledPlan.capture
    calls = []

    def once(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise TpuRetryOOM("injected")
        return real(self, *a, **k)
    monkeypatch.setattr(C.CompiledPlan, "capture", once)
    _FakeGraph.resets = 0
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert _FakeGraph.resets == 1 and stale.graph is None
    assert ("stale",) not in C._PLAN_CACHE
    assert ctx.metrics.get("whole_plan_oom_evictions") == 1
    assert ctx.metrics.get("whole_plan_compiled_queries") == 1
    assert not ctx.metrics.get("whole_plan_fallbacks")
    assert len(calls) == 2
    assert got == PTPCH.q6(_session(), ptables).to_pydict()


def test_captured_and_eager_queries_run_on_two_threads_at_once(ptables):
    """A capture's detector and guards act on its own thread: an eager
    query that reads row counts on the host, run at the same time on
    another thread, neither fails nor falls back, and both answer as
    they do alone."""
    import threading
    on, off = _session(ON), _session()
    want = {n: getattr(PTPCH, n)(off, ptables).to_pydict()
            for n in ("q1", "q6", "q3")}
    errors, results = [], {}
    start = threading.Barrier(2)

    def worker(mode, session, names):
        try:
            start.wait()
            for _ in range(2):
                for n in names:
                    if mode == "on":
                        C.clear_caches()        # each collect captures
                    q = getattr(PTPCH, n)(session, ptables).physical()
                    ctx = ExecContext(q.conf, q.device)
                    results[(mode, n)] = (q.collect(ctx).to_pydict(), ctx)
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=a) for a in (
        ("on", on, ("q1", "q6", "q3")), ("off", off, ("q3", "q1", "q6")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    for (mode, n), (got, ctx) in results.items():
        _same(got, want[n])
        if mode == "on":
            assert ctx.metrics.get("whole_plan_compiled_queries") == 1, n
        else:
            assert not ctx.metrics.get("whole_plan_fallbacks"), n


def test_a_bug_in_capture_propagates(ptables, monkeypatch):
    """Only HostDecision falls back: any other error is raised."""
    q = PTPCH.q6(_session(ON), ptables).physical()

    def boom(self, *a, **k):
        raise ZeroDivisionError("a bug")
    monkeypatch.setattr(C.CompiledPlan, "capture", boom)
    with pytest.raises(ZeroDivisionError):
        q.collect(ExecContext(q.conf, q.device))


def test_dispatch_floor_is_measured():
    dev = torch.device("cpu")
    v = C.dispatch_floor_ms(dev)
    assert 0 < v < 1000 and C.dispatch_floor_ms(dev) == v


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

def _reads():
    t = torch.arange(6)
    b = t > 2
    return {
        "int": lambda: int(t[0]),
        "item": lambda: t.sum().item(),
        "tolist": lambda: t.tolist(),
        "numpy": lambda: t.numpy(),
        "bool": lambda: bool(b.any()),
        "nonzero": lambda: torch.nonzero(b),
        "masked_select": lambda: torch.masked_select(t, b),
        "unique": lambda: torch.unique(t),
        "boolean index": lambda: t[b],
        "repeat_interleave": lambda: torch.repeat_interleave(t, t),
        "0-d index": lambda: t[t[1]],
    }


@pytest.mark.parametrize("what", sorted(_reads()))
def test_detector_raises_at_host_reads(what):
    fn = _reads()[what]
    fn()                                        # fine outside a capture
    with pytest.raises(RC.HostDecision):
        with RC.capture_scope(torch.device("cpu")):
            fn()
    fn()                                        # the guards are gone


def test_detector_passes_sync_free_work():
    t = torch.arange(6)
    with RC.capture_scope(torch.device("cpu")):
        assert RC.capturing()
        n = (t > 2).sum(dtype=torch.int32)
        torch.repeat_interleave(t, t, output_size=15)
        torch.where(t > 2, t, 0).cumsum(0)
        with RC.host_reads_ok():
            assert t.numpy().sum() == 15
    assert not RC.capturing()
    assert int(n) == 3


def test_plan_reading_num_rows_falls_back():
    """A LIMIT without a sort reads its input's row count on the host
    (`int(db.num_rows)`): on the CPU the detector sees it and the plan
    runs eager."""
    s = _session(ON)
    t = pa.table({"x": np.arange(3000, dtype=np.int64)})
    q = s.from_arrow(t).filter(PE.GreaterThan(col("x"), lit(10))) \
        .limit(5).physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx).to_pydict()
    assert out == {"x": [11, 12, 13, 14, 15]}
    assert ctx.metrics.get("whole_plan_fallbacks") == 1
    assert "_local_scalar_dense" in C.decision(q)
    assert "exec/plan.py" in C.decision(q)


def test_host_constant_uploads_outside_a_graph():
    x = RC.host_constant(np.arange(4, dtype=np.int32), torch.device("cpu"))
    assert x.dtype == torch.int32 and x.tolist() == [0, 1, 2, 3]
    y = RC.host_constant([1, 2], torch.device("cpu"), torch.int64)
    assert y.dtype == torch.int64


def test_literal_reads_its_slot_when_bound():
    lit_ = PE.Literal(5)
    slot = torch.tensor(9, dtype=torch.int32)
    from spark_rapids_tpu_torch.plan.expressions import EvalCtx
    ctx = EvalCtx(4, 4, {}, None, torch.device("cpu"))
    assert lit_.eval_dev(ctx).data.tolist() == [5] * 4
    PE.set_literal_bindings({id(lit_): slot})
    try:
        assert lit_.eval_dev(ctx).data.tolist() == [9] * 4
    finally:
        PE.set_literal_bindings(None)
