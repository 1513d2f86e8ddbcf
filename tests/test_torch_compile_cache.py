"""The plan cache, constant lifting, the shared scan upload and the
background capture service (spark_rapids_tpu_torch/exec/compiled.py,
runtime/compile_service.py): port copies of the cases of
tests/test_compile_cache.py that apply.  The persistent XLA cache has no
counterpart (config.RESOLVED `compile.cacheDir`), nor does the eager
per-operator jit cache.

  * constant-lifted canonical keys: literal-only variants share ONE
    captured program, each equal to the CPU oracle; with lifting off
    they capture apart; no sharing across tables; canonical fingerprints
    equal the reference's on the same expressions;
  * bucket quantization: an explicit `sql.shape.buckets` set, captured
    plans at off-bucket row counts;
  * the shared scan upload's LRU byte cap, prewarm;
  * background segment captures: adopted, deduplicated, re-raised on the
    consuming thread, and off by conf.
"""
import warnings

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec import compiled as C
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan.aggregates import Sum
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col, lit
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ON = {"spark.rapids.tpu.sql.compile.wholePlan": "ON"}
CPU = {"spark.rapids.tpu.sql.enabled": "false"}
LIFT_OFF = {"spark.rapids.tpu.sql.compile.constantLifting": "false"}


@pytest.fixture(autouse=True)
def _fresh_caches():
    C.clear_caches()
    yield
    C.clear_caches()


def _session(conf=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return PSession(dict(conf or {}), device="cpu")


def _rows(hb) -> list:
    d = hb.to_pydict()
    cols = sorted(d)
    return sorted(zip(*(d[c] for c in cols)), key=repr)


def _approx_eq(a, b) -> bool:
    """Row-order-insensitive equality with a float tail (group-by output
    order is engine-defined)."""
    ra, rb = _rows(a), _rows(b)
    if len(ra) != len(rb):
        return False
    for x, y in zip(ra, rb):
        for u, v in zip(x, y):
            if u == v:
                continue
            if isinstance(u, float) and isinstance(v, float) and \
                    abs(u - v) <= 1e-9 * max(1.0, abs(u), abs(v)):
                continue
            return False
    return True


def _oracle(df):
    """The port's CPU engine (sql.enabled=false) over the same plan."""
    return PDF(df._plan, _session(CPU)).collect()


def _gt(c, v):
    return PE.GreaterThan(col(c), lit(v))


def _host(tbl):
    """The port's host table of an Arrow table.  The source table is the
    cache's identity: plans share a program (and an upload) when they
    read the same HostBatch (`session.from_arrow` converts anew)."""
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    return from_arrow(tbl)


# ---------------------------------------------------------------------------
# constant-lifted canonical keys
# ---------------------------------------------------------------------------

def test_literal_variants_share_one_program():
    rng = np.random.default_rng(11)
    tbl = _host(pa.table({"k": np.arange(400, dtype=np.int64) % 9,
                          "v": rng.random(400)}))
    s = _session(ON)

    def q(th):
        return s.from_host(tbl).filter(_gt("v", th)) \
            .group_by("k").agg((Sum(col("v")), "sv"))

    d1, d2 = q(0.25), q(0.75)
    c1, c2 = ExecContext(s.conf, s.device), ExecContext(s.conf, s.device)
    q1, q2 = d1.physical(), d2.physical()
    r1, r2 = q1.collect(c1), q2.collect(c2)
    assert c1.metrics.get("compile_cache_misses") == 1
    assert c1.metrics.get("whole_plan_compiled_queries") == 1
    assert not c2.metrics.get("compile_cache_misses")
    assert c2.metrics.get("whole_plan_structure_hits") == 1
    assert c2.metrics.get("whole_plan_compiled_queries") == 1
    assert C.plan_programs(q1)[0] is C.plan_programs(q2)[0]
    assert _approx_eq(r1, _oracle(d1))
    assert _approx_eq(r2, _oracle(d2))
    assert not _approx_eq(r1, r2)


def test_literal_variants_with_lifting_off_capture_apart():
    tbl = _host(pa.table({"v": np.random.default_rng(12).random(300)}))
    s = _session({**ON, **LIFT_OFF})

    def q(th):
        return s.from_host(tbl).filter(_gt("v", th)) \
            .agg((Sum(col("v")), "sv"))

    c1, c2 = ExecContext(s.conf, s.device), ExecContext(s.conf, s.device)
    r1 = q(0.2).physical().collect(c1)
    r2 = q(0.8).physical().collect(c2)
    assert c1.metrics.get("compile_cache_misses") == 1
    assert c2.metrics.get("compile_cache_misses") == 1
    assert not c2.metrics.get("whole_plan_structure_hits")
    assert _approx_eq(r1, _oracle(q(0.2)))
    assert _approx_eq(r2, _oracle(q(0.8)))


def test_no_false_sharing_across_tables():
    """The same canonical structure over OTHER tables (other string
    dictionaries) never reuses the first table's program."""
    s = _session(ON)
    t1 = pa.table({"g": ["a", "b", "a", "c"] * 25,
                   "v": np.arange(100, dtype=np.float64)})
    t2 = pa.table({"g": ["x", "y", "z", "x"] * 25,
                   "v": np.arange(100, dtype=np.float64)})

    def q(tbl):
        return s.from_arrow(tbl).filter(_gt("v", 10.0)) \
            .group_by("g").agg((Sum(col("v")), "sv"))

    c1, c2 = ExecContext(s.conf, s.device), ExecContext(s.conf, s.device)
    p1, p2 = q(t1).physical(), q(t2).physical()
    r1, r2 = p1.collect(c1), p2.collect(c2)
    assert set(r1.to_pydict()["g"]) == {"a", "b", "c"}
    assert set(r2.to_pydict()["g"]) == {"x", "y", "z"}
    assert c2.metrics.get("compile_cache_misses") == 1
    assert C.plan_programs(p1)[0] is not C.plan_programs(p2)[0]
    assert _approx_eq(r1, _oracle(q(t1)))
    assert _approx_eq(r2, _oracle(q(t2)))


def _fp_cases(E, T):
    x, f = E.ColumnRef("x"), E.ColumnRef("f")
    return [
        E.GreaterThan(x, E.Literal(5)),
        E.GreaterThan(x, E.Literal(9)),
        E.In(x, [5]),
        E.EqualTo(x, E.Literal(None, T.LONG)),
        E.Add(x, E.Literal(7)),
        E.Multiply(f, E.Literal(2.5)),
        E.If(E.LessThan(f, E.Literal(0.0)), E.Literal(-1.0), f),
        E.Coalesce(x, E.Literal(99)),
        E.CaseWhen([(E.GreaterThan(x, E.Literal(3)), E.Literal(1))],
                   E.Literal(0)),
        E.Literal(42),
        E.And(E.IsNotNull(x), E.Not(E.LessThanOrEqual(x, E.Literal(2)))),
        E.Cast(E.Add(x, E.Literal(1)), T.DOUBLE),
    ]


@pytest.mark.parametrize("i", range(12))
def test_canonical_fingerprint_equals_the_reference(i):
    js = JT.StructType([JT.StructField("x", JT.LONG),
                        JT.StructField("f", JT.DOUBLE)])
    ps = PT.StructType([PT.StructField("x", PT.LONG),
                        PT.StructField("f", PT.DOUBLE)])
    want = _fp_cases(JE, JT)[i].bind(js).canonical_fingerprint()
    got = _fp_cases(PE, PT)[i].bind(ps).canonical_fingerprint()
    assert got == want


def test_canonical_fingerprint_erases_only_lifted_positions():
    schema = PT.StructType([PT.StructField("x", PT.LONG)])
    a = PE.GreaterThan(PE.ColumnRef("x"), PE.Literal(5)).bind(schema)
    b = PE.GreaterThan(PE.ColumnRef("x"), PE.Literal(9)).bind(schema)
    assert a.canonical_fingerprint() == b.canonical_fingerprint()
    assert a.fingerprint() != b.fingerprint()
    in5 = PE.In(PE.ColumnRef("x"), [5]).bind(schema)
    in9 = PE.In(PE.ColumnRef("x"), [9]).bind(schema)
    assert in5.canonical_fingerprint() != in9.canonical_fingerprint()
    n = PE.EqualTo(PE.ColumnRef("x"), PE.Literal(None, PT.LONG)).bind(schema)
    assert "None" in n.canonical_fingerprint()


def test_lifted_literal_expressions_match_cpu_oracle():
    """Lifting changes how a value enters the graph, never what it
    computes: a captured projection of each literal position equals the
    eager engine and the CPU engine, and a literal variant replaying the
    same program gives its own values."""
    tbl = _host(pa.table({"x": pa.array([1, 2, None, 4, 5], pa.int64()),
                          "f": pa.array([0.5, -1.5, 2.5, None, 4.0])}))

    def exprs(k):
        x, f = PE.ColumnRef("x"), PE.ColumnRef("f")
        return [PE.Add(x, PE.Literal(7 + k)),
                PE.Multiply(f, PE.Literal(2.5 + k)),
                PE.GreaterThan(x, PE.Literal(2 + k)),
                PE.If(PE.LessThan(f, PE.Literal(0.0 + k)),
                      PE.Literal(-1.0 - k), f),
                PE.Coalesce(x, PE.Literal(99 + k)),
                PE.CaseWhen([(PE.GreaterThan(x, PE.Literal(3 + k)),
                              PE.Literal(1 + k))], PE.Literal(0)),
                PE.Literal(42 + k)]

    names = [f"e{i}" for i in range(7)]
    s = _session(ON)
    progs = []
    for k in (0, 1):
        df = s.from_host(tbl).select(*exprs(k), names=names)
        q = df.physical()
        ctx = ExecContext(q.conf, q.device)
        got = q.collect(ctx).to_pydict()
        assert ctx.metrics.get("whole_plan_compiled_queries") == 1
        progs += C.plan_programs(q)
        eager = PDF(df._plan, _session()).collect().to_pydict()
        assert got == eager
        assert got == _oracle(df).to_pydict()
    assert progs[0] is progs[1]


# ---------------------------------------------------------------------------
# bucket quantization
# ---------------------------------------------------------------------------

def test_explicit_bucket_set_quantizes_capacities():
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    conf = TpuConf({"spark.rapids.tpu.sql.shape.buckets": "1024,8192"})
    assert bucket_capacity(1, conf) == 1024
    assert bucket_capacity(1024, conf) == 1024
    assert bucket_capacity(1025, conf) == 8192
    assert bucket_capacity(8192, conf) == 8192
    assert bucket_capacity(8193, conf) == 16384
    assert bucket_capacity(40000, conf) == 65536


@pytest.mark.parametrize("rows", [1, 1023, 1025, 2999, 9000])
def test_bucket_quantized_capture_matches_oracle(rows):
    rng = np.random.default_rng(rows)
    tbl = pa.table({"k": (np.arange(rows) % 5).astype(np.int64),
                    "v": rng.random(rows)})
    s = _session({**ON, "spark.rapids.tpu.sql.shape.buckets": "1024,8192"})
    df = s.from_arrow(tbl).filter(_gt("v", 0.5)) \
        .group_by("k").agg((Sum(col("v")), "sv"))
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx)
    assert ctx.metrics.get("whole_plan_compiled_queries") == 1
    assert _approx_eq(out, _oracle(df))


def test_same_bucket_row_counts_match_oracle():
    s = _session({**ON, "spark.rapids.tpu.sql.shape.buckets": "8192"})
    for rows in (2000, 7000):          # one bucket, 8192
        tbl = pa.table({"v": np.arange(rows, dtype=np.float64)})
        df = s.from_arrow(tbl).filter(_gt("v", 3.0)) \
            .agg((Sum(col("v")), "sv"))
        q = df.physical()
        ctx = ExecContext(q.conf, q.device)
        out = q.collect(ctx)
        assert ctx.metrics.get("whole_plan_compiled_queries") == 1
        assert _approx_eq(out, _oracle(df))


# ---------------------------------------------------------------------------
# the shared scan upload, prewarm
# ---------------------------------------------------------------------------

def test_scan_upload_shared_across_plans():
    from spark_rapids_tpu_torch.columnar.device import (UPLOADS,
                                                        reset_upload_counts)
    s = _session(ON)
    tbl = _host(pa.table({"v": np.arange(3000, dtype=np.float64),
                          "w": np.arange(3000, dtype=np.int64)}))
    df = s.from_host(tbl)
    df.filter(_gt("v", 5.0)).agg((Sum(col("v")), "sv")).collect()
    reset_upload_counts()
    # another plan over the same table: no upload of the columns it shares
    out = df.filter(_gt("v", 9.0)).agg((Sum(col("v")), "sv")).collect()
    assert UPLOADS["bytes"] == 0
    assert out.to_pydict()["sv"] == [float(sum(range(10, 3000)))]


def test_scan_upload_cache_byte_cap_evicts_lru():
    before = C.SCAN_UPLOAD_EVICTIONS["count"]
    s = _session({**ON, "spark.rapids.tpu.sql.scan.uploadCacheBytes":
                  str(32 * 1024)})
    tables = [pa.table({"v": np.arange(2000, dtype=np.float64) + i})
              for i in range(4)]
    for tbl in tables:
        s.from_arrow(tbl).agg((Sum(col("v")), "sv")).collect()
    assert C.SCAN_UPLOAD_EVICTIONS["count"] > before
    total = sum(e[2] for e in C._SCAN_UPLOAD_CACHE.values())
    assert total <= 32 * 1024 or len(C._SCAN_UPLOAD_CACHE) == 1


def test_prewarm_captures_without_running():
    tbl = pa.table({"v": np.arange(500, dtype=np.float64)})
    s = _session(ON)
    df = s.from_arrow(tbl).filter(_gt("v", 9.0)).agg((Sum(col("v")), "sv"))
    q = df.physical()
    assert q.prewarm() is True
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx)
    assert not ctx.metrics.get("compile_cache_misses")
    assert _approx_eq(out, _oracle(df))
    assert _session().from_arrow(tbl).filter(_gt("v", 9.0)).agg(
        (Sum(col("v")), "sv")).physical().prewarm() is False


# ---------------------------------------------------------------------------
# background segment captures
# ---------------------------------------------------------------------------

def _split_session(extra=None):
    return _session({**ON,
                     "spark.rapids.tpu.sql.compile.seamSplitMinRows": "1024",
                     **(extra or {})})


def _split_query(s):
    n = 5000
    t1 = pa.table({"k": (np.arange(n) % 50).astype(np.int64),
                   "v": np.random.default_rng(0).random(n)})
    t2 = pa.table({"k": np.arange(50, dtype=np.int64),
                   "w": np.arange(50, dtype=np.float64)})
    return (s.from_arrow(t1).join(s.from_arrow(t2), on="k")
            .filter(_gt("v", 0.5))
            .group_by("k").agg((Sum(col("w")), "sw"))
            .sort(("sw", False, False)).limit(10))


def test_background_segment_captures_are_adopted_and_correct():
    s = _split_session()
    df = _split_query(s)
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx)
    assert ctx.metrics.get("whole_plan_split_queries") == 1
    assert ctx.metrics.get("compile_background_used", 0) >= 1
    o = _oracle(df).to_pydict()
    got = out.to_pydict()
    assert got["k"] == o["k"]
    np.testing.assert_allclose(got["sw"], o["sw"], rtol=1e-9)


def test_a_split_plan_built_anew_adopts_its_segments_and_is_correct():
    """The same query planned twice: the second plan's background
    capture of its later segment finds the first plan's graph in the
    plan cache (a structure hit), and the replay binds the real seam
    output, not the placeholder the background capture keyed on."""
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    n = 5000
    t1 = from_arrow(pa.table({"k": (np.arange(n) % 50).astype(np.int64),
                              "v": np.random.default_rng(0).random(n)}))
    t2 = from_arrow(pa.table({"k": np.arange(50, dtype=np.int64),
                              "w": np.arange(50, dtype=np.float64)}))

    def query(s):
        # the same host tables each time: plans share graphs over them
        return (s.from_host(t1).join(s.from_host(t2), on="k")
                .filter(_gt("v", 0.5))
                .group_by("k").agg((Sum(col("w")), "sw"))
                .sort(("sw", False, False)).limit(10))
    s = _split_session()
    first = query(s).collect().to_pydict()
    df = query(s)
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_split_queries") == 1
    assert ctx.metrics.get("whole_plan_structure_hits", 0) >= 1
    o = _oracle(df).to_pydict()
    assert got["k"] == o["k"] == first["k"]
    np.testing.assert_allclose(got["sw"], o["sw"], rtol=1e-9)


def test_no_background_capture_outlives_its_collect(monkeypatch):
    """A split plan's collect waits for the speculative captures it did
    not use: none runs on after it (CUDA refuses a device-wide
    synchronize while any stream captures) or over the restored tree."""
    import time
    from spark_rapids_tpu_torch.runtime import compile_service as CS
    tasks = []
    real = CS.CompileService.submit

    def unused_slow_submit(self, key, fn):
        # under another key: the seam never takes it, and captures inline
        def slow():
            time.sleep(0.3)
            return fn()
        task = real(self, ("unused",) + key, slow)
        tasks.append(task)
        return task
    monkeypatch.setattr(CS.CompileService, "submit", unused_slow_submit)
    df = _split_query(_split_session())
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    q.collect(ctx)
    assert not ctx.metrics.get("compile_background_used")
    assert tasks and all(t.done.is_set() for t in tasks)


def test_background_disabled_still_correct():
    s = _split_session({"spark.rapids.tpu.compile.background.enabled":
                        "false"})
    df = _split_query(s)
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    out = q.collect(ctx)
    assert ctx.metrics.get("whole_plan_split_queries") == 1
    assert not ctx.metrics.get("compile_background_used")
    assert out.to_pydict()["k"] == _oracle(df).to_pydict()["k"]


def test_compile_service_dedupes_and_reraises():
    from spark_rapids_tpu_torch.config import DEFAULT_CONF
    from spark_rapids_tpu_torch.runtime.compile_service import get_service
    svc = get_service(DEFAULT_CONF)
    t1 = svc.submit(("t", 1), lambda: 41 + 1)
    assert svc.submit(("t", 1), lambda: 0) is t1      # deduplicated
    assert t1.wait() == 42

    def boom():
        raise ValueError("injected")

    t2 = svc.submit(("t", 2), boom)
    with pytest.raises(ValueError, match="injected"):
        t2.wait()
    assert svc.take(("t", 1)) is t1
    assert svc.take(("t", 2)) is t2
    assert svc.take(("t", 1)) is None


def test_compile_service_runs_each_key_once_under_contention():
    """Sixteen threads submit and take the same keys at once: each key's
    function runs exactly once, and every waiter sees its result."""
    import sys
    import threading
    from spark_rapids_tpu_torch.runtime.compile_service import CompileService
    svc = CompileService(4)
    runs = {k: 0 for k in range(40)}
    lock = threading.Lock()
    got = []

    def fn(k):
        def run():
            with lock:
                runs[k] += 1
            return k * 10
        return run

    def worker():
        for k in range(40):
            got.append(svc.submit(("s", k), fn(k)).wait(timeout=30))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        svc._pool.shutdown(wait=True)
    assert not any(t.is_alive() for t in threads)
    assert all(n == 1 for n in runs.values()), runs
    assert sorted(got) == sorted(k * 10 for k in range(40) for _ in range(16))
