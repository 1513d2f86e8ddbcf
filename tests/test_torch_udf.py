"""The port's UDFs (spark_rapids_tpu_torch/plan/udf.py): port copies of
tests/test_udf.py, each held against the JAX package on the same seeded
inputs, plus the port's own cases.

A TpuUDF's body is written once for both packages where it reads the
same in jnp and torch (`a * 2 + b` and the like: + - * / are
bit-identical, transcendental functions within 4 ulps).  The port casts
the function's result to the declared type; it passes a DECIMAL's
unscaled lane on both of its engines (ROADMAP Queue 3 item 17: the
reference's CPU engine gives the truncated value instead); under
`sql.compile.wholePlan=ON` a function that reads a device value on the
host runs eagerly, and a clean one is captured.
"""
import decimal
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan.aggregates import Count as JCount
from spark_rapids_tpu.plan.aggregates import Sum as JSum
from spark_rapids_tpu.plan.overrides import apply_overrides as japply
from spark_rapids_tpu.plan.udf import PythonUDF as JPythonUDF
from spark_rapids_tpu.plan.udf import TpuUDF as JTpuUDF
from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec import compiled as C
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.plan.overrides import apply_overrides
from spark_rapids_tpu_torch.plan.udf import _UDF_PIN, PythonUDF, TpuUDF

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

CPU = {"spark.rapids.tpu.sql.enabled": "false"}
ON = {"spark.rapids.tpu.sql.compile.wholePlan": "ON"}


def _tbl(n=1000):
    rng = np.random.default_rng(5)
    return pa.table({
        "x": pa.array(rng.integers(0, 100, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "y": pa.array(rng.standard_normal(n)),
    })


def _both(build_port, build_ref, tbl, conf=None):
    """(the port's answer on the device engine, on its CPU engine, the
    reference's device answer, its CPU oracle) of one plan shape."""
    def port(c):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return apply_overrides(build_port(L.LogicalScan(from_arrow(tbl))),
                                   TpuConf(dict(c)), device="cpu")
    dev = port(conf or {}).collect().to_pydict()
    cpu = port({**(conf or {}), **CPU}).collect().to_pydict()
    ref = japply(build_ref(JL.LogicalScan(tbl))).collect().to_pydict()
    oracle = japply(build_ref(JL.LogicalScan(tbl)), JConf(CPU)).collect() \
        .to_pydict()
    return dev, cpu, ref, oracle


def _bits(values):
    return np.array([np.nan if v is None else v for v in values],
                    np.float64).view(np.int64)


def test_tpu_udf_device_fused():
    def my_fn(x, y):
        if isinstance(x, torch.Tensor):
            return torch.sqrt(torch.abs(x.double()) + y * y)
        import jax.numpy as jnp
        return jnp.sqrt(jnp.abs(x.astype(jnp.float64)) + y * y)

    def port(scan):
        return L.LogicalProject([TpuUDF(my_fn, t.DOUBLE, E.ColumnRef("x"),
                                        E.ColumnRef("y"))], scan, names=["r"])

    def ref(scan):
        return JL.LogicalProject([JTpuUDF(my_fn, JT.DOUBLE, JE.ColumnRef("x"),
                                          JE.ColumnRef("y"))], scan,
                                 names=["r"])
    tbl = _tbl()
    q = apply_overrides(port(L.LogicalScan(from_arrow(tbl))), device="cpu")
    assert q.kind == "device", q.explain()
    dev, cpu, want, oracle = _both(port, ref, tbl)
    df = tbl.to_pandas()
    exp = np.sqrt(np.abs(df["x"]) + df["y"] ** 2)
    mask = df["x"].notna().to_numpy()
    got = np.array([np.nan if v is None else v for v in dev["r"]])
    assert np.allclose(got[mask], exp[mask], rtol=1e-9)
    assert all(v is None for v, m in zip(dev["r"], mask) if not m)
    # torch's CPU float64 sqrt may be an ulp off: within 4 ulps
    w = np.array([np.nan if v is None else v for v in want["r"]])
    for res in (dev, cpu, oracle):
        g = np.array([np.nan if v is None else v for v in res["r"]])
        assert np.array_equal(np.isnan(g), np.isnan(w))
        live = ~np.isnan(w)
        assert np.all(np.abs(g[live] - w[live]) <=
                      4 * np.spacing(np.abs(w[live])))


def test_tpu_udf_in_filter_and_agg():
    """The UDF runs inside the filter and the aggregation alike."""
    def double_it(x):
        return x * 2

    def port(scan):
        udf = TpuUDF(double_it, t.LONG, E.ColumnRef("x"))
        return L.LogicalAggregate(
            [], [(Sum(udf), "s"), (Count(None), "c")],
            L.LogicalFilter(E.GreaterThan(udf, E.Literal(50)), scan))

    def ref(scan):
        udf = JTpuUDF(double_it, JT.LONG, JE.ColumnRef("x"))
        return JL.LogicalAggregate(
            [], [(JSum(udf), "s"), (JCount(None), "c")],
            JL.LogicalFilter(JE.GreaterThan(udf, JE.Literal(50)), scan))
    tbl = _tbl()
    q = apply_overrides(port(L.LogicalScan(from_arrow(tbl))), device="cpu")
    assert q.kind == "device"
    dev, cpu, want, oracle = _both(port, ref, tbl)
    df = tbl.to_pandas()
    d = df["x"] * 2
    keep = d > 50
    assert dev["s"] == [int(d[keep & df["x"].notna()].sum())]
    assert dev == cpu == want == oracle


def test_tpu_udf_custom_validity():
    def clamped(pair):
        data, valid = pair
        # custom nulls: result invalid where data negative
        return data, valid & (data >= 0)

    def port(scan):
        return L.LogicalProject([TpuUDF(clamped, t.LONG, E.ColumnRef("x"),
                                        needs_validity=True)], scan,
                                names=["r"])

    def ref(scan):
        return JL.LogicalProject([JTpuUDF(clamped, JT.LONG, JE.ColumnRef("x"),
                                          needs_validity=True)], scan,
                                 names=["r"])
    tbl = pa.table({"x": pa.array([-5, 3, None, 7], pa.int64())})
    dev, cpu, want, oracle = _both(port, ref, tbl)
    assert dev["r"] == [None, 3, None, 7]
    assert dev == cpu == want == oracle


def test_tpu_udf_string_input_tagged():
    tbl = pa.table({"s": pa.array(["a", "b"])})
    q = apply_overrides(L.LogicalProject(
        [TpuUDF(lambda s: s, t.LONG, E.ColumnRef("s"))],
        L.LogicalScan(from_arrow(tbl)), names=["r"]), device="cpu")
    assert q.kind == "host"
    assert any("lanes are numeric" in r for r in q.meta.reasons)
    jq = japply(JL.LogicalProject(
        [JTpuUDF(lambda s: s, JT.LONG, JE.ColumnRef("s"))],
        JL.LogicalScan(tbl), names=["r"]))
    assert jq.kind == "host"


def test_python_udf_cpu_path():
    def slow_fn(x, y):
        return int(x) + round(float(y))

    def port(scan):
        return L.LogicalProject([PythonUDF(slow_fn, t.LONG, E.ColumnRef("x"),
                                           E.ColumnRef("y"))], scan,
                                names=["r"])

    def ref(scan):
        return JL.LogicalProject([JPythonUDF(slow_fn, JT.LONG,
                                             JE.ColumnRef("x"),
                                             JE.ColumnRef("y"))], scan,
                                 names=["r"])
    tbl = _tbl(100)
    q = apply_overrides(port(L.LogicalScan(from_arrow(tbl))), device="cpu")
    assert q.kind == "host"
    assert any("row-at-a-time" in r for r in q.meta.reasons)
    assert q.explain() == japply(ref(JL.LogicalScan(tbl))).explain()
    dev, cpu, want, oracle = _both(port, ref, tbl)
    df = tbl.to_pandas()
    for got, x, y in zip(dev["r"], df["x"], df["y"]):
        if x != x:       # null
            assert got is None
        else:
            assert got == int(x) + round(float(y))
    assert dev == cpu == want == oracle


def test_python_udf_feeds_device_parent():
    """CPU UDF project -> device aggregate via transitions."""
    fn = lambda x: int(x) % 7                      # noqa: E731

    def port(scan):
        return L.LogicalAggregate(
            [], [(Sum(E.ColumnRef("r")), "s")],
            L.LogicalProject([PythonUDF(fn, t.LONG, E.ColumnRef("x"))],
                             scan, names=["r"]))

    def ref(scan):
        return JL.LogicalAggregate(
            [], [(JSum(JE.ColumnRef("r")), "s")],
            JL.LogicalProject([JPythonUDF(fn, JT.LONG, JE.ColumnRef("x"))],
                              scan, names=["r"]))
    tbl = _tbl(200)
    q = apply_overrides(port(L.LogicalScan(from_arrow(tbl))), device="cpu")
    tree = q.physical_tree()
    assert "HashAggregateExec" in tree and "HostToDeviceExec" in tree
    dev, cpu, want, oracle = _both(port, ref, tbl)
    df = tbl.to_pandas()
    exp = int((df["x"].dropna().astype(int) % 7).sum())
    assert dev["s"] == [exp]
    assert dev == cpu == want == oracle


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------

def _seeded(n=512, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(-1000, 1000, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "b": pa.array(rng.standard_normal(n) * 100,
                      mask=rng.random(n) < 0.05),
        "c": pa.array(rng.integers(1, 50, n), pa.int64())})


@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_tpu_udf_arithmetic_is_bit_identical(op):
    """`a <op> b` over LONG and DOUBLE lanes: the same bits as the
    reference's device path and its oracle, on both of the port's
    engines."""
    fn = {"+": lambda a, b: a * 2 + b, "-": lambda a, b: a - b - 3.5,
          "*": lambda a, b: a * b * 0.5, "/": lambda a, b: b / (a + 0.25)}[op]

    def port(scan):
        return L.LogicalProject([TpuUDF(fn, t.DOUBLE, E.ColumnRef("a"),
                                        E.ColumnRef("b"))], scan, names=["r"])

    def ref(scan):
        return JL.LogicalProject([JTpuUDF(fn, JT.DOUBLE, JE.ColumnRef("a"),
                                          JE.ColumnRef("b"))], scan,
                                 names=["r"])
    dev, cpu, want, oracle = _both(port, ref, _seeded())
    for got in (dev, cpu):
        assert [v is None for v in got["r"]] == [v is None for v in want["r"]]
        assert np.array_equal(_bits(got["r"]), _bits(want["r"]))
    assert np.array_equal(_bits(want["r"]), _bits(oracle["r"]))


@pytest.mark.parametrize("name", ["exp", "log", "sin", "tanh"])
def test_tpu_udf_transcendental_within_4_ulps(name):
    tfn, nfn = {"exp": (torch.exp, np.exp), "log": (torch.log, np.log),
                "sin": (torch.sin, np.sin),
                "tanh": (torch.tanh, np.tanh)}[name]
    import jax.numpy as jnp
    jfn = getattr(jnp, name)

    def arg(b):
        # one operation each (the reference's compiler fuses a multiply
        # and an add into one rounding), log's away from 1, where an ulp
        # of a result near 0 measures neither
        return abs(b) + 2.0 if name == "log" else b * 0.01

    def port(scan):
        return L.LogicalProject([TpuUDF(lambda b: tfn(arg(b)), t.DOUBLE,
                                        E.ColumnRef("b"))], scan, names=["r"])

    def ref(scan):
        return JL.LogicalProject([JTpuUDF(lambda b: jfn(arg(b)), JT.DOUBLE,
                                          JE.ColumnRef("b"))], scan,
                                 names=["r"])
    dev, cpu, want, _oracle = _both(port, ref, _seeded())
    w = np.array([np.nan if v is None else v for v in want["r"]])
    for got in (dev, cpu):
        g = np.array([np.nan if v is None else v for v in got["r"]])
        live = ~np.isnan(w)
        assert np.array_equal(np.isnan(g), ~live)
        ulp = np.spacing(np.abs(w[live]))
        assert np.all(np.abs(g[live] - w[live]) <= 4 * ulp)


def test_tpu_udf_result_is_cast_to_the_declared_type():
    """torch gives float32 for int64 / int64 and float64 for a float
    literal: both come back as the declared type, on both engines."""
    tbl = _seeded()
    scan = L.LogicalScan(from_arrow(tbl))
    plan = L.LogicalProject(
        [TpuUDF(lambda a, c: a / c, t.DOUBLE, E.ColumnRef("a"),
                E.ColumnRef("c")),
         TpuUDF(lambda c: c * 1.5, t.LONG, E.ColumnRef("c")),
         TpuUDF(lambda c: c > 25, t.BOOLEAN, E.ColumnRef("c")),
         TpuUDF(lambda c: c * 2, t.INT, E.ColumnRef("c"))], scan,
        names=["q", "l", "g", "i"])
    for conf in ({}, CPU):
        q = apply_overrides(plan, TpuConf(conf), device="cpu")
        hb = q.collect()
        types = [c.dtype for c in hb.columns]
        assert types == [t.DOUBLE, t.LONG, t.BOOLEAN, t.INT]
        assert [c.data.dtype for c in hb.columns] == [
            np.float64, np.int64, np.bool_, np.int32]
        a = tbl.column("a").to_numpy(zero_copy_only=False)
        c = tbl.column("c").to_numpy().copy()
        live = ~np.isnan(a)
        # float32 division, widened: the declared type holds torch's value
        want_q = (torch.from_numpy(np.nan_to_num(a).astype(np.int64)) /
                  torch.from_numpy(c)).double().numpy()
        assert np.array_equal(hb.columns[0].data[live], want_q[live])
        assert hb.to_pydict()["l"] == [int(v * 1.5) for v in c.tolist()]
        assert hb.to_pydict()["i"] == [2 * v for v in c.tolist()]


def test_tpu_udf_over_decimal_sees_the_unscaled_lane_on_both_engines():
    """ROADMAP Queue 3 item 17: over DECIMAL(10,2) [1.20, 3.45, null]
    `a * 2` returning LONG gives [240, 690, null] on the reference's
    device path (the unscaled lane, as a RapidsUDF sees a cuDF decimal
    column) but [2, 6, null] on its CPU engine (each value truncated to
    an integer).  The port passes the unscaled lane on both engines."""
    tbl = pa.table({"d": pa.array([decimal.Decimal("1.20"),
                                   decimal.Decimal("3.45"), None],
                                  pa.decimal128(10, 2))})
    fn = lambda a: a * 2                          # noqa: E731
    port = L.LogicalProject([TpuUDF(fn, t.LONG, E.ColumnRef("d"))],
                            L.LogicalScan(from_arrow(tbl)), names=["r"])
    for conf in ({}, CPU):
        got = apply_overrides(port, TpuConf(conf), device="cpu").collect()
        assert got.to_pydict() == {"r": [240, 690, None]}
    ref = JL.LogicalProject([JTpuUDF(fn, JT.LONG, JE.ColumnRef("d"))],
                            JL.LogicalScan(tbl), names=["r"])
    assert japply(ref).collect().to_pydict() == {"r": [240, 690, None]}
    assert japply(ref, JConf(CPU)).collect().to_pydict() == \
        {"r": [2, 6, None]}


def test_tpu_udf_pins_its_function():
    """The plan cache keys on the function's id: the function lives as
    long as the process, so no recycled id finds another's graph."""
    def make():
        return lambda a: a + 1
    udf = TpuUDF(make(), t.LONG, E.ColumnRef("a"))
    fn_id = id(udf.fn)
    del udf
    assert _UDF_PIN[fn_id] is not None and id(_UDF_PIN[fn_id]) == fn_id


def _on_query(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = L.LogicalAggregate(
            [], [(Sum(E.ColumnRef("r")), "s"), (Count(None), "n")],
            L.LogicalProject([TpuUDF(fn, t.LONG, E.ColumnRef("c"))],
                             L.LogicalScan(from_arrow(_seeded())),
                             names=["r"]))
        return apply_overrides(plan, TpuConf(ON), device="cpu")


def test_syncing_tpu_udf_runs_eagerly_under_capture():
    """A function that reads a device value on the host (`.item()`)
    raises HostDecision under the detector: the plan runs eagerly and
    gives the eager answer."""
    C.clear_caches()

    def syncing(c):
        return c * int(c.max().item())
    q = _on_query(syncing)
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_fallbacks") == 1
    assert "whole_plan_compiled_queries" not in ctx.metrics
    assert C.decision(q).startswith("fallback: HostDecision")
    c = _seeded().column("c").to_numpy()
    assert got == {"s": [int((c * c.max()).sum())], "n": [len(c)]}
    C.clear_caches()


def test_boolean_index_tpu_udf_runs_eagerly_under_capture():
    C.clear_caches()

    def masked(c):
        out = c.clone()
        out[c > 25] = 0                          # a boolean index
        return out
    q = _on_query(masked)
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    c = _seeded().column("c").to_numpy()
    want = {"s": [int(np.where(c > 25, 0, c).sum())], "n": [len(c)]}
    if ctx.metrics.get("whole_plan_fallbacks"):
        assert C.decision(q).startswith("fallback: HostDecision")
    assert got == want
    C.clear_caches()


def test_clean_tpu_udf_is_captured():
    C.clear_caches()
    q = _on_query(lambda c: c * 3 + 1)
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert ctx.metrics.get("whole_plan_compiled_queries") == 1, \
        C.decision(q)
    assert not ctx.metrics.get("whole_plan_fallbacks")
    c = _seeded().column("c").to_numpy()
    assert got == {"s": [int((c * 3 + 1).sum())], "n": [len(c)]}
    # a replay gives the same answer
    assert q.collect(ExecContext(q.conf, q.device)).to_pydict() == got
    C.clear_caches()


ROW_RESULTS = [
    ([1, None, 3], "int32"), ([300], "int8"), ([2 ** 70], "int64"),
    ([True], "int64"), ([1.5, None], "float64"), ([1, 2.5], "float32"),
    ([True, None], "bool"), ([1], "bool"), ([1e300], "float32"),
    ([1.5, 2.0], "int64"), (["a", None, "b"], "string"), ([1], "string"),
    ([decimal.Decimal("1.2"), None], "dec"),
    ([decimal.Decimal("1.234")], "dec"), ([1.5], "dec"), ([1], "dec"),
    ([decimal.Decimal("123456789.1")], "dec")]


@pytest.mark.parametrize("values,kind", ROW_RESULTS)
def test_row_udf_results_build_as_pyarrow_builds_them(values, kind):
    """A PythonUDF's results become a column of the declared type where
    pyarrow's `pa.array(values, type)` builds one, with its values, and
    raise where it raises (the vectorized path and the per-value one
    alike)."""
    from spark_rapids_tpu_torch.columnar.host import column_from_values
    pt = {"int8": t.BYTE, "int32": t.INT, "int64": t.LONG,
          "float32": t.FLOAT, "float64": t.DOUBLE, "bool": t.BOOLEAN,
          "string": t.STRING, "dec": t.DecimalType(10, 2)}[kind]
    at = {"int8": pa.int8(), "int32": pa.int32(), "int64": pa.int64(),
          "float32": pa.float32(), "float64": pa.float64(),
          "bool": pa.bool_(), "string": pa.string(),
          "dec": pa.decimal128(10, 2)}[kind]
    try:
        want = pa.array(values, at).to_pylist()
    except (pa.ArrowException, OverflowError, TypeError, ValueError):
        with pytest.raises((OverflowError, TypeError, ValueError)):
            column_from_values(values, pt)
        return
    got = column_from_values(values, pt).to_pylist()
    assert got == want
