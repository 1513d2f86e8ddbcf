"""The PyTorch/CUDA port's segmented-aggregation kernels against the
reference Pallas kernels.

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernels (interpret mode, as tests/test_pallas_kernels.py runs
them on the CPU) and through the port's wrappers on CPU tensors, which
run the kernels' plain PyTorch versions.  Integer sums are exact,
including two's-complement wraparound; float64 sums agree to rtol 1e-12
(the reference's block matmul and the port re-associate differently,
the variableFloatAgg contract); MIN/MAX are bit-identical.

The CUDA kernels themselves are held against the same plain versions on
the card by chip_smoke.py and by tests/test_torch_cuda.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops.pallas import segagg as JS
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops import groupby as PG
from spark_rapids_tpu_torch.ops import hopper as PH
from spark_rapids_tpu_torch.ops.hopper import segagg as PS
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON"}


def _seg(rng, cap, domain, dead=0.1, dist="uniform"):
    """Bucket ids: uniform over the domain; "one" puts every live row in
    one bucket; "q1" gives TPC-H q1's skew (about half the rows in one of
    four occupied buckets, as l_returnflag x l_linestatus packs)."""
    if dist == "one":
        seg = np.full(cap, domain // 2, np.int32)
    elif dist == "q1":
        occupied = np.arange(4) * max(domain // 4, 1) % domain
        seg = rng.choice(occupied, cap, p=[0.25, 0.0026, 0.4974, 0.25]) \
            .astype(np.int32)
    else:
        seg = rng.integers(0, domain, cap).astype(np.int32)
    seg[rng.random(cap) < dead] = domain          # dead rows carry D
    return seg


# ---------------------------------------------------------------------------
# seg_sums vs _seg_matmul_sums
# ---------------------------------------------------------------------------

_SUMS_CASES = [
    (1024, 12, 3, 1, "uniform"), (2048, 7, 1, 2, "uniform"),
    (4096, 64, 5, 0, "uniform"), (1024, 3, 0, 2, "uniform"),
    (1024, 1, 2, 1, "uniform"), (2048, 12, 19, 1, "one"),
    (2048, 12, 19, 1, "q1"), (1, 12, 3, 1, "uniform"),
    (31, 12, 3, 1, "uniform"), (3001, 7, 2, 2, "q1")]


@pytest.mark.parametrize(
    "cap,domain,ki,kf,dist", _SUMS_CASES,
    ids=["-".join(map(str, c[:4])) + ("" if c[4] == "uniform" else
                                      f"-{c[4]}") for c in _SUMS_CASES])
def test_seg_sums_matches_pallas(cap, domain, ki, kf, dist):
    rng = np.random.default_rng(cap * 31 + domain)
    seg = _seg(rng, cap, domain, dist=dist)
    ints = [rng.integers(-2 ** 62, 2 ** 62, cap) for _ in range(ki)]
    if ki:
        ints[0][:64] = 2 ** 63 - 1                # forces int64 wraparound
    f64s = [rng.random(cap) * 1e3 for _ in range(kf)]
    iacc, facc = JS._seg_matmul_sums(
        jnp.asarray(seg), [jnp.asarray(x) for x in ints],
        [jnp.asarray(x) for x in f64s], domain, cap, interpret=True)
    pi, pf = PS.seg_sums(torch.from_numpy(seg),
                         [torch.from_numpy(x) for x in ints],
                         [torch.from_numpy(x) for x in f64s], domain)
    assert pi.shape == (domain, ki) and pf.shape == (domain, kf)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(iacc)[:, :ki])
    np.testing.assert_allclose(pf.numpy(), np.asarray(facc)[:, :kf],
                               rtol=1e-12, atol=0)


def test_seg_sums_all_dead_rows_are_zero():
    seg = torch.full((2048,), 5, dtype=torch.int32)
    lane = torch.arange(2048, dtype=torch.int64)
    pi, pf = PS.seg_sums(seg, [lane], [lane.to(torch.float64)], 5)
    assert not pi.any() and not pf.any()


# ---------------------------------------------------------------------------
# seg_reduce vs _seg_reduce
# ---------------------------------------------------------------------------

def _lane(rng, dtype, cap):
    if dtype == "float64":
        x = rng.standard_normal(cap)
        x[::13] = 0.0
        x[5::13] = -0.0
        x[7::29] = np.inf
        x[11::31] = -np.inf
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, cap, dtype=dtype,
                        endpoint=True)


def _ident(dtype, is_min):
    if dtype == "float64":
        return np.inf if is_min else -np.inf
    info = np.iinfo(dtype)
    return info.max if is_min else info.min


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


# "<lane dtype>" at capacity 2048, or "<dtype>-<distribution or cap>"
@pytest.mark.parametrize("dtype", [
    "int32", "int64", "float64", "int8", "int16", "int64-one",
    "float64-one", "int32-q1", "int64-q1", "float64-q1", "int64-cap1",
    "int32-cap31", "float64-cap3001"])
@pytest.mark.parametrize("is_min", [True, False])
def test_seg_reduce_matches_pallas(dtype, is_min):
    dtype, _, case = dtype.partition("-")
    cap = int(case[3:]) if case.startswith("cap") else 2048
    dist = case if case in ("one", "q1") else "uniform"
    domain = 12
    rng = np.random.default_rng(len(dtype) * 7 + is_min)
    seg = _seg(rng, cap, domain, dist=dist)
    lane = _lane(rng, dtype, cap)
    ident = _ident(dtype, is_min)
    want = JS._seg_reduce(jnp.asarray(seg), jnp.asarray(lane), domain, cap,
                          is_min, ident, interpret=True)
    got = PS.seg_reduce(torch.from_numpy(seg), torch.from_numpy(lane),
                        domain, is_min, ident)
    assert got.dtype == torch.from_numpy(lane).dtype
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_seg_reduce_zero_and_inf_ties_follow_double_compare():
    # -0.0 < +0.0 in MIN/MAX (Java Double.compare), as the reference's
    # reductions give; one bucket holds both infinities
    seg = torch.tensor([0, 0, 0, 1, 1, 1, 2], dtype=torch.int32)
    lane = torch.tensor([0.0, -0.0, 0.0, np.inf, -0.0, -np.inf, 1.0],
                        dtype=torch.float64)
    mn = PS.seg_reduce(seg, lane, 3, True, np.inf)
    mx = PS.seg_reduce(seg, lane, 3, False, -np.inf)
    assert math.copysign(1.0, mn[0].item()) == -1.0 and mn[0] == 0.0
    assert math.copysign(1.0, mx[0].item()) == 1.0 and mx[0] == 0.0
    assert mn[1].item() == -np.inf and mx[1].item() == np.inf


# ---------------------------------------------------------------------------
# the glue: segagg_groupby_trace vs pallas_groupby_trace, every kind
# ---------------------------------------------------------------------------

_KINDS = [("sum", 0), ("sum", 1), ("count", 0), ("count_all", -1),
          ("min", 0), ("max", 0), ("min", 1), ("max", 1), ("min", 2),
          ("max", 2), ("min", 3), ("max", 3), ("first", 0), ("last", 0),
          ("first_nn", 1), ("last_nn", 1), ("any", 3), ("every", 3)]
_INPUT_TYPES = [(JT.LONG, PT.LONG), (JT.DOUBLE, PT.DOUBLE),
                (JT.INT, PT.INT), (JT.BOOLEAN, PT.BOOLEAN)]


def _glue_inputs(cap, seed):
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, 3, cap).astype(np.int32)
    k0v = rng.random(cap) > 0.1
    k1 = rng.random(cap) > 0.5
    k1v = np.ones(cap, bool)
    f = rng.standard_normal(cap)
    f[::17] = np.nan
    f[3::19] = -0.0
    f[4::19] = 0.0
    data = [rng.integers(-2 ** 40, 2 ** 40, cap), f,
            rng.integers(-1000, 1000, cap).astype(np.int32),
            rng.random(cap) > 0.3]
    valid = [rng.random(cap) > 0.2 for _ in data]
    live = rng.random(cap) > 0.15
    return (k0, k0v, k1, k1v), data, valid, live


def _spec_out_type(kind, in_idx):
    if kind in ("count", "count_all"):
        return JT.LONG, PT.LONG
    return _INPUT_TYPES[in_idx]


@pytest.mark.parametrize("cap", [1024, 2048])
def test_segagg_glue_matches_pallas_every_kind(cap):
    (k0, k0v, k1, k1v), data, valid, live = _glue_inputs(cap, cap)
    pack = ((0, 4), (0, 3))
    jspecs, pspecs = [], []
    for kind, idx in _KINDS:
        jt, pt = _spec_out_type(kind, idx)
        jspecs.append(JG.AggSpec(kind, idx, jt))
        pspecs.append(PG.AggSpec(kind, idx, pt))
    jfn = jax.jit(JS.pallas_groupby_trace(
        pack, [(JT.STRING, True, "int32"), (JT.BOOLEAN, True, "bool")],
        jspecs, cap, cap, True))
    jk, jo, jn = jfn((jnp.asarray(k0), jnp.asarray(k1)),
                     (jnp.asarray(k0v), jnp.asarray(k1v)),
                     tuple(jnp.asarray(d) for d in data),
                     tuple(jnp.asarray(v) for v in valid),
                     jnp.asarray(live))
    pfn = PS.segagg_groupby_trace(
        pack, [(PT.STRING, True, torch.int32), (PT.BOOLEAN, True,
                                                torch.bool)],
        pspecs, cap, cap)
    pk, po, pn = pfn([torch.from_numpy(k0), torch.from_numpy(k1)],
                     [torch.from_numpy(k0v), torch.from_numpy(k1v)],
                     [torch.from_numpy(d) for d in data],
                     [torch.from_numpy(v) for v in valid],
                     torch.from_numpy(live))
    ng = int(jn)
    assert int(pn) == ng
    for (jd, jv), (pd, pv) in zip(jk, pk):
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        m = np.asarray(jv)
        np.testing.assert_array_equal(pd.numpy()[m], np.asarray(jd)[m])
    for (kind, idx), (jd, jv), (pd, pv) in zip(_KINDS, jo, po):
        m = np.asarray(jv)
        np.testing.assert_array_equal(pv.numpy(), m, err_msg=kind)
        got, want = pd.numpy()[m], np.asarray(jd)[m]
        if kind == "sum" and idx == 1:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{kind}({idx})")


# ---------------------------------------------------------------------------
# query level (mirrors tests/test_pallas_kernels.py segagg parity)
# ---------------------------------------------------------------------------

def _agg_table(n=4096):
    rng = np.random.default_rng(11)
    return pa.table({
        "flag": pa.array([["A", "B", "C", None][i % 4] for i in range(n)]),
        "qty": pa.array(rng.integers(-(10 ** 12), 10 ** 12, n), pa.int64()),
        "price": pa.array(rng.standard_normal(n)),
    })


def _both(build_j, build_p, table):
    jdf = build_j(JSession(PALLAS_ON).from_arrow(table))
    got = build_p(PSession(device="cpu").from_arrow(table)).to_pydict()
    want = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    return got, want, oracle


def test_segagg_int_sums_exact_and_floats_close():
    def build(m, c):
        return lambda df: df.group_by("flag").agg(
            (m.Sum(c("qty")), "sq"), (m.Min(c("qty")), "mn"),
            (m.Max(c("qty")), "mx"), (m.Sum(c("price")), "sp"),
            (m.Count(c("qty")), "c")).sort(("flag", True, True))
    got, want, oracle = _both(build(JA, jcol), build(PA, pcol), _agg_table())
    assert set(got) == set(want)
    for k in got:
        if k == "sp":
            for g, w, o in zip(got[k], want[k], oracle[k]):
                assert g == pytest.approx(w, rel=1e-12)
                assert g == pytest.approx(o, rel=1e-12)
        else:
            assert got[k] == want[k] == oracle[k], k


def test_segagg_first_last_any_every_parity():
    n = 2048
    table = pa.table({
        "g": pa.array([i % 5 for i in range(n)], pa.int64()),
        "b": pa.array([i % 3 == 0 for i in range(n)]),
        "v": pa.array([None if i % 7 == 0 else i for i in range(n)],
                      pa.int64())})

    def build(m, c):
        return lambda df: df.group_by("g").agg(
            (m.First(c("v")), "f"), (m.Last(c("v")), "l"),
            (m.BoolOr(c("b")), "anyb"), (m.BoolAnd(c("b")), "allb"),
            (m.Count(c("v")), "c")).sort(("g", True, True))
    got, want, oracle = _both(build(JA, jcol), build(PA, pcol), table)
    assert got == want == oracle


def test_float_min_max_nan_and_signed_zero_parity():
    table = pa.table({
        "k": pa.array(["a", "a", "a", "b", "b", "c", "c", "d", "d", "e"]),
        "x": pa.array([0.0, -0.0, 1.0, float("nan"), 2.0, float("nan"),
                       float("nan"), -0.0, 0.0, None])})

    def build(m, c):
        return lambda df: df.group_by("k").agg(
            (m.Min(c("x")), "mn"), (m.Max(c("x")), "mx")).sort("k")
    got, want, _oracle = _both(build(JA, jcol), build(PA, pcol), table)
    assert {k: [repr(v) for v in vs] for k, vs in got.items()} == \
        {k: [repr(v) for v in vs] for k, vs in want.items()}


@pytest.mark.parametrize("bad", [math.inf, -math.inf, math.nan])
def test_segagg_sum_and_average_keep_a_non_finite_value_in_its_bucket(
        bad, monkeypatch):
    # the reference's one-hot block matmul multiplies 0 x inf and spreads
    # NaN into every bucket of the block (bucket 1 reads NaN); the port
    # adds each row into its own bucket only, as the CPU oracle does
    calls = []
    trace = PS.segagg_groupby_trace
    monkeypatch.setattr(PS, "segagg_groupby_trace",
                        lambda *a, **k: calls.append(1) or trace(*a, **k))
    table = pa.table({"k": pa.array([0, 0, 1, 1], pa.int64()),
                      "x": pa.array([bad, 1.0, 2.0, 3.0])})

    def build(m, c):
        return lambda df: df.group_by("k").agg(
            (m.Sum(c("x")), "s"), (m.Average(c("x")), "a")).sort("k")
    jdf = build(JA, jcol)(JSession(PALLAS_ON).from_arrow(table))
    oracle = JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    got = build(PA, pcol)(PSession(PALLAS_ON, device="cpu")
                          .from_arrow(table)).to_pydict()
    assert calls, "the port's group-by did not take the segagg tier"
    assert got["k"] == oracle["k"] == [0, 1]
    for name in ("s", "a"):
        assert repr(got[name][0]) == repr(oracle[name][0]) == repr(bad)
        assert got[name][1] == pytest.approx(oracle[name][1], rel=1e-12)
    assert (got["s"][1], got["a"][1]) == (5.0, 2.5)


def test_segagg_domain_gate_refuses_until_sort_tier_ports():
    # flag's packed domain is 4 (three values and the null slot); outside
    # the gate a dictionary key takes the reference's dense tier (it
    # raised before that tier was ported), with the reference's groups
    from spark_rapids_tpu_torch.exec import aggregate as PAGG
    conf = {"spark.rapids.tpu.sql.kernels.pallas.segagg.maxDomain": "3"}
    PAGG.reset_groupby_tiers()
    got = PSession(conf, device="cpu").from_arrow(_agg_table()) \
        .group_by("flag").agg((PA.Sum(pcol("qty")), "sq")).to_pydict()
    assert PAGG.GROUPBY_TIERS == {"segagg": 0, "dense": 1, "sort": 0}
    want = JSession(conf).from_arrow(_agg_table()).group_by("flag").agg(
        (JA.Sum(jcol("qty")), "sq")).collect().to_pydict()
    assert got == want


def test_q1_elects_segagg_and_cpu_takes_plain_versions():
    from spark_rapids_tpu_torch import tpch
    tables = tpch.gen_tables(0.001, tables=("lineitem",))
    PH.reset_launch_counts()
    from spark_rapids_tpu_torch.exec import aggregate as PAGG
    PAGG.reset_groupby_tiers()
    got = tpch.q1(PSession(device="cpu"), tables).collect()
    assert got.num_rows > 0
    assert PAGG.GROUPBY_TIERS["segagg"] > 0
    # CPU tensors run the plain versions: no kernel launch is counted
    assert set(PH.LAUNCHES) >= {"seg_sums", "seg_reduce"}
    assert not any(PH.LAUNCHES.values())
