"""The port's sorted group-by tier against the JAX package's.

`groupby_trace` (with and without a packed key lane, null keys, every
aggregate kind) and the ops/segments.py primitives under it go through
both packages on the same numpy inputs; group-bys the segagg kernels
refuse (unbounded keys, a domain above maxDomain) run through the port's
sessions against the JAX package and its CPU oracle.  Integers and
float MIN/MAX compare exactly, float64 sums to rtol 1e-12 (the JAX
reference's segmented scan and the port's associate the same way, but
XLA may fuse the adds differently).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops import segments as JS
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops import groupby as PG
from spark_rapids_tpu_torch.ops import segments as PS
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

KINDS = [("sum", 0, "LONG"), ("sum", 1, "DOUBLE"), ("count", 0, "LONG"),
         ("count_all", -1, "LONG"), ("min", 0, "LONG"), ("max", 1, "DOUBLE"),
         ("min", 1, "DOUBLE"), ("min", 2, "BOOLEAN"), ("max", 2, "BOOLEAN"),
         ("first", 0, "LONG"), ("last", 1, "DOUBLE"), ("first_nn", 3, "INT"),
         ("last_nn", 1, "DOUBLE"), ("any", 2, "BOOLEAN"),
         ("every", 2, "BOOLEAN"), ("max", 3, "INT")]


def _inputs(cap, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(-3, 40, cap), rng.integers(0, 5, cap).astype(
        np.int32)]
    kvalid = [rng.random(cap) > 0.1, rng.random(cap) > 0.05]
    f = rng.standard_normal(cap)
    f[::37], f[1::37], f[::101] = -0.0, 0.0, np.nan
    data = [rng.integers(-2 ** 50, 2 ** 50, cap), f, rng.random(cap) > 0.4,
            rng.integers(-2 ** 31, 2 ** 31 - 1, cap).astype(np.int32)]
    valid = [rng.random(cap) > 0.2 for _ in data]
    return keys, kvalid, data, valid, rng.random(cap) > 0.1


def _assert_outputs_equal(kinds, jout, pout, n, has_valid=None):
    """`has_valid` (input index -> per group bool): FIRST/LAST ignoring
    nulls of a group with no non-null input is null in the port, as the
    CPU oracle; the reference keeps its clamped row's validity (ROADMAP
    Queue 3 item 9), so there the port's validity is the reference's
    and the group's."""
    for (k, i, typ), (jd, jv), (pd_, pv) in zip(kinds, jout, pout):
        jv, pv = np.asarray(jv)[:n], pv.numpy()[:n]
        if has_valid is not None and k in ("first_nn", "last_nn"):
            jv = jv & has_valid[i]
        np.testing.assert_array_equal(pv, jv, err_msg=k)
        a, b = np.asarray(jd)[:n][jv], pd_.numpy()[:n][pv]
        if typ == "DOUBLE" and k == "sum":
            np.testing.assert_allclose(b, a, rtol=1e-12, equal_nan=True)
        elif typ == "DOUBLE":
            np.testing.assert_array_equal(b.view(np.int64), a.view(np.int64),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("pack", [None, ((-3, 45), None), ((-3, 45), (0, 7))])
@pytest.mark.parametrize("cap", [1024, 8192])
def test_groupby_trace_matches_reference(pack, cap):
    keys, kvalid, data, valid, live = _inputs(cap, cap + len(str(pack)))
    jspecs = [JG.AggSpec(k, i, getattr(JT, t)) for k, i, t in KINDS]
    pspecs = [PG.AggSpec(k, i, getattr(PT, t)) for k, i, t in KINDS]
    jk, jo, jn = JG.groupby_trace(
        [(JT.LONG, True, "int64"), (JT.INT, True, "int32")], jspecs, cap,
        cap, pack_spec=pack)(
        tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(v) for v in kvalid),
        tuple(jnp.asarray(d) for d in data),
        tuple(jnp.asarray(v) for v in valid), jnp.asarray(live))
    pk, po, pn = PG.groupby_trace(
        [(PT.LONG, True, torch.int64), (PT.INT, True, torch.int32)], pspecs,
        cap, cap, pack_spec=pack)(
        [torch.from_numpy(k) for k in keys],
        [torch.from_numpy(v) for v in kvalid],
        [torch.from_numpy(d) for d in data],
        [torch.from_numpy(v) for v in valid], torch.from_numpy(live))
    n = int(jn)
    assert int(pn) == n
    for (jd, jv), (pd_, pv) in zip(jk, pk):
        jv, pv = np.asarray(jv)[:n], pv.numpy()[:n]
        np.testing.assert_array_equal(pv, jv)         # null keys first
        np.testing.assert_array_equal(pd_.numpy()[:n][pv],
                                      np.asarray(jd)[:n][jv])
    _assert_outputs_equal(KINDS, jo, po, n,
                          _groups_with_valid(keys, kvalid, valid, live, pk,
                                             n))


def _key_tuples(lanes, n):
    """Per row a hashable key: (valid, value or 0) of every key."""
    cols = []
    for d, v in lanes:
        d, v = np.asarray(d)[:n], np.asarray(v)[:n]
        cols += [v, np.where(v, d, 0)]
    return list(zip(*[c.tolist() for c in cols]))


def _groups_with_valid(keys, kvalid, valid, live, out_keys, n):
    """input index -> per output group: has a live row with a non-null
    input."""
    rows = _key_tuples(list(zip(keys, kvalid)), len(live))
    groups = _key_tuples([(d.numpy(), v.numpy()) for d, v in out_keys], n)
    out = {}
    for i, v in enumerate(valid):
        seen = {r for r, ok in zip(rows, (v & live).tolist()) if ok}
        out[i] = np.array([g in seen for g in groups])
    return out


def test_groupby_trace_double_keys_group_nan_and_signed_zero():
    cap = 2048
    rng = np.random.default_rng(2)
    k = rng.choice(np.array([1.5, -0.0, 0.0, np.nan, -2.0, np.inf]), cap)
    kv = rng.random(cap) > 0.1
    x = rng.integers(0, 100, cap)
    live = np.ones(cap, bool)
    jk, jo, jn = JG.groupby_trace(
        [(JT.DOUBLE, True, "float64")], [JG.AggSpec("sum", 0, JT.LONG)],
        cap, cap)((jnp.asarray(k),), (jnp.asarray(kv),), (jnp.asarray(x),),
                  (jnp.asarray(np.ones(cap, bool)),), jnp.asarray(live))
    pk, po, pn = PG.groupby_trace(
        [(PT.DOUBLE, True, torch.float64)], [PG.AggSpec("sum", 0, PT.LONG)],
        cap, cap)([torch.from_numpy(k)], [torch.from_numpy(kv)],
                  [torch.from_numpy(x)], [torch.ones(cap, dtype=torch.bool)],
                  torch.from_numpy(live))
    n = int(jn)
    # null, -2.0, 0.0 with -0.0, 1.5, inf and NaN: six groups
    assert int(pn) == n == 6
    np.testing.assert_array_equal(po[0][0].numpy()[:n],
                                  np.asarray(jo[0][0])[:n])


@pytest.mark.parametrize("op", ["add", "minimum", "maximum"])
@pytest.mark.parametrize("n,k", [(1000, 0), (8192, 0), (8192, 3), (4096, 2)])
def test_blocked_seg_scan_matches_reference(op, n, k):
    rng = np.random.default_rng(zlib.crc32(f"{op}{n}{k}".encode()))
    shape = (n,) if k == 0 else (n, k)
    ints = rng.integers(-2 ** 40, 2 ** 40, shape)
    floats = rng.standard_normal(shape)
    boundary = rng.random(n) < 0.01
    boundary[0] = True
    for vals in (ints, floats):
        want = np.asarray(JS.blocked_seg_scan(
            jnp.asarray(vals), jnp.asarray(boundary), getattr(jnp, op)))
        got = PS.blocked_seg_scan(torch.from_numpy(vals),
                                  torch.from_numpy(boundary),
                                  getattr(torch, op)).numpy()
        if vals.dtype == np.float64 and op == "add":
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, want)


def test_segment_helpers_and_lexsort_match_reference():
    rng = np.random.default_rng(8)
    cap = 4096
    lanes = [rng.integers(-2 ** 62, 2 ** 62, cap) for _ in range(3)]
    lanes[0][:5] = [2 ** 63 - 1] * 5                      # wraparound
    starts = np.sort(rng.choice(cap, 64, replace=False)).astype(np.int32)
    starts[0] = 0
    count = np.int32(cap - 100)
    ends = np.array(JS.segment_ends(jnp.asarray(starts), count, cap))
    np.testing.assert_array_equal(
        PS.segment_ends(torch.from_numpy(starts), torch.tensor(count),
                        cap).numpy(), ends)
    np.testing.assert_array_equal(
        PS.seg_sums_sorted([torch.from_numpy(l) for l in lanes],
                           torch.from_numpy(starts),
                           torch.from_numpy(ends)).numpy(),
        np.asarray(JS.seg_sums_sorted([jnp.asarray(l) for l in lanes],
                                      jnp.asarray(starts),
                                      jnp.asarray(ends))))
    sort_lanes = [rng.integers(0, 4, cap), rng.integers(-3, 3, cap),
                  rng.random(cap) < 0.2]
    np.testing.assert_array_equal(
        PS.lexsort_capped([torch.from_numpy(l) for l in sort_lanes]).numpy(),
        np.asarray(JS.lexsort_capped([jnp.asarray(l.astype(np.int8)
                                                  if l.dtype == bool else l)
                                      for l in sort_lanes], 2)))
    assert PS.op_identity(torch.minimum, torch.int32) == 2 ** 31 - 1
    assert PS.op_identity(torch.maximum, torch.bool) is False


@pytest.mark.parametrize("packed", [False, True])
def test_sorted_segments_match_reference(packed):
    # the reference's sorted_segments with no minor lanes; its packed
    # branch orders the dead rows differently (one dead key instead of
    # the dead rows' own keys), so the live prefix is what must agree
    cap = 2048
    keys, kvalid, _data, _valid, live = _inputs(cap, 40 + packed)
    pack = ((-3, 45), (0, 7)) if packed else None
    jr = JS.sorted_segments(
        [(JT.LONG, True, "int64"), (JT.INT, True, "int32")],
        tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(v) for v in kvalid), jnp.asarray(live),
        [], cap, cap, pack_spec=pack)
    pr = PS.sorted_segments(
        [(PT.LONG, True, torch.int64), (PT.INT, True, torch.int32)],
        [torch.from_numpy(k) for k in keys],
        [torch.from_numpy(v) for v in kvalid], torch.from_numpy(live),
        cap, cap, pack_spec=pack)
    n = int(jr.num_groups)
    count = int(live.sum())
    assert int(pr.num_groups) == n
    np.testing.assert_array_equal(pr.s_live.numpy(), np.asarray(jr.s_live))
    np.testing.assert_array_equal(pr.perm.numpy()[:count],
                                  np.asarray(jr.perm)[:count])
    np.testing.assert_array_equal(
        pr.group_live.numpy(), np.asarray(jr.group_live))
    for name in ("start_idx", "end_idx"):
        np.testing.assert_array_equal(getattr(pr, name).numpy()[:n],
                                      np.asarray(getattr(jr, name))[:n])
    for (jd, jv), (pd_, pv) in zip(jr.out_keys, pr.out_keys):
        pv, jv = pv.numpy()[:n], np.asarray(jv)[:n]
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pd_.numpy()[:n][pv],
                                      np.asarray(jd)[:n][jv])


def _reference(jdf):
    dev = jdf.collect().to_pydict()
    cpu = JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    return dev, cpu


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 300, n), mask=rng.random(n) < 0.05),
        "g": pa.array(rng.choice(["x", "y", "z"], n)),
        "v": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        "f": pa.array(rng.standard_normal(n))})


@pytest.mark.parametrize("keys", [("k",), ("k", "g")])
def test_unbounded_group_by_runs_sorted_tier_like_reference(keys):
    # a computed key has no scan range, and k x g's pack exceeds
    # maxDomain: both leave the segagg kernels for the sorted group-by
    table = _table(3000, len(keys))

    def build(a, e, c, s):
        df = s.from_arrow(table).select(
            e.Alias(e.Add(c("k"), e.Literal(7)), "k"), c("g"), c("v"),
            c("f"))
        return (df.group_by(*keys)
                .agg((a.Sum(c("v")), "sv"), (a.Min(c("f")), "mf"),
                     (a.Max(c("v")), "xv"), (a.Count(None), "n"),
                     (a.First(c("v")), "fv"))
                .sort(*keys))
    from spark_rapids_tpu.plan import expressions as JE
    from spark_rapids_tpu_torch.plan import expressions as PE
    on = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
          "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON"}
    dev, cpu = _reference(build(JA, JE, jcol, JSession(on)))
    got = build(PA, PE, pcol, PSession(device="cpu")).to_pydict()
    assert got == dev == cpu


def test_dense_domain_refused_unless_routed_through_sort():
    # a dictionary key whose float sum segagg refuses (strict float
    # aggregation) ran nowhere before the dense tier was ported; it now
    # runs the dense tier, and the sorted group-by when routed there,
    # both equal to the reference
    from spark_rapids_tpu_torch.exec import aggregate as PAGG
    table = _table(2000, 9)

    def q(s):
        return (s.from_arrow(table).group_by("g")
                .agg((PA.Sum(pcol("f")), "sf")).sort("g"))
    strict = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": "false"}
    PAGG.reset_groupby_tiers()
    dense = q(PSession(strict, device="cpu")).to_pydict()
    assert PAGG.GROUPBY_TIERS["dense"] > 0
    ref = (JSession(strict).from_arrow(table).group_by("g")
           .agg((JA.Sum(jcol("f")), "sf")).sort("g")).collect().to_pydict()
    assert dense["g"] == ref["g"]
    np.testing.assert_allclose(dense["sf"], ref["sf"], rtol=1e-12)
    via_sort = {**strict, "spark.rapids.tpu.sql.agg.denseDomainViaSort":
                "true"}
    got = q(PSession(via_sort, device="cpu")).to_pydict()
    want = (JSession(via_sort).from_arrow(table).group_by("g")
            .agg((JA.Sum(jcol("f")), "sf")).sort("g")).collect().to_pydict()
    assert got["g"] == want["g"]
    np.testing.assert_allclose(got["sf"], want["sf"], rtol=1e-12)
