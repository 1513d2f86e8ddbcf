"""The PyTorch/CUDA port's ops primitives against the JAX package's.

Decimal arithmetic (result types, overflow-to-null), the no-key
reduction of every aggregate kind, the packed key lane, the f64
total-order mapping and the dictionary rank table, on the same numpy
inputs through both packages.
"""
import decimal as pydec
import zlib

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import decimal as JD
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops import sort as JSORT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops import decimal as PD
from spark_rapids_tpu_torch.ops import groupby as PG
from spark_rapids_tpu_torch.ops import sort as PSORT
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)


@pytest.mark.parametrize("op", ["add_dev", "sub_dev", "mul_dev"])
@pytest.mark.parametrize("scales", [(2, 2), (2, 0), (4, 2), (0, 6)])
def test_decimal_kernels_match_reference(op, scales):
    rng = np.random.default_rng(len(op) * 10 + scales[0] * 3 + scales[1])
    n = 4096
    a = rng.integers(-10 ** 17, 10 ** 17, n)
    b = rng.integers(-10 ** 17, 10 ** 17, n)
    a[:256] = rng.integers(-10 ** 6, 10 ** 6, 256)       # in-range products
    b[:256] = rng.integers(-10 ** 6, 10 ** 6, 256)
    a[256:260] = [2 ** 63 - 1, -2 ** 63 + 1, 10 ** 18 - 1, -(10 ** 18) + 1]
    sa, sb = scales
    ta, tb = JT.DecimalType(18, sa), JT.DecimalType(18, sb)
    rule = JD.mul_result if op == "mul_dev" else JD.add_result
    out_j = rule(ta, tb)
    out_p = (PD.mul_result if op == "mul_dev" else PD.add_result)(
        PT.DecimalType(18, sa), PT.DecimalType(18, sb))
    assert (out_p.precision, out_p.scale) == (out_j.precision, out_j.scale)
    jv, jok = getattr(JD, op)(jnp.asarray(a), sa, jnp.asarray(b), sb, out_j)
    pv, pok = getattr(PD, op)(torch.from_numpy(a), sa, torch.from_numpy(b),
                              sb, out_p)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(pok.numpy(), jok)
    np.testing.assert_array_equal(pv.numpy()[jok], np.asarray(jv)[jok])


def test_decimal_to_double_is_correctly_rounded_as_the_cpu_oracle():
    # decimal(12, 2) -> DOUBLE divides the unscaled value by 100.0; under
    # jit XLA rewrites the reference's division as a multiply by 0.01,
    # one ulp off the correctly rounded quotient for these values.  The
    # port divides, as the CPU oracle does.
    vals = ["965093049.17", "-169834279.70"]
    unscaled = np.array([96509304917, -16983427970], np.int64)
    table = pa.table({"d": pa.array([pydec.Decimal(v) for v in vals],
                                    pa.decimal128(12, 2))})
    jdf = JSession().from_arrow(table).select(
        JE.Alias(JE.Cast(jcol("d"), JT.DOUBLE), "x"))
    ref = np.array(jdf.collect().to_pydict()["x"])
    oracle = np.array(JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()["x"])
    cast = np.array(PSession(device="cpu").from_arrow(table).select(
        PE.Alias(PE.Cast(pcol("d"), PT.DOUBLE), "x")).to_pydict()["x"])
    direct = PD.to_double(torch.from_numpy(unscaled), 2).numpy()
    for got in (direct, cast):
        np.testing.assert_array_equal(got.view(np.int64),
                                      oracle.view(np.int64))
        assert got.tolist() == [float(v) for v in vals]
        assert np.abs(got.view(np.int64) - ref.view(np.int64)).max() <= 1


@pytest.mark.parametrize("from_scale,to_scale", [(2, 6), (6, 2), (4, 4),
                                                 (0, 18), (7, 0)])
def test_decimal_rescale_half_up_matches_reference(from_scale, to_scale):
    rng = np.random.default_rng(from_scale * 19 + to_scale)
    u = rng.integers(-10 ** 15, 10 ** 15, 2048)
    u[:6] = [5, -5, 15, -15, 49, -50]
    jv, jok = JD.rescale(jnp.asarray(u), from_scale, to_scale)
    pv, pok = PD.rescale(torch.from_numpy(u), from_scale, to_scale)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    m = np.asarray(jok)
    np.testing.assert_array_equal(pv.numpy()[m], np.asarray(jv)[m])


_REDUCE_KINDS = [
    ("sum", 0, "LONG"), ("sum", 1, "DOUBLE"), ("count", 0, "LONG"),
    ("count_all", -1, "LONG"), ("min", 0, "LONG"), ("max", 0, "LONG"),
    ("min", 1, "DOUBLE"), ("max", 1, "DOUBLE"), ("min", 2, "BOOLEAN"),
    ("max", 2, "BOOLEAN"), ("first", 0, "LONG"), ("last", 1, "DOUBLE"),
    ("first_nn", 0, "LONG"), ("last_nn", 1, "DOUBLE"), ("any", 2, "BOOLEAN"),
    ("every", 2, "BOOLEAN")]


@pytest.mark.parametrize("kind,idx,typ", _REDUCE_KINDS)
@pytest.mark.parametrize("nan", [False, True])
def test_reduce_trace_matches_reference(kind, idx, typ, nan):
    rng = np.random.default_rng(zlib.crc32(f"{kind}{idx}{nan}".encode()))
    cap = 1024
    f = rng.standard_normal(cap)
    f[::37] = -0.0
    f[1::37] = 0.0
    if nan:
        f[::101] = np.nan
    data = [rng.integers(-2 ** 50, 2 ** 50, cap), f, rng.random(cap) > 0.4]
    valid = [rng.random(cap) > 0.2 for _ in data]
    live = rng.random(cap) > 0.1
    jspec = JG.AggSpec(kind, idx, getattr(JT, typ))
    pspec = PG.AggSpec(kind, idx, getattr(PT, typ))
    (jd, jv), = JG.reduce_trace([jspec], cap)(
        tuple(jnp.asarray(d) for d in data),
        tuple(jnp.asarray(v) for v in valid), jnp.asarray(live))
    (pd_, pv), = PG.reduce_trace([pspec], cap)(
        [torch.from_numpy(d) for d in data],
        [torch.from_numpy(v) for v in valid], torch.from_numpy(live))
    assert bool(pv) == bool(jv)
    if bool(jv):
        got, want = np.asarray(pd_.item()), np.asarray(jd)
        if kind == "sum" and typ == "DOUBLE":
            np.testing.assert_allclose(got, want, rtol=1e-12)
        elif typ == "DOUBLE":
            assert np.float64(got).tobytes() == np.float64(want).tobytes()
        else:
            assert got == want


def test_packed_key_lane_and_total_order_match_reference():
    rng = np.random.default_rng(5)
    cap = 2048
    keys = [rng.integers(-3, 9, cap), rng.integers(0, 4, cap).astype(
        np.int32)]
    valid = [rng.random(cap) > 0.2, rng.random(cap) > 0.1]
    pack = ((-3, 13), (0, 6))
    want = JG._packed_key_lane([jnp.asarray(k) for k in keys],
                               [jnp.asarray(v) for v in valid], pack)
    got = PG._packed_key_lane([torch.from_numpy(k) for k in keys],
                              [torch.from_numpy(v) for v in valid], pack)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bits = rng.integers(-2 ** 63, 2 ** 63 - 1, cap, endpoint=True)
    bits[:4] = np.array([np.nan, -np.nan, -0.0, 0.0]).view(np.int64)
    o_j = np.asarray(JG._bits_total_order(jnp.asarray(bits)))
    o_p = PG._bits_total_order(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(o_p, o_j)
    np.testing.assert_array_equal(
        PG._bits_from_order(torch.from_numpy(o_p)).numpy(),
        np.asarray(JG._bits_from_order(jnp.asarray(o_j))))


def test_dictionary_ranks_match_reference():
    values = ["pear", "apple", "Zebra", "éclair", "apple2", ""]
    np.testing.assert_array_equal(
        PSORT.dictionary_ranks(np.array(values, str)),
        JSORT.dictionary_ranks(pa.array(values)))
