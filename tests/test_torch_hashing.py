"""The port's Spark hashes (ops/hashing.py, `Murmur3Hash`, `XxHash64`)
against the JAX package.

Every function of ops/hashing is held bit for bit to the reference's
over random values and seeds, on tensors and on numpy arrays; the
expressions run through both of the port's engines (the device path on
CPU tensors, and the CPU engine with `sql.enabled=false`) over each type
with nulls, NaN and -0.0, and equal the reference's device path and its
CPU oracle.  Where the reference's XXH64 has no device form (DOUBLE,
FLOAT, DECIMAL) its oracle truncates the value to an integer (or fails
on an infinity); the port hashes the bits and the unscaled long as
Spark does, and those columns are held to Spark's definition computed
here from the reference's exact host functions.  A DECIMAL wider than
18 digits hashes its BigInteger bytes on the CPU engine.
"""
import decimal as pydec
import struct

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops import hashing as PH
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

M64 = (1 << 64) - 1
STRINGS = ["", "a", "ab", "abc", "abcd", "héllo wörld", "x" * 31, "y" * 32,
           "z" * 33, "q" * 70, "日本語テキスト" * 5, "\x00\x7f\x80"]


def test_spark_hash_of_one():
    # Spark: SELECT hash(1) = -559580957
    assert PH.murmur3_int32_host(1, 42) - (1 << 32) == -559580957
    got = PSession(device="cpu").from_arrow(pa.table(
        {"x": pa.array([1], pa.int32())})).select(
        PE.Alias(PE.Murmur3Hash(pcol("x")), "h")).to_pydict()
    assert got == {"h": [-559580957]}


def test_host_functions_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        x = int(rng.integers(-2 ** 63, 2 ** 63 - 1))
        s32 = int(rng.integers(0, 2 ** 32))
        s64 = int(rng.integers(0, 2 ** 63)) * 2 + int(rng.integers(0, 2))
        assert PH.murmur3_int64_host(x, s32) == JH.murmur3_int64_host(x, s32)
        assert PH.murmur3_int32_host(x & 0xFFFFFFFF, s32) == \
            JH.murmur3_int32_host(x & 0xFFFFFFFF, s32)
        assert PH.xxhash64_long_host(x, s64) == \
            JH.xxhash64_long_host(x, s64)
        assert PH.xxhash64_int_host(x, s64) == JH.xxhash64_int_host(x, s64)
    for st in STRINGS:
        for seed in (42, 0, 7, 2 ** 32 - 1):
            assert PH.murmur3_utf8(st, seed) == JH.murmur3_utf8(st, seed)
            assert PH.xxhash64_utf8(st, seed) == JH.xxhash64_utf8(st, seed)
    assert np.array_equal(PH.dict_hash_array(STRINGS, 42),
                          JH.dict_hash_array(STRINGS, 42))
    assert np.array_equal(PH.dict_xxhash_array(STRINGS, 42),
                          JH.dict_xxhash_array(STRINGS, 42))
    assert np.array_equal(PH.dict_hash_array([], 42),
                          JH.dict_hash_array([], 42))


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_lanes_equal_reference_device_functions(lib):
    rng = np.random.default_rng(1)
    n = 4000
    x = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    s32 = rng.integers(0, 2 ** 32, n, dtype=np.int64)
    s64 = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    put = torch.from_numpy if lib == "torch" else (lambda a: a)

    def arr(v):
        return np.asarray(v).astype(np.int64)
    want = np.asarray(JH.hash_int64(jnp.asarray(x), jnp.asarray(
        s32.astype(np.uint32)))).astype(np.int64)
    assert np.array_equal(arr(PH.hash_int64(put(x), put(s32))), want)
    want = np.asarray(JH.hash_int32(jnp.asarray(x.astype(np.int32)),
                                    jnp.asarray(s32.astype(np.uint32))))
    assert np.array_equal(arr(PH.hash_int32(put(x), put(s32))),
                          want.astype(np.int64))
    u = jnp.asarray(x.view(np.uint64))
    us = jnp.asarray(s64.view(np.uint64))
    want = np.asarray(JH.xxhash64_long_lane(u, us)).view(np.int64)
    assert np.array_equal(arr(PH.xxhash64_long_lane(put(x), put(s64))), want)
    low = jnp.asarray((x & 0xFFFFFFFF).view(np.uint64))
    want = np.asarray(JH.xxhash64_int_lane(low, us)).view(np.int64)
    assert np.array_equal(arr(PH.xxhash64_int_lane(put(x), put(s64))), want)


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_strings_under_per_row_seeds_equal_reference(lib):
    rng = np.random.default_rng(2)
    d = np.array(sorted(set(STRINGS)), str)
    tabs = PH.StringTables(d)
    put = torch.from_numpy if lib == "torch" else (lambda a: a)
    if lib == "torch":
        tabs = tabs.to("cpu")
    codes = rng.integers(0, len(d), 600)
    s32 = rng.integers(0, 2 ** 32, 600)
    got = np.asarray(PH.murmur3_strings(put(codes), put(s32), tabs))
    assert [int(g) for g in got] == [JH.murmur3_utf8(str(d[c]), int(s))
                                     for c, s in zip(codes, s32)]
    s64 = rng.integers(-2 ** 63, 2 ** 63 - 1, 600)
    got = np.asarray(PH.xxhash64_strings(put(codes), put(s64), tabs))
    assert [int(g) & M64 for g in got] == [
        JH.xxhash64_utf8(str(d[c]), int(s) & M64) for c, s in zip(codes, s64)]


def _table(n=400, seed=3):
    rng = np.random.default_rng(seed)

    def m():
        return rng.random(n) < 0.1
    f = rng.standard_normal(n)
    f[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324]
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=m()),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=m()),
        "i16": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                        mask=m()),
        "i": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                      mask=m()),
        "l": pa.array(rng.integers(-2 ** 63, 2 ** 63 - 1, n), mask=m()),
        "f": pa.array(f.astype(np.float32), mask=m()),
        "d": pa.array(f, mask=m()),
        "dt": pa.array(rng.integers(-1000, 20000, n).astype(np.int32),
                       mask=m()).cast(pa.date32()),
        "s": pa.array(rng.choice(STRINGS, n), mask=m()),
        "dec": pa.array([pydec.Decimal(int(v)).scaleb(-2) for v in
                         rng.integers(-10 ** 15, 10 ** 15, n)],
                        pa.decimal128(17, 2), mask=m())})


TABLE = _table()
MURMUR_CASES = [["b"], ["i8"], ["i16"], ["i"], ["l"], ["f"], ["d"], ["dt"],
                ["s"], ["dec"], ["s", "i", "l"], ["i", "s"],
                ["l", "s", "dec", "dt"], ["d", "b", "i", "f"],
                ["i8", "s", "s", "d"]]
XX_CASES = [["b"], ["i8"], ["i16"], ["i"], ["l"], ["dt"], ["s"],
            ["s", "i", "l"], ["i", "s"], ["l", "s", "dt", "b"]]


def _port_both(cls, cols, table=TABLE):
    def build(s):
        return s.from_arrow(table).select(PE.Alias(
            getattr(PE, cls)(*[pcol(c) for c in cols]), "h"))
    dev = build(PSession(device="cpu")).to_pydict()["h"]
    cpu = build(PSession({"spark.rapids.tpu.sql.enabled": "false"},
                         device="cpu")).to_pydict()["h"]
    return dev, cpu


def _reference(cls, cols):
    def build(s):
        return s.from_arrow(TABLE).select(JE.Alias(
            getattr(JE, cls)(*[jcol(c) for c in cols]), "h"))
    want = build(JSession()).collect().to_pydict()["h"]
    oracle = JDF(build(JSession())._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()["h"]
    return want, oracle


@pytest.mark.parametrize("cols", MURMUR_CASES, ids="-".join)
def test_murmur3hash_both_engines_equal_reference(cols):
    dev, cpu = _port_both("Murmur3Hash", cols)
    want, oracle = _reference("Murmur3Hash", cols)
    assert dev == cpu == want == oracle


@pytest.mark.parametrize("cols", XX_CASES, ids="-".join)
def test_xxhash64_both_engines_equal_reference(cols):
    dev, cpu = _port_both("XxHash64", cols)
    want, oracle = _reference("XxHash64", cols)
    assert dev == cpu == want == oracle


def _spark_xx(values, kind):
    """Spark's xxhash64 of one column of python values (seed 42)."""
    out = []
    for v in values:
        if v is None:
            h = 42
        elif kind == "d":
            v = 0.0 if v == 0.0 else v
            bits = 0x7FF8000000000000 if v != v else \
                struct.unpack("<q", struct.pack("<d", v))[0]
            h = JH.xxhash64_long_host(bits, 42)
        elif kind == "f":
            v = 0.0 if v == 0.0 else v
            bits = 0x7FC00000 if v != v else \
                struct.unpack("<i", struct.pack("<f", v))[0]
            h = JH.xxhash64_int_host(bits, 42)
        else:
            h = JH.xxhash64_long_host(int(v.scaleb(2)), 42)
        out.append(h - (1 << 64) if h >= 1 << 63 else h)
    return out


@pytest.mark.parametrize("col", ["d", "f", "dec"])
def test_xxhash64_of_floats_and_decimals_follows_spark(col):
    dev, cpu = _port_both("XxHash64", [col])
    assert dev == cpu == _spark_xx(TABLE.column(col).to_pylist(), col)


def test_wide_decimal_hashes_its_biginteger_bytes_on_the_cpu_engine():
    vals = [pydec.Decimal(10 ** 30 + 7), pydec.Decimal(-(10 ** 25)), None,
            pydec.Decimal(0), pydec.Decimal(-1), pydec.Decimal(255),
            pydec.Decimal(128)]
    table = pa.table({"w": pa.array(vals, pa.decimal128(38, 0))})
    q = PSession(device="cpu").from_arrow(table).select(
        PE.Alias(PE.Murmur3Hash(pcol("w")), "h")).physical()
    assert q.fallback_reasons()
    for cls in ("Murmur3Hash", "XxHash64"):
        dev, cpu = _port_both(cls, ["w"], table)
        want = []
        for v in vals:
            if v is None:
                want.append(42)
                continue
            iv = int(v)
            b = iv.to_bytes((iv + (iv < 0)).bit_length() // 8 + 1, "big",
                            signed=True)
            if cls == "XxHash64":
                h = JH.xxhash64_bytes_host(b, 42)
                want.append(h - (1 << 64) if h >= 1 << 63 else h)
            else:
                h = JH.murmur3_bytes(b, 42)
                want.append(h - (1 << 32) if h >= 1 << 31 else h)
        assert dev == cpu == want, cls


def test_hash_result_types_and_nullability():
    schema = PT.StructType([PT.StructField("x", PT.INT, True)])
    for cls, dt in ((PE.Murmur3Hash, PT.INT), (PE.XxHash64, PT.LONG)):
        e = cls(pcol("x")).bind(schema)
        assert e.dtype == dt and not e.nullable
