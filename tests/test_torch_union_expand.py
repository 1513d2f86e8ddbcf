"""UNION ALL, the Expand lowering of rollup / cube / grouping sets, and
the bitwise and shift operators of the port, against the JAX package's
device path and its CPU oracle.

A union streams its children's batches with their own string
dictionaries; the group-by's merge, the sort, top-N and the join (its
build concatenates, its probe remaps into the build's dictionary) must
each see one.
"""
import warnings

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON"}
SMALL = {"spark.rapids.tpu.sql.batchSizeRows": "64"}


def _reference(build):
    jdf = build(JA, JE, jcol, JSession({**PALLAS_ON, **SMALL}))
    dev = jdf.collect().to_pydict()
    cpu = JDF(jdf._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    return dev, cpu


def _port(build, conf=SMALL):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build(PA, PE, pcol, PSession(conf, device="cpu")) \
            .collect().to_pydict()


def _tables():
    rng = np.random.default_rng(1)
    a = pa.table({"k": pa.array(rng.choice(["b", "a", "é", "zz", None], 300)),
                  "v": pa.array(rng.integers(-50, 50, 300), pa.int64())})
    b = pa.table({"k2": pa.array(rng.choice(["c", "a", "yy", "é"], 200)),
                  "v2": pa.array(rng.integers(0, 9, 200), pa.int64())})
    c = pa.table({"k3": pa.array(["zz", "q"] * 40),
                  "v3": pa.array(np.arange(80), pa.int64())})
    dim = pa.table({"dk": pa.array(["a", "c", "zz", "é", "nope"]),
                    "w": pa.array([1, 2, 3, 4, 5], pa.int64())})
    return a, b, c, dim


def _union(s, c):
    a, b, cc, _dim = _tables()
    return (s.from_arrow(a)
            .union(s.from_arrow(b).select(c("k2"), c("v2"),
                                          names=["k", "v"]))
            .union(s.from_arrow(cc).select(c("k3"), c("v3"),
                                           names=["k", "v"])))


def _group_by(A, E, c, s):
    return (_union(s, c).group_by("k")
            .agg((A.Sum(c("v")), "sv"), (A.Count(None), "n")).sort("k"))


def _sort(A, E, c, s):
    return _union(s, c).sort(("k", False, True), ("v", True, True))


def _top_n(A, E, c, s):
    return _union(s, c).sort(("k", True, False), ("v", False, True)) \
        .limit(17)


def _join_probe(A, E, c, s):
    dim = s.from_arrow(_tables()[3])
    return (_union(s, c).join(dim, left_on=["k"], right_on=["dk"])
            .group_by("k", "w").agg((A.Sum(c("v")), "sv")).sort("k"))


def _join_build(A, E, c, s):
    dim = s.from_arrow(_tables()[3])
    return (dim.join(_union(s, c), left_on=["dk"], right_on=["k"],
                     how="left_semi").sort("dk"))


def _join_outer(A, E, c, s):
    dim = s.from_arrow(_tables()[3])
    return (dim.join(_union(s, c).group_by("k")
                     .agg((A.Count(None), "n")),
                     left_on=["dk"], right_on=["k"], how="left_outer")
            .sort("dk"))


@pytest.mark.parametrize("build", [_group_by, _sort, _top_n, _join_probe,
                                   _join_build, _join_outer])
def test_union_of_dictionaries_feeds_each_consumer(build):
    dev, cpu = _reference(build)
    got = _port(build)
    if build is _sort:
        # rows of a null key order by their other keys, as the oracle
        # does; the reference's device path orders them by the key's
        # hidden payload (ROADMAP Queue 3 item 7)
        assert got == cpu
        assert sorted(zip(got["v"], got["k"]), key=repr) == \
            sorted(zip(dev["v"], dev["k"]), key=repr)
    else:
        assert got == dev == cpu
    assert len(next(iter(got.values()))) > 0


def _rollups(A, E, c, s, kind):
    rng = np.random.default_rng(2)
    t = pa.table({"a": pa.array(rng.choice(["x", "y", None], 120)),
                  "b": pa.array(rng.integers(0, 3, 120), pa.int32()),
                  "d": pa.array(rng.choice([1.5, -0.0, 0.0, None], 120)),
                  "v": pa.array(rng.integers(0, 100, 120), pa.int64())})
    df = s.from_arrow(t)
    if kind == "cube":
        g = df.cube("a", "b", "d")
    elif kind == "rollup":
        g = df.rollup("b", "a")
    else:
        # duplicates collapse, as in Spark: three distinct sets remain
        g = df.grouping_sets([("a", "b"), ("b",), ("b", "a"), (), ()],
                             keys=["a", "b"])
    out = g.agg((A.Sum(c("v")), "sv"), (A.Count(None), "n"))
    names = [n for n in ("a", "b", "d") if n in out.schema.names]
    return (out.select(*[c(n) for n in names], g.grouping_id(),
                       g.grouping("b"), c("sv"), c("n"),
                       names=names + ["gid", "gb", "sv", "n"])
            .sort("gid", *names))


@pytest.mark.parametrize("kind", ["cube", "rollup", "grouping_sets"])
def test_grouping_sets_equal_the_reference(kind):
    def build(A, E, c, s):
        return _rollups(A, E, c, s, kind)
    dev, cpu = _reference(build)
    got = _port(build)
    assert got == dev
    if kind == "cube":
        # the DOUBLE key d holds -0.0 and 0.0: the reference groups them
        # as one value, its oracle apart (README; the port follows the
        # reference)
        assert len(got["n"]) < len(cpu["n"])
    else:
        assert got == cpu
    if kind == "grouping_sets":
        # (a, b) -> 0, (b) -> 2 (a aggregated away, the high bit), () -> 3
        assert sorted(set(got["gid"])) == [0, 2, 3]


def _bitwise(A, E, c, s):
    i32 = np.array([0, 1, -1, 5, -7, 2 ** 31 - 1, -(2 ** 31), 123456789,
                    None], dtype=object)
    i64 = np.array([0, 1, -1, 5, -7, 2 ** 63 - 1, -(2 ** 63), 2 ** 40 + 3,
                    None], dtype=object)
    shifts = [0, 1, 31, 32, 63, 64, -1, 65, None]
    n = len(shifts)
    rows = [(i32[i], i64[j], shifts[k]) for i in range(n) for j in range(n)
            for k in range(n)]
    t = pa.table({"a": pa.array([r[0] for r in rows], pa.int32()),
                  "b": pa.array([r[1] for r in rows], pa.int64()),
                  "sh": pa.array([r[2] for r in rows], pa.int32())})
    exprs, names = [], []
    for base in ("a", "b"):
        for op in (E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned):
            exprs.append(op(c(base), c("sh")))
            names.append(f"{op.__name__}_{base}")
        exprs += [E.BitwiseNot(c(base)), E.BitCount(c(base))]
        names += [f"not_{base}", f"count_{base}"]
    exprs += [E.BitwiseAnd(c("a"), c("sh")), E.BitwiseOr(c("b"), c("a")),
              E.BitwiseXor(c("a"), c("b")), E.BitwiseAnd(c("b"), c("sh")),
              E.BitwiseXor(c("sh"), E.Literal(-1))]
    names += ["and_a", "or_b", "xor_a", "and_b", "xor_lit"]
    return s.from_arrow(t).select(*exprs, names=names)


def test_bitwise_and_shift_operators_equal_the_reference():
    dev, cpu = _reference(_bitwise)
    got = _port(_bitwise, conf={})
    for name in got:
        assert got[name] == dev[name] == cpu[name], name
