"""The port's range generator, Bernoulli sample and batch coalescer, and
the session methods around them (`from_pydict`, `range`, `sample`,
`count`, `explain`), against the JAX package.

The sample must keep exactly the rows the reference keeps, on its device
path and its CPU fallback (`sql.enabled=false`), for three seeds and the
fractions 0, 0.3 and 1, with the input in several batches (the hash
reads the global live-row position, so batch boundaries must not
matter) and above a filter whose live counts stay on the device.  The
hash itself must equal the reference's numpy uint32 one bit for bit on
positions past 2^31 and 2^32.  Everything is exact.
"""
import datetime as pydt
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec import plan as JP
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.exec import plan as PP
from spark_rapids_tpu_torch.exec.plan import (CoalesceBatchesExec,
                                              ExecContext, HostScanExec,
                                              RangeExec, SampleExec)
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
SMALL_BATCHES = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(7)
    n = 5000
    return pa.table({
        "k": pa.array(np.arange(n), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "s": pa.array([f"row{i % 37}" for i in range(n)])})


def _three(table, build, conf=None):
    """(port, reference device path, reference CPU fallback) dicts."""
    jdf = build(JE, JA, jcol, JSession(conf).from_arrow(table))
    ref = jdf.collect().to_pydict()
    cpu = JDF(jdf._plan, JSession({**(conf or {}), **ORACLE})) \
        .collect().to_pydict()
    got = build(PE, PA, pcol,
                PSession(conf, device="cpu").from_arrow(table)).to_pydict()
    return got, ref, cpu


@pytest.mark.parametrize("fraction", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sample_keeps_the_reference_rows(table, seed, fraction):
    got, ref, cpu = _three(
        table, lambda E, A, c, df: df.sample(fraction, seed=seed),
        SMALL_BATCHES)
    assert got == ref == cpu
    n = len(got["k"])
    assert n == {0.0: 0, 1.0: table.num_rows}.get(fraction, n)
    if fraction == 0.3:
        assert abs(n / table.num_rows - 0.3) < 0.05


def test_sample_above_a_filter_and_under_an_aggregate(table):
    """The filter leaves its live counts on the device; the sample's
    global positions must follow the live rows."""
    def build(E, A, c, df):
        return (df.filter(E.GreaterThan(c("v"), E.Literal(500)))
                .sample(0.4, seed=11)
                .agg((A.Count(None), "n"), (A.Sum(c("v")), "sv")))
    got, ref, cpu = _three(table, build, SMALL_BATCHES)
    assert got == ref == cpu
    assert got["n"][0] > 0


def test_sample_hash_equals_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    pos = np.concatenate([np.arange(2000), rng.integers(0, 2 ** 40, 5000),
                          [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                           2 ** 32 + 5]]).astype(np.int64)
    for seed in (0, 1, 42, -3, 2 ** 31 + 9):
        want = JP.sample_hash_u32(pos.astype(np.uint32), seed)
        got = PP.sample_hash_u32(torch.from_numpy(pos), seed).numpy()
        assert (got == want.astype(np.int64)).all(), seed
    for f in (0.0, 1e-10, 0.3, 0.5, 0.999999999, 1.0):
        assert PP.sample_threshold(f) == JP.sample_threshold(f)


def test_sample_fraction_out_of_range_raises(table):
    with pytest.raises(ValueError):
        PSession(device="cpu").from_arrow(table).sample(1.5)


@pytest.mark.parametrize("args", [(3, 30, 4), (0, 0, 1), (10, -7, -3),
                                  (-5, 5, 1), (0, 5000, 1)])
def test_range_equals_the_reference(args):
    start, end, step = args
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}
    got = PSession(conf, device="cpu").range(start, end, step).to_pydict()
    ref = JSession(conf).range(start, end, step).collect().to_pydict()
    assert got == ref == {"id": list(range(start, end, step))}


def test_range_batches_and_keys():
    ctx = ExecContext(device=torch.device("cpu"))
    r = RangeExec(3, 30, 4, batch_rows=3)
    assert [b.num_rows for b in r.execute(ctx)] == [3, 3, 1]
    assert r.collect(ctx).to_pydict() == {"id": list(range(3, 30, 4))}
    assert r.keys_unique(["id"]) and not r.keys_unique(["x"])
    assert RangeExec(0, 0).collect(ctx).num_rows == 0


def test_range_sample_group_by_count(table):
    """`range(...).sample(...)` grouped by id % 10 into COUNT and SUM, and
    `count()`, as the reference (the card's range_sample query)."""
    def build(E, A, c, s):
        return (s.range(0, 50_000).sample(0.01, seed=7)
                .group_by(E.Alias(E.Remainder(c("id"), E.Literal(10)), "m"))
                .agg((A.Count(None), "n"), (A.Sum(c("id")), "s"))
                .sort("m"))
    ref = build(JE, JA, jcol, JSession(SMALL_BATCHES)).collect().to_pydict()
    got = build(PE, PA, pcol, PSession(SMALL_BATCHES, device="cpu")) \
        .to_pydict()
    assert got == ref
    n = PSession(SMALL_BATCHES, device="cpu").range(0, 50_000) \
        .sample(0.01, seed=7).count()
    assert n == JSession(SMALL_BATCHES).range(0, 50_000) \
        .sample(0.01, seed=7).count() == sum(got["n"])


LTABLE = pa.table({
    "a": pa.array([1, 2, None, 4, 5, 6, 7, None], pa.int64()),
    "b": pa.array([10.0, 20.0, 30.0, None, 50.0, 60.0, 70.0, 80.0]),
    "s": pa.array(["x", "y", "x", "z", None, "y", "x", "z"])})


def test_coalesce_batches_as_the_reference_plan_test():
    """The cases of the reference's tests/test_plan.py coalesce test."""
    ctx = ExecContext(device=torch.device("cpu"))
    scan = HostScanExec(from_arrow(LTABLE), 2)
    plan = CoalesceBatchesExec(scan, target_rows=5)
    assert [b.num_rows for b in plan.execute(ctx)] == [4, 4]
    assert plan.collect(ctx).to_pydict() == LTABLE.to_pydict()
    single = CoalesceBatchesExec(scan, require_single=True)
    assert [b.num_rows for b in single.execute(ctx)] == [8]
    assert single.collect(ctx).to_pydict() == LTABLE.to_pydict()
    ref = JP.CoalesceBatchesExec(JP.HostScanExec.from_table(LTABLE, 2),
                                 target_rows=5)
    assert [b.num_rows for b in ref.execute(JP.ExecContext())] == [4, 4]


PYDICT = {"a": [1, None, 3], "f": [1.5, 2, None], "s": ["x", None, "y"],
          "d": [pydec.Decimal("1.25"), None, pydec.Decimal("-10.5")],
          "dt": [pydt.date(2020, 1, 1), None, pydt.date(1969, 12, 31)],
          "b": [True, False, None], "n": [None, None, None]}


def test_from_pydict_infers_the_reference_types():
    got = PSession(device="cpu").from_pydict(PYDICT)
    ref = JSession().from_pydict(PYDICT)
    assert [f.data_type.simple_string for f in got.schema.fields] == \
        [f.data_type.simple_string for f in ref.schema.fields]
    assert got.to_pydict() == ref.collect().to_pydict()


def test_count_and_explain(table):
    s = PSession(device="cpu")
    df = s.from_arrow(table).filter(PE.GreaterThan(pcol("v"),
                                                   PE.Literal(500)))
    assert df.count() == JSession().from_arrow(table).filter(
        JE.GreaterThan(jcol("v"), JE.Literal(500))).count()
    assert s.range(0).count() == 0
    text = s.range(10).sample(0.5, seed=1).explain()
    assert "SampleExec[0.5, seed=1]" in text and "RangeExec[0, 10, 1]" in \
        text
    assert text.index("SampleExec") < text.index("RangeExec")
