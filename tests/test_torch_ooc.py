"""The port's out-of-core tier against the JAX package's.

The partition policy, the sub-partition join (every join type, empty
build buckets, the byte gate, skew recursion), the adaptive join's
spillable stages and the spill-partitioned aggregation, each through
both packages under one conf dict on identical inputs (the port on CPU
tensors).  The
port's bucket ids are bit-equal to the reference's, so a sub-partitioned
join with no sort above it comes out in the reference's row order.  A
LIMIT above an out-of-core join or aggregation must leave no registered
spillable, no budget byte and no block file behind.
"""
import os
import warnings

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu.exec import ooc as JO
from spark_rapids_tpu.exec.join import HashJoinExec as JJoin
from spark_rapids_tpu.exec.plan import ExecContext as JCtx
from spark_rapids_tpu.exec.plan import HashAggregateExec as JAgg
from spark_rapids_tpu.exec.plan import HostScanExec as JScan
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf as PConf
from spark_rapids_tpu_torch.exec import ooc as PO
from spark_rapids_tpu_torch.exec.join import HashJoinExec as PJoin
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.exec.plan import HashAggregateExec as PAgg
from spark_rapids_tpu_torch.exec.plan import HostScanExec as PScan
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

#: the reference's hash-table join tier, the one the port runs
HASH_TIER = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON",
             "spark.rapids.tpu.sql.kernels.pallas.join.denseReplace": "ON"}
SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
         "spark.rapids.tpu.sql.shape.minBucketRows": 256}


def _ctxs(conf):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # denseReplace: resolved
        return JCtx(JConf(dict(conf))), PCtx(PConf(dict(conf)), "cpu")


def _scans(table, rows):
    return JScan.from_table(table, rows), PScan(from_arrow(table), rows)


def _join(pkg, how, left, right, lkey="lk", rkey="rk"):
    join, e = (JJoin, JE) if pkg == "j" else (PJoin, PE)
    return join(how, [e.ColumnRef(lkey)], [e.ColumnRef(rkey)], left, right)


def _both(make, conf):
    """(port result, reference result, port ctx, reference ctx) of one
    plan built for each package by `make(pkg, scans)`."""
    jctx, pctx = _ctxs(conf)
    want = make("j").collect(jctx).to_pydict()
    got = make("p").collect(pctx).to_pydict()
    return got, want, pctx, jctx


def _sorted_rows(d):
    return sorted(tuple((v is None, v) for v in row)
                  for row in zip(*d.values()))


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,rows_k,window", [
    (1 << 20, 1, 1 << 20), (5 << 20, 1, 1 << 20), (100 << 20, 1, 1 << 20),
    (0, 1, 1 << 20), (1 << 20, 16, 1 << 20), (1 << 40, 1, None),
    (1 << 40, 8, None), (1 << 40, 128, None)])
def test_partition_count_equals_the_reference(total, rows_k, window):
    jp = JO.OocPolicy(True, False, window, 64, 3)
    pp = PO.OocPolicy(True, False, window, 64, 3)
    assert PO.partition_count(total, pp, rows_k) == \
        JO.partition_count(total, jp, rows_k)


def test_partition_count_derives_from_bytes():
    pol = PO.OocPolicy(True, False, 1 << 20, 64, 3)
    assert PO.partition_count(1 << 20, pol) == 2        # fits one window
    assert PO.partition_count(5 << 20, pol) == 8        # ceil 5 -> pow2
    assert PO.partition_count(100 << 20, pol) == 64     # clamped
    assert PO.partition_count(1 << 20, pol, rows_k=16) == 16


def test_policy_resolution_and_bytes_trip():
    budget = {"spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 20}
    jctx, pctx = _ctxs(budget)
    pol = PO.ooc_policy(pctx)
    assert pol == PO.OocPolicy(*vars(JO.ooc_policy(jctx)).values())
    assert pol.window == 1 << 19            # residentFraction 0.5
    assert pol.bytes_trip((1 << 19) + 1) and not pol.bytes_trip(1 << 19)
    assert not pol.force
    pctx.ooc_force = True
    assert PO.ooc_policy(pctx).force
    _j, off = _ctxs({**budget, "spark.rapids.tpu.sql.ooc.enabled": False})
    pol_off = PO.ooc_policy(off)
    assert pol_off.window is None and not pol_off.bytes_trip(1 << 40)
    # no budget on the CPU: no window
    _j, none = _ctxs({})
    assert none.budget.limit == 0 and PO.ooc_policy(none).window is None


# ---------------------------------------------------------------------------
# the sub-partition join
# ---------------------------------------------------------------------------

def _probe(n=1500, seed=3, keys=300):
    rng = np.random.default_rng(seed)
    return pa.table({
        "lk": pa.array(rng.integers(-5, keys, n), pa.int64(),
                       mask=rng.random(n) < 0.05),
        "lv": pa.array(rng.integers(-1000, 1000, n), pa.int64())})


def _build(n=2600, seed=4, keys=300):
    rng = np.random.default_rng(seed)
    return pa.table({
        "rk": pa.array(rng.integers(0, keys, n), pa.int64(),
                       mask=rng.random(n) < 0.05),
        "rv": pa.array(rng.standard_normal(n))})


HOWS = ["inner", "left_outer", "right_outer", "full_outer", "left_semi",
        "left_anti"]


@pytest.mark.parametrize("how", HOWS)
def test_every_join_type_sub_partitions_like_the_reference(how):
    # 2,600 build rows over a 2 x 1,024-row gate: k = 2 buckets
    lt, rt = _probe(), _build()

    def make(pkg):
        ls, rs = _scans(lt, 512)[pkg == "p"], _scans(rt, 512)[pkg == "p"]
        return _join(pkg, how, ls, rs)
    got, want, pctx, jctx = _both(make, {**HASH_TIER, **SMALL})
    assert pctx.metrics["join_subpartition_fallbacks"] == \
        jctx.metrics["join_subpartition_fallbacks"] == 1
    assert pctx.metrics["ooc.join_partitions"] == \
        jctx.metrics["ooc.join_partitions"] == 2
    assert got == want and len(next(iter(got.values()))) > 0


@pytest.mark.parametrize("how", HOWS)
def test_empty_build_buckets_follow_the_empty_build_rule(how):
    # a forced out-of-core join (k = 2) whose build keys (3, 2 and a
    # null) all hash to bucket 1: bucket 0 holds probe rows and no build
    import torch
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        DeviceColumn)
    from spark_rapids_tpu_torch.exec.plan import _agg_partition_ids
    keys = torch.tensor([3, 2, 0, 7], dtype=torch.int64)
    ids = _agg_partition_ids(DeviceBatch([DeviceColumn(
        keys, torch.tensor([True, True, False, True]), PT.LONG)], 4, ["k"]),
        1, 2, 0)
    assert ids.tolist() == [1, 1, 1, 0]
    lt = _probe(n=900, keys=40)
    rt = pa.table({"rk": pa.array([3, 3, 2, None], pa.int64()),
                   "rv": pa.array([0.5, 1.5, 2.5, 3.5])})
    conf = {**HASH_TIER, **SMALL, "spark.rapids.tpu.sql.ooc.force": "true",
            "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 16}

    def make(pkg):
        ls, rs = _scans(lt, 256)[pkg == "p"], _scans(rt, 256)[pkg == "p"]
        return _join(pkg, how, ls, rs)
    got, want, pctx, jctx = _both(make, conf)
    assert pctx.metrics["ooc.join_elections.forced"] == 1
    assert pctx.metrics["ooc.join_partitions"] == \
        jctx.metrics["ooc.join_partitions"] == 2
    assert got == want
    if how in ("left_outer", "full_outer", "left_anti"):
        assert len(got["lk"]) >= 800


def _wide(n_left=1500, n_right=900, ncols=24, seed=7):
    """A build below the 2 x batchSizeRows row gate but far above a small
    resident window in bytes (wide payload rows)."""
    rng = np.random.default_rng(seed)
    lt = pa.table({"lk": pa.array(rng.integers(0, 300, n_left), pa.int64()),
                   "lv": pa.array(rng.standard_normal(n_left))})
    rcols = {"rk": pa.array(rng.integers(0, 300, n_right), pa.int64())}
    for i in range(ncols):
        rcols[f"w{i}"] = pa.array(rng.standard_normal(n_right))
    return lt, pa.table(rcols)


def test_wide_rows_trip_the_byte_gate():
    lt, rt = _wide()
    budget = {**SMALL, "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 17}

    def make(pkg):
        ls, rs = _scans(lt, 512)[pkg == "p"], _scans(rt, 512)[pkg == "p"]
        return _join(pkg, "inner", ls, rs)
    got, want, pctx, _j = _both(make, budget)
    # 900 build rows < 2 x 1,024: the measured bytes tripped the gate
    assert pctx.metrics["join_subpartition_fallbacks"] == 1
    assert pctx.metrics["ooc.join_elections.bytes"] == 1
    assert pctx.metrics["ooc.join_partitions"] >= 2
    assert _sorted_rows(got) == _sorted_rows(want)
    # the tier off: a resident build, the same rows
    _j, off = _ctxs({**budget, "spark.rapids.tpu.sql.ooc.enabled": False})
    resident = make("p").collect(off).to_pydict()
    assert off.metrics.get("join_subpartition_fallbacks", 0) == 0
    assert _sorted_rows(resident) == _sorted_rows(got)


def test_a_skewed_bucket_repartitions_recursively():
    # one hot key owns the whole build: the first scatter cannot shrink
    # its bucket, so it re-partitions with a re-salted hash
    rng = np.random.default_rng(11)
    rt = pa.table({"rk": pa.array(np.full(6000, 42), pa.int64()),
                   "rv": pa.array(rng.standard_normal(6000)),
                   "rw": pa.array(rng.standard_normal(6000))})
    lk = np.where(rng.random(2000) < 0.5, 42, 7).astype(np.int64)
    lt = pa.table({"lk": pa.array(lk)})
    conf = {**SMALL, "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 16}

    def make(pkg):
        ls, rs = _scans(lt, 512)[pkg == "p"], _scans(rt, 512)[pkg == "p"]
        return _join(pkg, "left_semi", ls, rs)
    got, want, pctx, jctx = _both(make, conf)
    assert pctx.metrics["ooc.join_recursions"] == \
        jctx.metrics["ooc.join_recursions"] >= 1
    assert got == want and got["lk"] == [42] * int((lk == 42).sum())


def _leaves_nothing(ctx):
    budget = ctx.budget
    assert budget.live == 0, "leaked device budget bytes"
    assert budget.host_live == 0, "leaked host budget bytes"
    assert len(budget._spillables) == 0, "leaked spillable handles"
    assert budget._disk_dir is None or os.listdir(budget._disk_dir) == []
    assert budget.metrics["release_underflow"] == 0


def test_limit_above_an_ooc_join_leaves_nothing():
    lt, rt = _wide(seed=13)
    # a tiny host tier drives the disk rung too
    _j, ctx = _ctxs({**SMALL,
                     "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 17,
                     "spark.rapids.tpu.memory.host.spillStorageSize": 1 << 14,
                     "spark.rapids.tpu.retry.io.backoffMs": 0})
    it = _join("p", "inner", PScan(from_arrow(lt), 512),
               PScan(from_arrow(rt), 512)).execute(ctx)
    next(it)
    it.close()
    assert ctx.metrics["join_subpartition_fallbacks"] == 1
    assert ctx.budget.metrics["disk_batches"] > 0
    _leaves_nothing(ctx)


def test_limit_above_an_ooc_aggregation_leaves_nothing():
    rng = np.random.default_rng(17)
    tbl = pa.table({"k": pa.array(rng.permutation(20_000).astype(np.int64)),
                    "v": pa.array(np.ones(20_000))})
    _j, ctx = _ctxs({**SMALL,
                     "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 17})
    it = PAgg([PE.ColumnRef("k")], ["k"], [(PA.Count(None), "c")],
              PScan(from_arrow(tbl), 1024)).execute(ctx)
    next(it)
    it.close()
    assert ctx.metrics["ooc.agg_elections"] >= 1
    _leaves_nothing(ctx)


# ---------------------------------------------------------------------------
# the spill-partitioned aggregation and the adaptive join's stages
# ---------------------------------------------------------------------------

def test_ooc_aggregation_byte_gate_equals_the_resident_run():
    # wide buffers: the partials' bytes exceed the window long before
    # their rows would merge past one target batch
    rng = np.random.default_rng(19)
    cols = {"k": pa.array(rng.integers(0, 1500, 12_000), pa.int64())}
    for i in range(12):
        cols[f"v{i}"] = pa.array(rng.integers(-999, 999, 12_000), pa.int64())
    tbl = pa.table(cols)

    def make(pkg):
        a, e = (JA, JE) if pkg == "j" else (PA, PE)
        scan = _scans(tbl, 1024)[pkg == "p"]
        agg = JAgg if pkg == "j" else PAgg
        return agg([e.ColumnRef("k")], ["k"],
                   [(a.Sum(e.ColumnRef(f"v{i}")), f"s{i}")
                    for i in range(12)], scan)
    budget = {**SMALL, "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 17}
    got, want, pctx, jctx = _both(make, budget)
    assert pctx.metrics["ooc.agg_elections.bytes"] == 1
    assert pctx.metrics["ooc.agg_partitions"] == \
        jctx.metrics["ooc.agg_partitions"] >= 2
    assert got == want
    resident = make("p").collect(_ctxs(SMALL)[1]).to_pydict()
    assert _sorted_rows(resident) == _sorted_rows(got)


def _join_agg(a, e, c, s):
    rng = np.random.default_rng(23)
    fact = s.from_arrow(pa.table({
        "fk": pa.array(rng.integers(0, 50, 4000), pa.int64()),
        "v": pa.array(rng.integers(-500, 500, 4000), pa.int64())}))
    dim = s.from_arrow(pa.table({
        "k": pa.array(np.arange(60), pa.int64()),
        "w": pa.array(np.arange(60) * 3, pa.int64())}))
    return (fact.join(dim, left_on=["fk"], right_on=["k"])
            .group_by("fk").agg((a.Sum(c("v")), "sv"), (a.Count(None), "n"),
                                (a.Max(c("w")), "mw"))
            .sort("fk"))


def test_forced_ooc_is_bit_identical_to_the_resident_run():
    forced = {"spark.rapids.tpu.sql.ooc.force": "true",
              "spark.rapids.tpu.memory.tpu.budgetBytes": str(1 << 20)}
    clean = _join_agg(PA, PE, pcol, PSession(device="cpu")).to_pydict()
    want = _join_agg(JA, JE, jcol, JSession({**HASH_TIER, **forced})) \
        .collect().to_pydict()
    df = _join_agg(PA, PE, pcol, PSession(forced, device="cpu"))
    q = df.physical()
    ctx = PCtx(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert got == clean == want
    assert ctx.metrics["ooc.join_elections.forced"] == 1
    assert ctx.metrics["ooc.agg_elections.forced"] == 1
    assert ctx.metrics["ooc.join_partitions"] >= 2


def test_adaptive_stages_spill_to_host_and_disk_and_replay():
    # both stages register with a budget smaller than either: the first
    # stage's batches wait on the host and on disk while the second
    # materializes, and the join replays them
    def query(a, e, c, s):
        rng = np.random.default_rng(29)
        fact = s.from_arrow(pa.table({
            "fk": pa.array(rng.integers(0, 900, 6000), pa.int64()),
            "v": pa.array(rng.integers(-9, 9, 6000), pa.int64())}))
        dim = s.from_arrow(pa.table({
            "k": pa.array(rng.permutation(1000), pa.int64()),
            "w": pa.array(rng.integers(0, 99, 1000), pa.int64())}))
        return fact.join(dim, left_on=["fk"], right_on=["k"])
    # (the budget fits under the stages' FOR-narrowed device bytes, the
    # scans' default upload: ops/encodings.py)
    conf = {**SMALL, "spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 13,
            "spark.rapids.tpu.memory.host.spillStorageSize": 1 << 14,
            "spark.rapids.tpu.retry.io.backoffMs": 0}
    want = query(JA, JE, jcol, JSession({**HASH_TIER, **conf})) \
        .collect().to_pydict()
    q = query(PA, PE, pcol, PSession(conf, device="cpu")).physical()
    ctx = PCtx(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert _sorted_rows(got) == _sorted_rows(want) and len(got["fk"]) > 0
    assert ctx.budget.metrics["spilled_batches"] > 0
    assert ctx.budget.metrics["disk_batches"] > 0
    _leaves_nothing(ctx)
