"""The port's memory runtime against the JAX package's.

The budget and its three tiers (device, pinned host lanes, checksummed
disk blocks), LRU spill, the OOM when nothing is left to spill, the
release-underflow clamp, the retry ladder (replayed OOMs, split-retry,
rollback of a failed attempt's reservations), the out-of-core sort and
the high-cardinality aggregation fallback, and the bucket hash
`_agg_partition_ids`, bit-equal to the reference's, all on CPU tensors
and under one conf dict with the reference where both run.
"""
import collections
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceBatch as JBatch
from spark_rapids_tpu.columnar.device import to_device as jto_device
from spark_rapids_tpu.columnar.host import HostBatch as JHost
from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu.exec.plan import ExecContext as JCtx
from spark_rapids_tpu.exec.plan import HashAggregateExec as JAgg
from spark_rapids_tpu.exec.plan import HostScanExec as JScan
from spark_rapids_tpu.exec.plan import SortExec as JSort
from spark_rapids_tpu.exec.plan import _agg_partition_ids as jpartition_ids
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.runtime import retry as JR
from spark_rapids_tpu_torch.columnar.device import DeviceBatch as PBatch
from spark_rapids_tpu_torch.columnar.device import to_device, to_host
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf as PConf
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.exec.plan import HashAggregateExec as PAgg
from spark_rapids_tpu_torch.exec.plan import HostScanExec as PScan
from spark_rapids_tpu_torch.exec.plan import SortExec as PSort
from spark_rapids_tpu_torch.exec.plan import _agg_partition_ids
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.runtime import memory as M
from spark_rapids_tpu_torch.runtime import retry as R

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

CPU = torch.device("cpu")


def small(budget=1 << 20, **kw):
    return {"spark.rapids.tpu.memory.tpu.budgetBytes": budget,
            "spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.sql.shape.minBucketRows": 256, **kw}


def _table(n, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, max(n, 1), n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "v": pa.array(rng.standard_normal(n)),
        "s": pa.array(rng.choice(["a", "é", "zz", "", "b"], n))})


def _batch(n, conf, seed=0):
    return to_device(from_arrow(_table(n, seed)), PConf(conf), device=CPU)


def _lanes(db):
    return [(c.data.clone(), c.validity.clone(), c.dictionary)
            for c in db.columns]


def _same_lanes(db, lanes):
    for c, (d, v, dic) in zip(db.columns, lanes):
        assert torch.equal(c.data, d) and torch.equal(c.validity, v)
        assert c.dictionary is dic


# ---------------------------------------------------------------------------
# the budget and its tiers
# ---------------------------------------------------------------------------

def test_the_limit_is_the_conf_or_nothing_on_the_cpu():
    assert M.MemoryBudget(PConf(small(12345)), CPU).limit == 12345
    # allocFraction applies to a CUDA device's memory only
    assert M.MemoryBudget(PConf({}), CPU).limit == 0
    assert M.device_memory_bytes(CPU) is None


def test_spillable_round_trips_through_host_and_disk_bit_exact(tmp_path):
    conf = small()
    budget = M.MemoryBudget(PConf(conf), CPU)
    db = _batch(700, conf)
    lanes = _lanes(db)
    sp = M.Spillable(db, budget)
    assert budget.live == db.nbytes() and sp.on_device
    sp.spill()
    assert sp.on_host and not sp.on_device and budget.live == 0
    assert budget.host_live == db.nbytes()
    sp.to_disk()
    assert sp.on_disk and not sp.on_host and budget.host_live == 0
    assert budget.metrics["disk_batches"] == 1
    back = sp.get()
    _same_lanes(back, lanes)
    assert back.names == db.names and back.num_rows == 700
    assert not sp.on_disk and budget.live == db.nbytes()
    # a block whose bytes changed on disk fails its checksum
    sp.spill()
    sp.to_disk()
    with open(sp._path, "r+b") as f:
        f.seek(-3, 2)
        byte = f.read(1)
        f.seek(-3, 2)
        f.write(bytes([byte[0] ^ 0x40]))
    with pytest.raises(M.CorruptBlockError, match="checksum"):
        sp.get()
    sp.close()
    assert budget.live == 0 and budget.host_live == 0
    assert budget.metrics["release_underflow"] == 0


def test_a_truncated_block_is_corrupt(tmp_path):
    lanes = [torch.arange(10, dtype=torch.int64), torch.ones(10, dtype=bool)]
    path = str(tmp_path / "b.blk")
    M.write_block(path, lanes)
    got = M.read_block(path, [(torch.int64, 10), (torch.bool, 10)])
    assert all(torch.equal(a, b) for a, b in zip(got, lanes))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 1)
    with pytest.raises(M.CorruptBlockError, match="malformed"):
        M.read_block(path, [(torch.int64, 10), (torch.bool, 10)])


def test_the_budget_spills_least_recently_used_first():
    conf = small(budget=1 << 16)
    budget = M.MemoryBudget(PConf(conf), CPU)
    sps = [M.Spillable(_batch(1000, conf, seed=i), budget)
           for i in range(2)]
    sps[0].get()                          # touch: the first is now newest
    per = sps[0].nbytes
    while budget.live + per <= budget.limit:
        sps.append(M.Spillable(_batch(1000, conf, seed=len(sps)), budget))
    M.Spillable(_batch(1000, conf, seed=99), budget)
    assert not sps[1].on_device and sps[0].on_device
    assert budget.metrics["spilled_batches"] == 1
    assert budget.live <= budget.limit
    for i, sp in enumerate(sps):
        assert int(sp.get().num_rows) == 1000
        sp.spill()


def test_oom_when_nothing_is_left_to_spill():
    budget = M.MemoryBudget(PConf(small(budget=1 << 10)), CPU)
    with pytest.raises(M.TpuRetryOOM, match="nothing left to spill"):
        budget.reserve(1 << 20)
    assert M.is_oom_error(M.TpuRetryOOM("x"))
    assert M.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not M.is_oom_error(RuntimeError("other"))


def test_the_disk_tier_takes_what_the_host_tier_cannot_hold():
    conf = small(budget=1 << 15,
                 **{"spark.rapids.tpu.memory.host.spillStorageSize": 1 << 14})
    budget = M.MemoryBudget(PConf(conf), CPU)
    sps = [M.Spillable(_batch(1000, conf, seed=i), budget)
           for i in range(6)]
    assert budget.metrics["disk_batches"] > 0
    assert sum(sp.on_disk for sp in sps) == budget.metrics["disk_batches"]
    for sp in sps:
        assert int(sp.get().num_rows) == 1000
        sp.spill()
    for sp in sps:
        sp.close()
    assert budget.live == budget.host_live == 0
    assert budget.metrics["release_underflow"] == 0


def test_close_is_idempotent():
    conf = small()
    budget = M.MemoryBudget(PConf(conf), CPU)
    sp = M.Spillable(_batch(100, conf), budget)
    sp.spill()
    sp.to_disk()
    path = sp._path
    sp.close()
    assert sp.closed and budget.live == 0 and not os.path.exists(path)
    sp.close()
    sp.close()
    assert budget.live == 0 and budget.metrics["release_underflow"] == 0
    assert len(budget._spillables) == 0


def test_a_release_underflow_is_clamped_and_counted():
    budget = M.MemoryBudget(PConf(small()), CPU)
    budget.reserve(100)
    budget.release(100)
    budget.release(50)
    assert budget.live == 0 and budget.metrics["release_underflow"] == 1
    budget.host_reserve(10)
    budget.host_release(10)
    budget.host_release(10)
    assert budget.host_live == 0 and budget.metrics["release_underflow"] == 2


def test_the_census_sums_every_budget():
    base = M.CENSUS.totals()["live_bytes"]
    a = M.MemoryBudget(PConf(small()), CPU)
    b = M.MemoryBudget(PConf(small()), CPU)
    a.reserve(1000)
    b.reserve(24)
    assert M.CENSUS.totals()["live_bytes"] == base + 1024
    assert M.CENSUS.totals()["peak_bytes"] >= base + 1024
    a.release(1000)
    b.release(24)
    assert M.CENSUS.totals()["live_bytes"] == base


def test_a_budget_collected_under_the_census_lock_does_not_deadlock():
    # the garbage collector may finalize a budget at any bytecode, inside
    # DeviceCensus.adjust too (it hung a chip smoke in the path phase)
    import threading
    census = M.DeviceCensus()

    class Budget:
        pass
    held = Budget()
    cell = census.register(held)
    cell[0] = 100
    census.adjust(100)

    def collect_inside():
        nonlocal held
        with census._lock:
            held = None             # the finalizer runs here
        census.adjust(0)
    t = threading.Thread(target=collect_inside, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert census.totals() == {"live_bytes": 0, "peak_bytes": 100}


# ---------------------------------------------------------------------------
# the retry ladder
# ---------------------------------------------------------------------------

def _ref_batch(n, seed=0):
    table = _table(n, seed)
    return jto_device(JHost(table.to_batches()[0]), JConf(small()))


def _host_rows(db, cols=("k", "v", "s")):
    hb = to_host(db, int(db.num_rows))
    return {c: hb.columns[hb.names.index(c)].to_pylist() for c in cols}


def test_split_and_slice_equal_the_reference():
    conf = small()
    db, jdb = _batch(1001, conf), _ref_batch(1001)
    halves = R.split_batch(db, PConf(conf))
    jhalves = JR.split_batch(jdb, JConf(conf))
    assert [h.num_rows for h in halves] == [h.num_rows for h in jhalves]
    assert [h.capacity for h in halves] == [h.capacity for h in jhalves]
    whole = _host_rows(db)
    assert {c: _host_rows(halves[0])[c] + _host_rows(halves[1])[c]
            for c in whole} == whole
    s = R.slice_batch(db, 10, 35, PConf(conf))
    assert s.num_rows == 25
    assert _host_rows(s) == {c: v[10:35] for c, v in whole.items()}
    with pytest.raises(M.TpuRetryOOM):
        R.split_batch(_batch(1, conf), PConf(conf))


def test_with_retry_replays_an_injected_oom():
    conf = PConf(small())
    budget = M.MemoryBudget(conf, CPU)
    calls = []

    def attempt():
        calls.append(1)
        budget.reserve(64)
        budget.release(64)
        if len(calls) == 1:           # the first attempt fails
            raise M.TpuRetryOOM("synthetic")
        return "ok"
    assert R.with_retry(budget, conf, attempt) == "ok"
    assert len(calls) == 2 and budget.metrics["oom_retries"] == 1
    assert budget.live == 0


def test_with_retry_rolls_back_a_failed_attempts_reservations():
    conf = PConf(small(**{"spark.rapids.tpu.sql.retry.maxAttempts": 3}))
    budget = M.MemoryBudget(conf, CPU)
    calls = []

    def attempt():
        calls.append(1)
        budget.reserve(100)           # leaked by the failing attempts
        if len(calls) < 3:
            raise M.TpuRetryOOM("synthetic")
        return len(calls)
    assert R.with_retry(budget, conf, attempt) == 3
    assert budget.live == 100 and budget.metrics[
        "attempt_rollback_bytes"] == 200
    with pytest.raises(ValueError):
        R.with_retry(budget, conf, lambda: (budget.reserve(7),
                                            int("x")))
    assert budget.live == 100


def test_with_split_retry_halves_until_it_fits_and_gives_up():
    conf = PConf(small())
    budget = M.MemoryBudget(conf, CPU)
    failed = set()

    def attempt(b):
        n = int(b.num_rows)
        if n > 300:
            failed.add(n)
            raise M.TpuRetryOOM(f"too big: {n}")
        return n
    outs = list(R.with_split_retry(budget, conf, _batch(1000, small()),
                                   attempt))
    assert sum(outs) == 1000 and max(outs) <= 300 and failed
    assert budget.metrics["batch_splits"] > 0
    capped = PConf(small(**{"spark.rapids.tpu.sql.retry.maxSplits": 2}))

    def always(b):
        raise M.TpuRetryOOM("always")
    with pytest.raises(M.TpuSplitAndRetryOOM):
        list(R.with_split_retry(M.MemoryBudget(capped, CPU), capped,
                                _batch(64, small()), always))


def test_retry_io_retries_os_errors_and_not_corruption():
    conf = PConf({"spark.rapids.tpu.retry.io.backoffMs": 0})
    budget = M.MemoryBudget(conf, CPU)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"
    assert R.retry_io(conf, "spill_write", flaky, budget=budget) == "done"
    assert budget.metrics["io_retries"] == 2

    def corrupt():
        calls.append(1)
        raise M.CorruptBlockError("bad")
    n = len(calls)
    with pytest.raises(M.CorruptBlockError):
        R.retry_io(conf, "spill_read", corrupt)
    assert len(calls) == n + 1


# ---------------------------------------------------------------------------
# the out-of-core sort
# ---------------------------------------------------------------------------

def _sort_both(table, keys, conf, rows):
    jctx = JCtx(JConf(conf))
    pctx = PCtx(PConf(conf), CPU)
    want = JSort(keys, JScan.from_table(table, rows)).collect(jctx)
    got = PSort(keys, PScan(from_arrow(table), rows)).collect(pctx)
    return got.to_pydict(), want.to_pydict(), pctx


def test_ooc_sort_under_a_budget_a_tenth_of_its_input():
    rng = np.random.default_rng(5)
    table = pa.table({"v": pa.array(rng.standard_normal(20_000)),
                      "i": pa.array(np.arange(20_000), pa.int64())})
    got, want, ctx = _sort_both(table, [(0, True, True)],
                                small(budget=1 << 16), 1024)
    assert got == want
    assert got["v"] == sorted(table.column("v").to_pylist())
    assert ctx.metrics["sort_runs"] > 1
    assert ctx.metrics["sort_merge_passes"] >= 1
    assert ctx.budget.metrics["spilled_batches"] > 0


def test_ooc_sort_descending_with_ties_and_nulls():
    rng = np.random.default_rng(6)
    v = rng.integers(0, 50, 5000).astype("float64")
    mask = rng.random(5000) < 0.1
    table = pa.table({"v": pa.array(np.where(mask, 0, v), mask=mask)})
    got, want, ctx = _sort_both(table, [(0, False, False)],
                                small(budget=1 << 14), 512)
    nn = [x for x in got["v"] if x is not None]
    assert nn == sorted(nn, reverse=True)
    assert got["v"][len(nn):] == [None] * (5000 - len(nn))
    assert got == want
    assert ctx.metrics["sort_runs"] > 1


def test_a_sort_with_no_budget_is_one_run():
    table = pa.table({"v": pa.array(np.random.default_rng(1)
                                    .standard_normal(2000))})
    got, want, ctx = _sort_both(table, [(0, True, True)], small(budget=0),
                                512)
    assert got == want and ctx.metrics["sort_runs"] == 1
    assert "sort_merge_passes" not in ctx.metrics


def test_an_oom_split_run_sorts_each_half_as_its_own_run(monkeypatch):
    import spark_rapids_tpu_torch.exec.ooc_sort as OS
    real = OS.sort_batch

    def flaky(db, keys, conf):
        if int(db.num_rows) > 6000:
            raise M.TpuRetryOOM("synthetic: batch too big")
        return real(db, keys, conf)
    monkeypatch.setattr(OS, "sort_batch", flaky)
    rng = np.random.default_rng(21)
    table = pa.table({"v": pa.array(rng.standard_normal(20_000))})
    ctx = PCtx(PConf(small(budget=1 << 17)), CPU)
    out = PSort([(0, True, True)], PScan(from_arrow(table), 1024)) \
        .collect(ctx).to_pydict()["v"]
    assert out == sorted(table.column("v").to_pylist())
    assert ctx.budget.metrics["oom_retries"] > 0


def test_a_limit_above_an_ooc_sort_leaves_nothing():
    table = pa.table({"v": pa.array(np.random.default_rng(23)
                                    .standard_normal(20_000))})
    ctx = PCtx(PConf(small(budget=1 << 16)), CPU)
    it = PSort([(0, True, True)], PScan(from_arrow(table), 1024)) \
        .execute(ctx)
    next(it)
    it.close()
    assert ctx.budget.live == 0 and len(ctx.budget._spillables) == 0


# ---------------------------------------------------------------------------
# the high-cardinality aggregation fallback
# ---------------------------------------------------------------------------

def _agg_both(table, key, aggs, conf, rows):
    jctx = JCtx(JConf(conf))
    pctx = PCtx(PConf(conf), CPU)
    want = JAgg([JE.ColumnRef(key)], [key], aggs(JA, JE),
                JScan.from_table(table, rows)).collect(jctx).to_pydict()
    got = PAgg([PE.ColumnRef(key)], [key], aggs(PA, PE),
               PScan(from_arrow(table), rows)).collect(pctx).to_pydict()
    return got, want, pctx, jctx


def test_the_high_cardinality_fallback_with_string_keys():
    # one string value in many batches lands in one bucket, whatever
    # codes each batch gives it
    rng = np.random.default_rng(11)
    ks = [f"key_{i}" for i in rng.integers(0, 3000, 6000)]
    table = pa.table({"k": pa.array(ks),
                      "v": pa.array(rng.integers(0, 9, 6000), pa.int64())})
    got, want, pctx, jctx = _agg_both(
        table, "k", lambda a, e: [(a.Count(None), "c"),
                                  (a.Sum(e.ColumnRef("v")), "sv")],
        small(budget=1 << 18, **{"spark.rapids.tpu.sql.batchSizeRows": 512,
                                 "spark.rapids.tpu.sql.agg.denseDomainViaSort":
                                     "true"}), 512)
    assert pctx.metrics["agg_repartition_fallbacks"] >= 1
    assert pctx.metrics["ooc.agg_elections.rows"] == 1
    assert pctx.metrics["ooc.agg_partitions"] == \
        jctx.metrics["ooc.agg_partitions"]
    # the groups of a bucket come out in dictionary-code order, and the
    # reference's merged dictionaries are not sorted: compare as sets
    assert sorted(zip(*got.values())) == sorted(zip(*want.values()))
    assert dict(zip(got["k"], got["c"])) == dict(collections.Counter(ks))


def test_low_cardinality_keeps_the_resident_merge():
    rng = np.random.default_rng(12)
    table = pa.table({"k": pa.array(rng.integers(0, 10, 20_000), pa.int64()),
                      "v": pa.array(np.ones(20_000))})
    got, want, pctx, _j = _agg_both(
        table, "k", lambda a, e: [(a.Count(None), "c")], small(), 1024)
    assert pctx.metrics.get("agg_repartition_fallbacks", 0) == 0
    assert got == want and sum(got["c"]) == 20_000


# ---------------------------------------------------------------------------
# the bucket hash
# ---------------------------------------------------------------------------

def _hash_table(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 1e6
    f[:9] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 2.5, -7.75]
    return pa.table({
        "i": pa.array(rng.integers(-2 ** 62, 2 ** 62, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "d": pa.array(f, mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(["a", "bb", "é", "zz", "", None], n)),
        "j": pa.array(rng.integers(-5, 5, n).astype(np.int32)),
        "b": pa.array(rng.random(n) < 0.5)})


@pytest.mark.parametrize("cols", [["i"], ["d"], ["s"], ["j"], ["b"],
                                  ["i", "d", "s", "j", "b"], ["s", "d"]])
@pytest.mark.parametrize("salt", [0, 1])
def test_agg_partition_ids_are_bit_equal_to_the_reference(cols, salt):
    table = _hash_table().select(cols)
    jdb = jto_device(JHost(table.to_batches()[0]), JConf({}))
    pdb = to_device(from_arrow(table), device=CPU)
    for k in (2, 7, 8, 64):
        want = np.asarray(jpartition_ids(jdb, len(cols), k, salt))
        got = _agg_partition_ids(pdb, len(cols), k, salt).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), k


def test_a_double_key_hashes_its_value_not_its_storage():
    # -0.0 and 0.0 bucket together, a FLOAT key as its DOUBLE value, and
    # the salts decorrelate rather than rotate labels
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.columnar.device import DeviceColumn
    vals = torch.tensor([1.5, -2.25, 1e6 + 0.125, -0.0, 3.0, 1e-3, 0.0],
                        dtype=torch.float64)
    valid = torch.ones(7, dtype=torch.bool)
    a = PBatch([DeviceColumn(vals, valid, PT.DOUBLE)], 7, ["k"])
    b = PBatch([DeviceColumn(vals.to(torch.float32), valid, PT.FLOAT)], 7,
               ["k"])
    s0 = _agg_partition_ids(a, 1, 8, 0)
    assert torch.equal(s0, _agg_partition_ids(b, 1, 8, 0))
    assert s0[3] == s0[6]
    s1 = _agg_partition_ids(a, 1, 8, 1)
    assert not torch.equal((s1 - s0) % 8, torch.full_like(s0, int(
        (s1[0] - s0[0]) % 8)))


def test_partition_ids_match_across_batches_with_other_dictionaries():
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.columnar.device import DeviceColumn
    one = np.array(["a", "b", "zz"])
    two = np.array(["b", "q", "zz"])
    codes = torch.tensor([0, 2, 1], dtype=torch.int32)
    valid = torch.ones(3, dtype=torch.bool)
    x = _agg_partition_ids(PBatch([DeviceColumn(codes, valid, PT.STRING,
                                                one)], 3, ["s"]), 1, 8)
    y = _agg_partition_ids(PBatch([DeviceColumn(
        torch.tensor([1, 2, 0], dtype=torch.int32), valid, PT.STRING, two)],
        3, ["s"]), 1, 8)
    assert x[1] == y[1] and x[2] == y[2]        # "zz" and "b"


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_batches_bucket_the_same_rows(seed):
    # the same rows through both packages' scans: equal buckets row by
    # row at every padding position too
    table = _hash_table(700, seed)
    jdb = jto_device(JHost(table.to_batches()[0]), JConf(small()))
    pdb = to_device(from_arrow(table), PConf(small()), device=CPU)
    assert isinstance(jdb, JBatch) and jdb.capacity == pdb.capacity
    want = np.asarray(jpartition_ids(jdb, 5, 16, 3))
    assert np.array_equal(_agg_partition_ids(pdb, 5, 16, 3).numpy(), want)

