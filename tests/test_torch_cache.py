"""The port's cached plans (spark_rapids_tpu_torch/exec/cache.py, the
ParquetCachedBatchSerializer role): port copies of tests/test_cache.py.
The cache buffer is Zstandard Parquet written by the port's own writer;
pyarrow reads it as the reference's cache would be read, and the cached
replay equals the uncached query exactly.
"""
import io
import threading

import numpy as np
import pytest
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.plan.overrides import apply_overrides
from spark_rapids_tpu_torch.session import TpuSession, col

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_cache_materializes_once_and_reuses():
    rng = np.random.default_rng(4)
    tbl = pa.table({"k": pa.array(rng.integers(0, 10, 5000), pa.int64()),
                    "v": pa.array(rng.standard_normal(5000))})
    s = TpuSession(device="cpu")
    base = s.from_arrow(tbl).filter(
        E.GreaterThan(col("v"), E.Literal(0.0))).cache()
    lc = base._plan
    assert not lc.materialized()
    r1 = base.collect()
    assert lc.materialized()
    size1 = lc.cached_bytes()
    assert size1 > 0
    # downstream plans reuse the same buffer (no rematerialization)
    agg = base.group_by("k").agg((Sum(col("v")), "sv"), (Count(None), "c"))
    out = agg.collect()
    assert lc.cached_bytes() == size1
    k = tbl.column("k").to_numpy()[tbl.column("v").to_numpy() > 0]
    assert out.num_rows == len(np.unique(k))
    assert sorted(out.column_by_name("c").to_pylist()) == \
        sorted(np.bincount(k)[np.unique(k)].tolist())
    assert r1.num_rows == len(k)
    # the buffer is a Zstandard Parquet file pyarrow reads
    back = pq.read_table(io.BytesIO(lc._buffer))
    meta = pq.ParquetFile(io.BytesIO(lc._buffer)).metadata
    assert meta.row_group(0).column(0).compression == "ZSTD"
    assert back.to_pydict() == s.from_arrow(tbl).filter(
        E.GreaterThan(col("v"), E.Literal(0.0))).collect().to_pydict()
    # replays equal the uncached plan
    assert base.collect().to_pydict() == r1.to_pydict()


def test_cache_device_placement():
    tbl = pa.table({"x": pa.array(range(100), pa.int64())})
    s = TpuSession(device="cpu")
    df = s.from_arrow(tbl).cache()
    q = apply_overrides(df._plan, device=CPU)
    assert q.kind == "device"
    assert "HostToDeviceExec" in q.physical_tree()
    assert q.collect().num_rows == 100


def test_cache_idempotent():
    tbl = pa.table({"x": pa.array([1], pa.int64())})
    s = TpuSession(device="cpu")
    df = s.from_arrow(tbl).cache()
    assert df.cache()._plan is df._plan


def test_cache_explain_only_no_materialization():
    tbl = pa.table({"x": pa.array(range(10), pa.int64())})
    s = TpuSession(device="cpu")
    df = s.from_arrow(tbl).cache()
    conf = TpuConf({"spark.rapids.tpu.sql.mode": "explainOnly"})
    q = apply_overrides(df._plan, conf, device=CPU)
    q.explain()
    assert not df._plan.materialized()   # explain ran nothing


def test_cache_lazy_until_execute():
    tbl = pa.table({"x": pa.array(range(10), pa.int64())})
    s = TpuSession(device="cpu")
    df = s.from_arrow(tbl).cache()
    q = apply_overrides(df._plan, device=CPU)
    assert not df._plan.materialized()   # conversion is side-effect free
    q.collect()
    assert df._plan.materialized()


def test_cache_streams_row_groups_with_strings_and_nulls():
    hb = from_arrow(pa.table({
        "s": pa.array([None if i % 7 == 0 else f"s{i % 13}"
                       for i in range(3000)]),
        "d": pa.array([i / 3 for i in range(3000)])}))
    s = TpuSession({"spark.rapids.tpu.sql.batchSizeRows": "1024"},
                   device="cpu")
    df = s.from_host(hb).cache()
    assert df.collect().to_pydict() == hb.to_pydict()
    assert df._plan.raw_bytes() > 0


@pytest.mark.parametrize("sql_enabled", ["true", "false"])
def test_first_read_of_a_cache_shares_the_query_s_permit(sql_enabled):
    """At concurrentTpuTasks=1, on the card's plan and on the CPU engine,
    the first query over a cache()d DataFrame materializes it under its
    own device permit and gives the permit back (ROADMAP Queue 3 item
    20: the reference's materialization takes a second permit, which
    waits on the first for ever)."""
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.runtime.semaphore import _semaphore
    tbl = pa.table({"k": pa.array(np.arange(100) % 7, pa.int64()),
                    "v": pa.array(np.arange(100), pa.int64())})
    s = TpuSession({"spark.rapids.tpu.sql.concurrentTpuTasks": 1,
                    "spark.rapids.tpu.sql.enabled": sql_enabled},
                   device="cpu")
    base = s.from_arrow(tbl).cache()
    q = base.group_by("k").agg((Sum(col("v")), "sv")).physical()
    ctx = ExecContext(q.conf, q.device)
    out = {}
    runner = threading.Thread(target=lambda: out.update(
        got=q.collect(ctx).to_pydict()), daemon=True)
    runner.start()
    runner.join(timeout=60)
    assert not runner.is_alive(), "the cache's materialization deadlocked"
    assert dict(zip(out["got"]["k"], out["got"]["sv"])) == \
        {k: sum(range(k, 100, 7)) for k in range(7)}
    assert base._plan.materialized()
    assert ctx.device_permit_depth == 0
    sem = _semaphore(q.conf)
    assert sem.acquire(blocking=False)
    sem.release()
