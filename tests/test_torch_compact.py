"""The port's compaction kernel and row-selection ops against the JAX
package's.

`compaction_order`'s plain version against the Pallas kernel
(spark_rapids_tpu.ops.pallas.compact, interpret mode): the front equal,
the tail the identity.  `compact_batch` and `gather_batch` against
spark_rapids_tpu.ops.filter on the same batches, and a standalone
filter (which now compacts) against the JAX package and its CPU oracle.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.device import to_device as jto_device
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.ops import filter as JF
from spark_rapids_tpu.ops.pallas import compact as JC
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.columnar.device import fetch_result_batch
from spark_rapids_tpu_torch.columnar.device import to_device as pto_device
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.ops import filter as PF
from spark_rapids_tpu_torch.ops.hopper import compact as PC
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol


@pytest.mark.parametrize("cap,p", [(1024, 0.5), (4096, 0.02), (1024, 0.0),
                                   (2048, 1.0), (3000, 0.7), (1, 1.0)])
def test_compaction_order_matches_pallas(cap, p):
    rng = np.random.default_rng(cap + int(p * 100))
    keep = rng.random(cap) < p
    want = np.asarray(JC.compaction_order(jnp.asarray(keep), True))
    order, count = PC.compaction_order(torch.from_numpy(keep))
    n = int(keep.sum())
    assert int(count) == n
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(order.numpy()[:n], np.flatnonzero(keep))
    np.testing.assert_array_equal(order.numpy()[n:], np.arange(n, cap))
    # the reference's portable argsort tier gives the same front
    np.testing.assert_array_equal(
        order.numpy()[:n],
        np.asarray(JF.compaction_order(jnp.asarray(keep)))[:n])


def _table(rng, n):
    x = rng.integers(-10 ** 6, 10 ** 6, n)
    f = rng.standard_normal(n)
    s = np.array(["a", "bb", "c", None], object)[rng.integers(0, 4, n)]
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "f": pa.array(f, mask=rng.random(n) < 0.1),
        "s": pa.array(list(s), pa.string())})


def _host_rows(hb_dict):
    return {k: [repr(v) for v in vs] for k, vs in hb_dict.items()}


@pytest.mark.parametrize("n,p", [(1000, 0.3), (5000, 0.9), (700, 0.0)])
def test_compact_batch_matches_reference(n, p):
    from spark_rapids_tpu.columnar.device import to_host as jto_host
    from spark_rapids_tpu_torch.columnar.device import fetch_result_batch
    rng = np.random.default_rng(n)
    table = _table(rng, n)
    jdb = jto_device(JHostBatch.from_table(table))
    pdb = pto_device(from_arrow(table), device="cpu")
    keep = rng.random(jdb.capacity) < p
    keep[n:] = False
    jout = JF.compact_batch(jdb, jnp.asarray(keep))
    pout = PF.compact_batch(pdb, torch.from_numpy(keep))
    assert int(pout.num_rows) == int(jout.num_rows) == int(keep.sum())
    want = jto_host(jout, int(jout.num_rows)).rb.to_pydict()
    got = fetch_result_batch(pout).to_pydict()
    assert _host_rows(got) == _host_rows(want)
    synced = PF.compact_batch(pdb, torch.from_numpy(keep), sync=True)
    assert synced.num_rows == int(keep.sum())


@pytest.mark.parametrize("n", [2000, 100])
def test_compact_batch_launches_the_kernel_wrapper(monkeypatch, n):
    # at a capacity of 1024 rows and more; below the reference's 1024-row
    # cut, and with the family or the whole tier off, the argsort tier
    # compacts the same rows
    calls = []
    real = PC.compaction_order

    def spy(keep):
        calls.append(keep.numel())
        return real(keep)
    monkeypatch.setattr(PC, "compaction_order", spy)
    rng = np.random.default_rng(1)
    pdb = pto_device(from_arrow(_table(rng, n)), device="cpu")
    keep = torch.from_numpy(rng.random(pdb.capacity) < 0.5)
    keep[n:] = False
    out = PF.compact_batch(pdb, keep)
    launched = [pdb.capacity] if pdb.capacity >= 1024 else []
    assert calls == launched
    assert int(out.num_rows) == int(keep.sum())
    want = fetch_result_batch(out).to_pydict()
    for key, val in (("compact", "OFF"), ("enabled", "false")):
        off = TpuConf({f"spark.rapids.tpu.sql.kernels.pallas.{key}": val})
        got = PF.compact_batch(pdb, keep, off)
        assert _host_rows(fetch_result_batch(got).to_pydict()) == \
            _host_rows(want)
    assert calls == launched


@pytest.mark.parametrize("null_oob", [False, True])
def test_gather_batch_matches_reference(null_oob):
    from spark_rapids_tpu.columnar.device import to_host as jto_host
    from spark_rapids_tpu_torch.columnar.device import to_host as pto_host
    rng = np.random.default_rng(5 + null_oob)
    table = _table(rng, 900)
    jdb = jto_device(JHostBatch.from_table(table))
    pdb = pto_device(from_arrow(table), device="cpu")
    idx = rng.integers(-50, 1000, jdb.capacity).astype(np.int32)
    out_rows = 800
    jout = JF.gather_batch(jdb, jnp.asarray(idx), out_rows,
                           null_out_of_bounds=null_oob)
    pout = PF.gather_batch(pdb, torch.from_numpy(idx), out_rows,
                           null_out_of_bounds=null_oob)
    assert _host_rows(pto_host(pout, out_rows).to_pydict()) == \
        _host_rows(jto_host(jout, out_rows).rb.to_pydict())


def test_standalone_filter_compacts_like_reference():
    rng = np.random.default_rng(11)
    table = _table(rng, 3000)

    def build(e, c, s):
        return (s.from_arrow(table)
                .filter(e.GreaterThan(c("x"), e.Literal(0)))
                .filter(e.EqualTo(c("s"), e.Literal("bb")))
                .select(c("x"), c("f")))
    want = build(JE, jcol, JSession()).collect().to_pydict()
    cpu = JDF(build(JE, jcol, JSession())._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    got = build(PE, pcol, PSession(device="cpu")).to_pydict()
    assert _host_rows(got) == _host_rows(want) == _host_rows(cpu)
