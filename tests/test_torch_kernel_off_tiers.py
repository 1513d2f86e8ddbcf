"""The portable tiers a shed kernel falls back to: the argsort compaction
(ops/filter.compaction_order) and the sorted join tier for single-lane
keys (ops/join.py), against the JAX package with its own families OFF
(its sorted tier, Pallas in interpret mode), on CPU tensors.

Every join type over NaN, ±0.0 and null keys and duplicate builds, row
for row in the engines' own order (probe-major, build rows ascending
within a key); TPC-H q3, q5 and the three join-path queries at 0.001
with each family off; and the 1024-row floor of the compaction kernel's
election.
"""
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.ops import filter as JF
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.columnar.device import DeviceColumn
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.ops import filter as PF
from spark_rapids_tpu_torch.ops import join as PJ
from spark_rapids_tpu_torch.ops.hopper import (COMPACT_MIN_CAPACITY,
                                               elect_compact, kernel_tier)
from spark_rapids_tpu_torch.session import TpuSession as PSession

from test_torch_tpch import _join_query, _unscaled

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

PALLAS = "spark.rapids.tpu.sql.kernels.pallas"
#: the reference with its kernel tier on (interpret mode on the CPU) and
#: one family off; the port with the same family off
OFF = {fam: {f"{PALLAS}.enabled": "true", f"{PALLAS}.segagg": "ON",
             f"{PALLAS}.{fam}": "OFF"} for fam in ("join", "compact")}


def _port(conf):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return PSession(conf, device="cpu")


# ---------------------------------------------------------------------------
# the argsort compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,p", [(100, 0.3), (1023, 0.5), (1024, 0.0),
                                   (5000, 0.9), (4096, 1.0)])
def test_argsort_compaction_matches_the_reference(cap, p):
    rng = np.random.default_rng(cap)
    keep = rng.random(cap) < p
    order, count = PF.compaction_order(torch.from_numpy(keep))
    want = np.asarray(JF.compaction_order(np.asarray(keep)))
    np.testing.assert_array_equal(order.numpy(), want)
    assert int(count) == int(keep.sum())


def test_compaction_kernel_floor_is_1024_rows():
    conf = TpuConf()
    assert COMPACT_MIN_CAPACITY == 1024
    assert elect_compact(conf, 1023) is None
    assert elect_compact(conf, 1024) is kernel_tier(conf)
    off = TpuConf({f"{PALLAS}.compact": "OFF"})
    assert elect_compact(off, 1 << 20) is None


def test_small_batches_compact_by_argsort(monkeypatch):
    """A batch under 1024 rows of capacity compacts by argsort, as the
    reference's does: nation's 25 rows under a 256-row bucket floor.  At
    the default floor (sql.shape.minBucketRows 1024) every batch has
    1024 rows of capacity or more, so the kernel compacts them all."""
    from spark_rapids_tpu_torch.ops.hopper import compact as PC
    t = PTPCH.gen_tables(0.001, tables=("nation", "lineitem"))
    calls = []
    real = PC.compaction_order

    def spy(keep):
        calls.append(keep.numel())
        return real(keep)
    monkeypatch.setattr(PC, "compaction_order", spy)
    from spark_rapids_tpu_torch.plan import expressions as PE
    from spark_rapids_tpu_torch.session import col as pcol

    def five(s):
        return s.from_host(t["nation"]).filter(
            PE.LessThan(pcol("n_nationkey"), PE.Literal(5))).to_pydict()
    small = PSession({"spark.rapids.tpu.sql.shape.minBucketRows": 256},
                     device="cpu")
    nat = five(small)
    assert nat["n_nationkey"] == [0, 1, 2, 3, 4] and calls == []
    assert five(PSession(device="cpu")) == nat and calls == [1024]
    small.from_host(t["lineitem"]).filter(
        PE.LessThan(pcol("l_quantity"), PE.Literal(10))).to_pydict()
    assert min(calls) >= 1024


# ---------------------------------------------------------------------------
# the sorted join tier
# ---------------------------------------------------------------------------

HOWS = ["inner", "left_outer", "right_outer", "full_outer", "left_semi",
        "left_anti"]


def _edge_tables(kind):
    """Probe and build sides whose keys carry NaN, ±0.0, nulls and
    duplicates (several build rows a key)."""
    rng = np.random.default_rng(7)
    if kind == "double":
        vals = np.array([0.0, -0.0, np.nan, 1.5, -2.25, 7.0, 3.0, np.inf])
    else:
        vals = np.array([0, 1, -5, 7, 3, 2 ** 40, -(2 ** 62), 11])
    n, m = 900, 120
    pk = vals[rng.integers(0, len(vals), n)]
    bk = vals[rng.integers(0, len(vals) - 1, m)]
    typ = pa.float64() if kind == "double" else pa.int64()
    probe = pa.table({"pk": pa.array(pk, typ, mask=rng.random(n) < 0.1),
                      "x": pa.array(np.arange(n), pa.int64())})
    build = pa.table({"bk": pa.array(bk, typ, mask=rng.random(m) < 0.1),
                      "y": pa.array(np.arange(m), pa.int64())})
    return probe, build


def _rows(d):
    return {k: [repr(v) for v in vs] for k, vs in d.items()}


@pytest.mark.parametrize("kind", ["double", "long"])
@pytest.mark.parametrize("how", HOWS)
def test_sorted_join_equals_reference_with_join_off(kind, how):
    probe, build = _edge_tables(kind)
    conf = {**OFF["join"], "spark.rapids.tpu.sql.adaptive.enabled": "false"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JSession(conf)
        want = js.from_arrow(probe).join(
            js.from_arrow(build), left_on=["pk"], right_on=["bk"],
            how=how).collect().to_pydict()
    ps = _port(conf)
    got = ps.from_arrow(probe).join(ps.from_arrow(build), left_on=["pk"],
                                    right_on=["bk"], how=how).to_pydict()
    assert _rows(got) == _rows(want)
    assert len(got["pk"]) > 0
    # and the hash-table tier gives the same rows in the same order
    hs = _port({"spark.rapids.tpu.sql.adaptive.enabled": "false"})
    hashed = hs.from_arrow(probe).join(hs.from_arrow(build), left_on=["pk"],
                                       right_on=["bk"], how=how).to_pydict()
    assert _rows(got) == _rows(hashed)


def test_sorted_tier_pairs_are_probe_major_and_verified():
    """The sorted tier's pairs at the ops level: probe-major, build rows
    ascending within a key, null and dead keys matching nothing, the same
    pairs as the hash table's."""
    rng = np.random.default_rng(11)
    bk = torch.from_numpy(rng.integers(0, 6, 40))
    bvalid = torch.from_numpy(rng.random(40) < 0.85)
    pk = torch.from_numpy(rng.integers(0, 8, 64))
    pvalid = torch.from_numpy(rng.random(64) < 0.9)
    col = DeviceColumn(bk, bvalid, None, None)

    def pairs(tier):
        from spark_rapids_tpu_torch.columnar.device import DeviceBatch
        bt = PJ.BuildTable(DeviceBatch([col], 40, ["k"]), [col],
                           hash_tier=tier)
        first, counts, cum, total = PJ.probe_counts(bt, [pk], pvalid)
        p, b, ok, pm = PJ.expand_pairs(bt, [pk], pvalid, first, counts, cum,
                                       512, total)
        flags = PJ.build_matched(bt, first, counts)
        lazy = PJ.probe_matched_lazy(bt, [pk], pvalid)
        return (list(zip(p[ok].tolist(), b[ok].tolist())), pm.tolist(),
                flags.tolist(), lazy.tolist(), total)
    sorted_tier = pairs(None)
    hashed = pairs(kernel_tier(TpuConf()))
    assert sorted_tier == hashed
    got = sorted_tier[0]
    want = [(i, j) for i in range(64) for j in range(40)
            if pvalid[i] and bvalid[j] and pk[i] == bk[j]]
    assert got == want
    # a unique build: the aligned probe
    uk = torch.from_numpy(rng.permutation(50))
    ucol = DeviceColumn(uk, torch.ones(50, dtype=torch.bool), None, None)
    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    ub = PJ.BuildTable(DeviceBatch([ucol], 50, ["k"]), [ucol])
    idx, ok = PJ.probe_aligned(ub, [pk], pvalid)
    assert ok.tolist() == pvalid.tolist()
    assert (uk[idx.long()][ok] == pk[ok]).all()


@pytest.fixture(scope="module")
def tables():
    return JTPCH.gen_tables(0.001), PTPCH.gen_tables(0.001)


def _reference_q(name, jconf, jt):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JSession(jconf)
        if name in ("m2m", "outer", "semi"):
            df = _join_query(name, JA, JE, JT, jcol, js, jt)
        else:
            df = JTPCH.QUERIES[name](js, jt)
        return df.collect().to_pydict()


@pytest.mark.parametrize("family", ["join", "compact"])
@pytest.mark.parametrize("name", ["q3", "q5", "m2m", "outer", "semi"])
def test_tpch_with_a_family_off_equals_reference(tables, name, family):
    jt, pt = tables
    conf = OFF[family]
    want = _reference_q(name, conf, jt)
    q = (PTPCH.JOIN_QUERIES.get(name) or PTPCH.QUERIES[name])
    got = q(_port(conf), pt).to_pydict()
    assert list(got) == list(want)
    assert _unscaled(got) == _unscaled(want)
    assert len(next(iter(got.values()))) > 0
