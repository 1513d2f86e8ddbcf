"""The port's bloom runtime join filter (ops/bloom.py, the adaptive join's
probe-side stage) against the JAX package: the cases of
tests/test_bloom.py but its z-order one.

The filter's bitset is held bit for bit to the reference's (both hash
with the row hash `_agg_partition_ids`, bit-equal across the packages);
no build key is ever filtered out, most absent keys are; the adaptive
join installs the stage for inner, right outer and left semi joins
(`bloom_filter_slots`, `bloom_filtered_rows` in the query's metrics), not
when the conf turns it off, not for a left outer join and not for a
build whose key fits a dense span, and every query equals the reference
row for row and its CPU oracle once sorted.
"""
import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu.columnar.device import to_device as jto_device
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.ops import bloom as JB
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.columnar.device import to_device
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.ops import bloom as PB
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _dev(table):
    return to_device(from_arrow(pa.table(table)), device=CPU)


def _jdev(table):
    return jto_device(JHostBatch.from_table(pa.table(table)))


def test_sizing_matches_reference():
    m = PB.optimal_slots(10_000)
    assert m & (m - 1) == 0 and 1 << 10 <= m <= 1 << 22
    assert 1 <= PB.optimal_hashes(10_000, m) <= 6
    assert PB.optimal_slots(10 ** 9) == 1 << 22       # clamped
    for n in (0, 1, 999, 10_000, 123_456, 10 ** 7):
        for fpp in (0.01, 0.03, 0.2):
            assert PB.optimal_slots(n, fpp) == JB.optimal_slots(n, fpp)
            m = PB.optimal_slots(n, fpp)
            assert PB.optimal_hashes(n, m) == JB.optimal_hashes(n, m)


def test_no_false_negatives_and_some_filtering():
    rng = np.random.default_rng(6)
    build_keys = rng.choice(100_000, size=2000, replace=False)
    table = {"k": pa.array(build_keys, pa.int64())}
    bd = _dev(table)
    m = PB.optimal_slots(2000)
    k = PB.optimal_hashes(2000, m)
    bits = PB.bloom_build([bd.column_by_name("k")], bd, m, k)
    jbd = _jdev(table)
    jbits = JB.bloom_build([jbd.column_by_name("k")], jbd, m, k)
    assert np.array_equal(bits.numpy(), np.asarray(jbits))

    probe_keys = rng.integers(0, 100_000, 20_000)
    pd_ = _dev({"k": pa.array(probe_keys, pa.int64())})
    mask = PB.bloom_might_contain(bits, [pd_.column_by_name("k")], pd_,
                                  k).numpy()
    live = pd_.row_mask().numpy()
    got = mask[live][:len(probe_keys)]
    in_build = np.isin(probe_keys, build_keys)
    assert got[in_build].all()
    assert 1 - got[~in_build].mean() > 0.8


def test_accumulate_over_batches_and_mask_insertion():
    b1 = _dev({"k": pa.array(range(0, 500), pa.int64())})
    b2 = _dev({"k": pa.array(range(500, 1000), pa.int64())})
    m = PB.optimal_slots(1000)
    k = PB.optimal_hashes(1000, m)
    bits = PB.bloom_build([b1.column_by_name("k")], b1, m, k)
    bits = PB.bloom_build([b2.column_by_name("k")], b2, m, k, bits)
    probe = _dev({"k": pa.array(range(0, 1000), pa.int64())})
    mask = PB.bloom_might_contain(bits, [probe.column_by_name("k")], probe,
                                  k)
    assert bool(mask[:1000].all())
    # rows masked out of the insertion set no bit
    none = PB.bloom_build([b1.column_by_name("k")], b1, m, k,
                          live=torch.zeros(b1.capacity, dtype=torch.bool))
    assert not bool(none.any())


def _join_tables(n_small=200, n_big=50_000, key_span=1 << 40):
    # a key span too wide for a dense table keeps the filter worthwhile;
    # about 10 % of the big side's rows reuse small-side keys
    rng = np.random.default_rng(8)
    sk = rng.choice(key_span, n_small, replace=False)
    bk = rng.integers(0, key_span, n_big)
    hits = rng.random(n_big) < 0.1
    bk[hits] = rng.choice(sk, hits.sum())
    return (pa.table({"sk": pa.array(sk, pa.int64()),
                      "sv": pa.array(rng.standard_normal(n_small))}),
            pa.table({"bk": pa.array(bk, pa.int64()),
                      "bv": pa.array(rng.integers(0, 99, n_big),
                                     pa.int64())}))


def _rows(d):
    return {k: [repr(v) for v in vs] for k, vs in d.items()}


def _check(build, conf=None):
    """The port's rows (equal to the reference's, and to its oracle's
    once sorted) and its query metrics."""
    conf = conf or {}
    want = _rows(build(JE, jcol, JSession(conf)).collect().to_pydict())
    cpu = _rows(JDF(build(JE, jcol, JSession(conf))._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict())
    q = build(PE, pcol, PSession(conf, device="cpu")).physical()
    ctx = PCtx(q.conf, q.device)
    got = _rows(q.collect(ctx).to_pydict())
    assert got == want
    assert sorted(zip(*got.values())) == sorted(zip(*cpu.values()))
    return got, ctx.metrics


def _join(small, big, how="inner", keys=(["bk"], ["sk"])):
    def build(e, c, s):
        return s.from_arrow(big).join(s.from_arrow(small), how=how,
                                      left_on=keys[0], right_on=keys[1])
    return build


def test_adaptive_join_applies_bloom_and_matches_reference():
    small, big = _join_tables()
    got, m = _check(_join(small, big))
    assert m.get("bloom_filter_slots", 0) > 0
    assert m.get("bloom_filtered_rows", 0) > 40_000
    assert isinstance(m["bloom_filtered_rows"], int)
    # a fused build-side filter masks the insertion: fewer build keys
    # let more probe rows go
    def filtered(e, c, s):
        return s.from_arrow(big).join(
            s.from_arrow(small).filter(e.GreaterThan(c("sv"), e.Literal(0.0))),
            left_on=["bk"], right_on=["sk"])
    _got, m2 = _check(filtered)
    assert m2["bloom_filtered_rows"] > m["bloom_filtered_rows"]


def test_bloom_disabled_by_conf():
    small, big = _join_tables(100, 20_000)
    _got, m = _check(_join(small, big), {
        "spark.rapids.tpu.sql.join.runtimeFilter.enabled": "false"})
    assert "bloom_filter_slots" not in m


def test_left_outer_never_bloom_filtered():
    small, big = _join_tables(100, 20_000)
    got, m = _check(_join(small, big, "left_outer"))
    assert len(got["bk"]) == 20_000
    assert "bloom_filter_slots" not in m


def test_string_keys_bloom():
    rng = np.random.default_rng(10)
    small = pa.table({"sk": pa.array([f"id{i}" for i in range(150)])})
    big = pa.table({"bk": pa.array(
        [f"id{i}" for i in rng.integers(0, 5000, 30_000)])})
    got, m = _check(_join(small, big))
    assert m.get("bloom_filtered_rows", 0) > 0 and len(got["bk"]) > 0


def test_semi_join_and_right_outer_bloom_filter_probe():
    small, big = _join_tables(150, 40_000)
    for how in ("left_semi", "right_outer"):
        got, m = _check(_join(small, big, how))
        assert m.get("bloom_filtered_rows", 0) > 0, how


def test_composite_key_bloom():
    small, big = _join_tables(150, 30_000)
    small = small.append_column("t", pa.array(np.arange(150) % 3,
                                              pa.int64()))
    big = big.append_column("u", pa.array(np.arange(30_000) % 3,
                                          pa.int64()))
    got, m = _check(_join(small, big, keys=(["bk", "u"], ["sk", "t"])))
    assert m.get("bloom_filtered_rows", 0) > 0 and len(got["bk"]) > 0


def test_bloom_skipped_for_dense_domain_join():
    small, big = _join_tables(key_span=1_000_000)   # dense-eligible
    _got, m = _check(_join(small, big))
    assert "bloom_filter_slots" not in m
    # the port's denseReplace ON gives the join the hash table; OFF
    # keeps the dense tier (AUTO too, below 4x the build capacity: this
    # span of a million keys is past it)
    assert m.get("join_pallas_hash", 0) >= 1
    dense = {"spark.rapids.tpu.sql.kernels.pallas.join.denseReplace": "OFF"}
    _got, m = _check(_join(small, big), dense)
    assert "bloom_filter_slots" not in m
    assert m.get("join_dense_domain", 0) >= 1
