"""The port's hash-table join kernels against the reference Pallas ones.

The same numpy inputs go through spark_rapids_tpu.ops.pallas.hashjoin
(interpret mode, as the JAX package's own tests run it on the CPU) and
through the port's wrappers on CPU tensors, which run the kernels'
plain PyTorch versions: `mix64` bit for bit, `build_table`'s geometry
and row lane exactly and its key lane where a slot holds a row (dead
rows leave keys in the overflow tail in the reference), `probe_first`
and `probe_matched` exactly.  The CUDA kernels are held against the
same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops.pallas import hashjoin as HK
from spark_rapids_tpu_torch.ops.hopper import hashjoin as PH

INT64_EDGES = [2 ** 63 - 1, -2 ** 63, -2 ** 63 + 1, 2 ** 63 - 2, -1, 0, 1]


def test_mix64_matches_reference_near_the_int64_edges():
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 63, 2 ** 63 - 1, 4096, endpoint=True)
    x[:len(INT64_EDGES)] = INT64_EDGES
    x[100:200] = -rng.integers(1, 1000, 100)               # negative keys
    want = np.asarray(HK.mix64(jnp.asarray(x))).view(np.int64)
    np.testing.assert_array_equal(PH.mix64(torch.from_numpy(x)).numpy(),
                                  want)


def _keys(rng, kind, cap):
    if kind == "unique":
        return rng.permutation(cap * 4)[:cap].astype(np.int64) - cap
    if kind == "duplicates":
        return rng.integers(0, 17, cap)
    if kind == "edges":
        x = rng.integers(-2 ** 63, 2 ** 63 - 1, cap, endpoint=True)
        x[:len(INT64_EDGES)] = INT64_EDGES
        return x
    raise ValueError(kind)


def _tables(lane, valid):
    jt = HK.build_table(jnp.asarray(lane), jnp.asarray(valid), True)
    pt = PH.build_table(torch.from_numpy(lane), torch.from_numpy(valid))
    return jt, pt


CASES = [(1024, "unique", 0.1), (1024, "duplicates", 0.2),
         (2048, "edges", 0.0), (1024, "unique", 1.0),
         (4096, "duplicates", 0.0), (1536, "unique", 0.3)]


@pytest.mark.parametrize("cap,kind,dead", CASES)
def test_build_table_matches_reference(cap, kind, dead):
    rng = np.random.default_rng(cap + len(kind))
    lane = _keys(rng, kind, cap)
    valid = rng.random(cap) >= dead
    jt, pt = _tables(lane, valid)
    assert (pt.nbits, pt.span) == (jt.nbits, jt.span)
    rows = np.asarray(jt.rows)
    np.testing.assert_array_equal(pt.rows.numpy(), rows)
    live = rows >= 0
    np.testing.assert_array_equal(pt.keys.numpy()[live],
                                  np.asarray(jt.keys)[live])
    # equal keys sit in consecutive slots in ascending build-row order
    for key in np.unique(lane[valid])[:20]:
        slots = np.flatnonzero(live & (pt.keys.numpy() == key))
        assert np.all(np.diff(slots) == 1)
        assert np.all(np.diff(pt.rows.numpy()[slots]) > 0)


@pytest.mark.parametrize("cap,kind,dead", CASES)
def test_probe_first_and_matched_match_reference(cap, kind, dead):
    rng = np.random.default_rng(cap * 7 + len(kind))
    lane = _keys(rng, kind, cap)
    valid = rng.random(cap) >= dead
    jt, pt = _tables(lane, valid)
    probe = np.concatenate([rng.permutation(lane)[:cap // 2],
                            _keys(rng, kind, cap - cap // 2)])
    pvalid = rng.random(cap) > 0.15                        # null probe keys
    jrow, jok = HK.probe_first(jt, jnp.asarray(probe), jnp.asarray(pvalid))
    prow, pok = PH.probe_first(pt, torch.from_numpy(probe),
                               torch.from_numpy(pvalid))
    np.testing.assert_array_equal(prow.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(
        PH.probe_matched(pt, torch.from_numpy(probe),
                         torch.from_numpy(pvalid)).numpy(),
        np.asarray(HK.probe_matched(jt, jnp.asarray(probe),
                                    jnp.asarray(pvalid))))
    # the first matching build row, or -1
    first = {}
    for r in np.flatnonzero(valid):
        first.setdefault(lane[r], r)
    want = [first.get(k, -1) if v else -1 for k, v in zip(probe, pvalid)]
    np.testing.assert_array_equal(prow.numpy(), want)


def test_empty_build_matches_nothing():
    cap = 1024
    lane = np.arange(cap, dtype=np.int64)
    jt, pt = _tables(lane, np.zeros(cap, bool))
    probe = np.arange(cap, dtype=np.int64)
    pvalid = np.ones(cap, bool)
    row, ok = PH.probe_first(pt, torch.from_numpy(probe),
                             torch.from_numpy(pvalid))
    assert not ok.any() and bool((row == -1).all())
    jrow, _ = HK.probe_first(jt, jnp.asarray(probe), jnp.asarray(pvalid))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))


def test_table_geometry_and_hash_order_follow_the_reference():
    for cap in (1, 8, 1000, 1024, 4097):
        nbits, span = PH.table_geometry(cap)
        assert nbits == max(4, (2 * max(cap, 1) - 1).bit_length())
        assert span == (1 << nbits) + cap
    rng = np.random.default_rng(9)
    lane = torch.from_numpy(rng.integers(-50, 50, 512))
    valid = torch.from_numpy(rng.random(512) > 0.3)
    ideal, lane_s, rid = PH.hash_order(lane, valid, 10)
    live = rid >= 0
    # live rows first, in ascending unsigned-hash order, then dead rows
    assert int(live.sum()) == int(valid.sum())
    assert bool(live[:int(live.sum())].all())
    assert bool((ideal[~live] == 1 << 10).all())
    assert torch.equal(lane_s[live], lane[rid[live].long()])
    assert bool((ideal[live][1:] >= ideal[live][:-1]).all())


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    from spark_rapids_tpu_torch.ops import hopper as H
    H.reset_launch_counts()
    lane = torch.arange(1024, dtype=torch.int64)
    table = PH.build_table(lane, torch.ones(1024, dtype=torch.bool))
    PH.probe_first(table, lane, torch.ones(1024, dtype=torch.bool))
    assert H.LAUNCHES["build_table"] == H.LAUNCHES["probe_first"] == 0
