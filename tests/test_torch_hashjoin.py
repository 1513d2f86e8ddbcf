"""The port's hash-table join kernels against the reference Pallas ones.

The same numpy inputs go through spark_rapids_tpu.ops.pallas.hashjoin
(interpret mode, as the JAX package's own tests run it on the CPU) and
through the port's wrappers on CPU tensors, which run the kernels'
plain PyTorch versions: `mix64` bit for bit, `build_table`'s geometry
and row lane exactly and its key lane where a slot holds a row (and
the whole slot buffer, dead rows' keys and empty slots included, in
sparse, pushed-run, all-dead and odd-capacity builds), `probe_first`,
`probe_matched`, `probe_counts` (first slot, run length and int32
prefix sum), `expand_pairs` (probe row, build row and liveness of every
output slot) and `build_matched_flags` exactly, and the port's table
holds the reference's two arrays interleaved in one slot buffer.  The
CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops.pallas import hashjoin as HK
from spark_rapids_tpu_torch.ops.hopper import hashjoin as PH

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

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
def test_table_slots_interleave_the_reference_keys_and_rows(cap, kind, dead):
    rng = np.random.default_rng(cap + len(kind))
    lane = _keys(rng, kind, cap)
    valid = rng.random(cap) >= dead
    jt, pt = _tables(lane, valid)
    slots = pt.slots
    assert slots.dtype == torch.int64 and slots.is_contiguous()
    assert tuple(slots.shape) == (pt.span, 2)
    # one 16-byte slot: key, row, zero
    words = slots.view(torch.int32).numpy()
    rows = np.asarray(jt.rows)
    np.testing.assert_array_equal(words[:, 2], rows)
    assert not words[:, 3].any()
    live = rows >= 0
    np.testing.assert_array_equal(slots[:, 0].numpy()[live],
                                  np.asarray(jt.keys)[live])
    # keys and rows are views of the buffer, not copies
    assert pt.keys.data_ptr() == slots.data_ptr()
    assert pt.rows.data_ptr() == slots.data_ptr() + 8
    np.testing.assert_array_equal(pt.rows.numpy(), rows)


def _layout_case(kind, cap, rng):
    """(build lane, valid) of one whole-buffer layout case."""
    lane = rng.permutation(cap * 4)[:cap].astype(np.int64) - cap
    if kind == "sparse":
        return lane, rng.random(cap) < 0.01
    if kind == "all dead":
        return lane, np.zeros(cap, bool)
    if kind == "pushed":
        # 1,200 rows of six keys homed at the last two of 2^12 slots: they
        # sort last, at rows 848-2047 (across row 1,024), and their run
        # fills slots 4,094-5,293 (across slot 4,096 = 2 x 2,048)
        hot = _pushed_keys((2 * cap - 1).bit_length())
        assert len(hot) == 6
        lane[cap - 1200:] = np.repeat(hot, 200)
        return lane, np.ones(cap, bool)
    return lane, rng.random(cap) >= 0.2


LAYOUT_CASES = [("sparse", 8192), ("pushed", 2048), ("all dead", 5000),
                ("odd capacity", 3001)]


@pytest.mark.parametrize("kind,cap", LAYOUT_CASES)
def test_build_table_whole_slot_buffer_matches_reference(kind, cap):
    lane, valid = _layout_case(kind, cap, np.random.default_rng(cap))
    jt, pt = _tables(lane, valid)
    assert (pt.nbits, pt.span) == (jt.nbits, jt.span)
    # every slot: live, dead (key with row -1) and empty (0, -1)
    np.testing.assert_array_equal(pt.rows.numpy(), np.asarray(jt.rows))
    np.testing.assert_array_equal(pt.keys.numpy(), np.asarray(jt.keys))
    assert not pt.slots.view(torch.int32)[:, 3].any()
    assert int((pt.rows >= 0).sum()) == int(valid.sum())
    if kind == "pushed":
        rows = pt.rows.numpy()
        run = np.flatnonzero(np.isin(pt.keys.numpy(), lane[-1200:]) &
                             (rows >= 0))
        assert run[0] < 4096 <= run[-1] and np.all(np.diff(run) == 1)


def test_plain_layout_keeps_the_last_row_of_clipped_finals():
    # hand-built: rows 0-2 clip to slot 0 and rows 4-5 to the last slot;
    # the last row of each stack keeps it (the kernel does the same)
    ideal = torch.tensor([-5, -5, 0, 1, 100, 100], dtype=torch.int32)
    lane = torch.tensor([10, 11, 12, 13, 14, 15], dtype=torch.int64)
    rid = torch.arange(6, dtype=torch.int32)
    for _ in range(3):
        keys, rows = PH.slot_views(PH.build_layout_plain(ideal, lane, rid, 8))
        assert rows.tolist() == [2, 3, -1, -1, -1, -1, -1, 5]
        assert keys.tolist() == [12, 13, 0, 0, 0, 0, 0, 15]


def test_hash_table_constructor_interleaves_two_arrays():
    rng = np.random.default_rng(8)
    span = 37
    keys = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, span,
                                         endpoint=True))
    keys[:len(INT64_EDGES)] = torch.tensor(INT64_EDGES)
    rows = torch.from_numpy(rng.integers(-1, 1000, span).astype(np.int32))
    rows[:2] = torch.tensor([2 ** 31 - 1, -1], dtype=torch.int32)
    table = PH.HashTable(keys, rows, 4, span)
    assert torch.equal(table.keys, keys) and torch.equal(table.rows, rows)
    assert (table.nbits, table.span) == (4, span)
    assert not table.slots.view(torch.int32)[:, 3].any()
    again = PH.HashTable.of_slots(table.slots, 4, span)
    assert again.slots is table.slots
    assert torch.equal(again.keys, keys) and torch.equal(again.rows, rows)
    # an empty buffer: key 0 and row -1 in every slot
    k, r = PH.slot_views(PH.empty_slots(5, "cpu"))
    assert not k.any() and bool((r == -1).all())


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


def _pushed_keys(nbits, want=6, seed=5):
    """Distinct keys whose home slot is among the last two of 2^nbits, so
    their runs spill into the overflow tail."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, 1 << 16))
    home = PH._shr(PH.mix64(x), 64 - nbits)
    return x[home >= (1 << nbits) - 2][:want].numpy()


def _counts_case(kind, cap, pcap, rng):
    """(build lane, build valid, probe lane, probe valid) of one case."""
    if kind == "pushed":
        nbits = max(4, (2 * cap - 1).bit_length())
        hot = _pushed_keys(nbits)
        lane = np.resize(np.repeat(hot, 40), cap)
        probe = rng.choice(np.concatenate([hot, np.arange(50)]), pcap)
        return lane, np.ones(cap, bool), probe, rng.random(pcap) > 0.1
    lane = _keys(rng, "duplicates" if kind.startswith("dead") else kind, cap)
    valid = rng.random(cap) >= (1.0 if kind == "dead" else 0.1)
    probe = np.concatenate([rng.choice(lane, pcap // 2),
                            _keys(rng, "edges" if kind == "edges" else
                                  "unique", pcap - pcap // 2)])
    pvalid = rng.random(pcap) >= (1.0 if kind == "dead_probe" else 0.15)
    return lane, valid, probe, pvalid


COUNT_CASES = [("duplicates", 1024, 1000), ("unique", 2048, 1536),
               ("edges", 1024, 3000), ("pushed", 1024, 777),
               ("dead", 1024, 1024), ("dead_probe", 1536, 1024)]


@pytest.mark.parametrize("kind,cap,pcap", COUNT_CASES)
def test_probe_counts_expand_and_matched_flags_match_reference(kind, cap,
                                                               pcap):
    rng = np.random.default_rng(cap + pcap + len(kind))
    lane, valid, probe, pvalid = _counts_case(kind, cap, pcap, rng)
    jt, pt = _tables(lane, valid)
    jfirst, jcounts, jcum = HK.probe_counts(jt, jnp.asarray(probe),
                                            jnp.asarray(pvalid))
    first, counts, cum = PH.probe_counts(pt, torch.from_numpy(probe),
                                         torch.from_numpy(pvalid))
    assert first.dtype == counts.dtype == cum.dtype == torch.int32
    for got, want in ((first, jfirst), (counts, jcounts), (cum, jcum)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the counts are the true match counts
    want_counts = [int(np.sum(valid & (lane == k))) if v else 0
                   for k, v in zip(probe, pvalid)]
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    total = int(cum[-1])
    for out_cap in sorted({max(total, 1), total + 333}):
        jp, jb, jok = HK.expand_pairs(jt, jfirst, jcounts, jcum, out_cap,
                                      total)
        pp, pb, pok = PH.expand_pairs(pt, first, counts, cum, out_cap, total)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    # probe-major pairs, build rows ascending within a key
    want_pairs = [(p, b) for p in range(pcap) if pvalid[p]
                  for b in np.flatnonzero(valid & (lane == probe[p]))]
    assert list(zip(pp.numpy()[:total].tolist(),
                    pb.numpy()[:total].tolist())) == want_pairs
    np.testing.assert_array_equal(
        PH.build_matched_flags(pt, first, counts, cap).numpy(),
        np.asarray(HK.build_matched_flags(jt, jfirst, jcounts, cap)))


def test_expand_pairs_with_total_zero_gives_dead_slots():
    rng = np.random.default_rng(4)
    lane = rng.integers(0, 40, 1024)
    jt, pt = _tables(lane, np.ones(1024, bool))
    probe = rng.integers(100, 200, 1000)                   # all miss
    pvalid = np.ones(1000, bool)
    jfirst, jcounts, jcum = HK.probe_counts(jt, jnp.asarray(probe),
                                            jnp.asarray(pvalid))
    first, counts, cum = PH.probe_counts(pt, torch.from_numpy(probe),
                                         torch.from_numpy(pvalid))
    assert int(cum[-1]) == 0
    jp, jb, jok = HK.expand_pairs(jt, jfirst, jcounts, jcum, 1024, 0)
    got = PH.expand_pairs(pt, first, counts, cum, 1024, 0)
    for g, w in zip(got, (jp, jb, jok)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2].any() and not got[0].any() and not got[1].any()
    assert not PH.build_matched_flags(pt, first, counts, 1024).any()


def test_plain_counted_probe_reproduces_the_clamped_last_slot():
    # a hand-made table whose last slot holds the key: the reference
    # clamps its walk there and re-reads the slot until span steps are
    # spent, counting each re-read hit
    nbits, span = 4, 20
    key = int(_pushed_keys(nbits, want=1)[0])
    home = int(PH._shr(PH.mix64(torch.tensor([key])), 64 - nbits)[0])
    keys = torch.zeros(span, dtype=torch.int64)
    rows = torch.full((span,), -1, dtype=torch.int32)
    keys[home:] = key
    rows[home:] = torch.arange(span - home, dtype=torch.int32)
    jt = HK.HashTable(jnp.asarray(keys.numpy()), jnp.asarray(rows.numpy()),
                      nbits, span, True)
    pt = PH.HashTable(keys, rows, nbits, span)
    probe = np.array([key, key + 1], np.int64)
    pvalid = np.ones(2, bool)
    want = HK.probe_counts(jt, jnp.asarray(probe), jnp.asarray(pvalid))
    got = PH.probe_counts(pt, torch.from_numpy(probe),
                          torch.from_numpy(pvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][0]) == span     # one count per step, as the reference


def test_cpu_counted_probe_and_expansion_count_no_launch():
    from spark_rapids_tpu_torch.ops import hopper as H
    H.reset_launch_counts()
    lane = torch.arange(1024, dtype=torch.int64) % 7
    valid = torch.ones(1024, dtype=torch.bool)
    table = PH.build_table(lane, valid)
    first, counts, cum = PH.probe_counts(table, lane, valid)
    PH.expand_pairs(table, first, counts, cum, int(cum[-1]), int(cum[-1]))
    assert H.LAUNCHES["probe_counts"] == H.LAUNCHES["expand_pairs"] == 0
