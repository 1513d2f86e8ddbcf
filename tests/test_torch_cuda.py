"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: without an NVIDIA GPU every test here skips.  The
file imports neither jax nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import hopper as PH
from spark_rapids_tpu_torch.ops.hopper import compact as PC
from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
from spark_rapids_tpu_torch.ops.hopper import segagg as PS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _seg(rng, cap, domain, dist="uniform"):
    """Bucket ids: uniform; "one" bucket for every live row; "q1", TPC-H
    q1's skew (about half the rows in one of four occupied buckets);
    "dead", every row dead."""
    if dist == "one":
        seg = np.full(cap, domain // 2, np.int32)
    elif dist == "q1":
        occupied = np.arange(4) * max(domain // 4, 1) % domain
        seg = rng.choice(occupied, cap, p=[0.25, 0.0026, 0.4974, 0.25]) \
            .astype(np.int32)
    else:
        seg = rng.integers(0, domain, cap).astype(np.int32)
    seg[rng.random(cap) < (1.0 if dist == "dead" else 0.1)] = domain
    return seg


def _lane(rng, dtype, cap):
    if dtype == "float64":
        x = rng.standard_normal(cap)
        x[::13], x[5::13], x[7::29], x[11::31] = 0.0, -0.0, np.inf, -np.inf
        return x
    if dtype == "bool":
        return rng.random(cap) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, cap, dtype=dtype, endpoint=True)


def _bits(a):
    return a.view(np.int64) if a.dtype == np.float64 else a


# (cap, domain, int lanes, f64 lanes, bucket distribution, calls, lane
# tiles a call): two calls run back to back on one stream at cap and
# cap // 3 (the tickets must come back to zero between them).  A tile is
# as many lanes as 200 KB of shared memory holds at the domain, at most
# 64: D = 1024 takes 25 lanes a launch, D = 6144 four.
_SUMS_CASES = [
    (1 << 16, 1, 9, 2, "uniform", 1, 1),
    (1 << 16, 12, 9, 2, "uniform", 1, 1),
    (1 << 16, 1024, 9, 2, "uniform", 1, 1),
    (1 << 16, 12, 19, 1, "one", 1, 1), (1 << 20, 12, 19, 1, "q1", 1, 1),
    (1, 12, 9, 2, "uniform", 1, 1), (31, 12, 9, 2, "uniform", 1, 1),
    (3_000_017, 12, 19, 1, "q1", 1, 1), (1 << 16, 12, 9, 2, "dead", 1, 1),
    (1 << 20, 1024, 19, 1, "q1", 1, 1),
    (1 << 16, 6144, 9, 2, "uniform", 1, 3),
    (1 << 20, 12, 19, 1, "q1", 2, 1),
    (1 << 16, 1024, 19, 1, "uniform", 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,domain,ki,kf,dist,calls,tiles", _SUMS_CASES)
def test_seg_sums_kernel_matches_plain(cuda, cap, domain, ki, kf, dist,
                                       calls, tiles):
    rng = np.random.default_rng(domain + cap)
    caps = [cap, max(cap // 3, 1)][:calls]
    segs = [torch.from_numpy(_seg(rng, c, domain, dist)).to(cuda)
            for c in caps]
    ints = [torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, cap)).to(cuda)
            for _ in range(ki)]
    ints[0][:99] = 2 ** 63 - 1                   # int64 wraparound
    f64s = [torch.from_numpy(rng.random(cap)).to(cuda) for _ in range(kf)]
    PH.reset_launch_counts()
    got = [PS.seg_sums(sg, [x[:sg.numel()] for x in ints],
                       [x[:sg.numel()] for x in f64s], domain)
           for sg in segs]
    # one launch per tile of lanes whose shared accumulator fits
    assert PH.LAUNCHES["seg_sums"] == calls * tiles
    for sg, (ci, cf) in zip(segs, got):
        pi, pf = PS.seg_sums_plain(sg, [x[:sg.numel()] for x in ints],
                                   [x[:sg.numel()] for x in f64s], domain)
        assert ci.shape == (domain, ki) and cf.shape == (domain, kf)
        assert torch.equal(ci, pi)
        assert torch.allclose(cf, pf, rtol=1e-12, atol=0)


# "<lane dtype>" uniform at capacity 2^16, or "<dtype>-<case>": a bucket
# distribution, an odd capacity, or "twice" (two calls back to back on
# one stream at capacities 2^16 and 3,001)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [
    "int32", "int64", "float64", "int8", "bool", "int16", "int64-one",
    "float64-one", "int32-q1", "int64-q1", "float64-q1", "int8-q1",
    "int64-dead", "bool-dead", "int64-cap1", "int32-cap31",
    "float64-cap3000017", "int16-cap3000017", "int64-twice",
    "float64-twice", "int64-domain1024", "int32-domain6144"])
def test_seg_reduce_kernel_matches_plain(cuda, dtype):
    dtype, _, case = dtype.partition("-")
    rng = np.random.default_rng(len(dtype) + len(case))
    cap = int(case[3:]) if case.startswith("cap") else 1 << 16
    domain = int(case[6:]) if case.startswith("domain") else 12
    dist = case if case in ("one", "q1", "dead") else "uniform"
    caps = [cap, 3001] if case == "twice" else [cap]
    segs = [torch.from_numpy(_seg(rng, c, domain, dist)).to(cuda)
            for c in caps]
    lane = torch.from_numpy(_lane(rng, dtype, cap)).to(cuda)
    for is_min in (True, False):
        if dtype == "float64":
            ident = np.inf if is_min else -np.inf
        elif dtype == "bool":
            ident = int(is_min)
        else:
            info = np.iinfo(dtype)
            ident = int(info.max if is_min else info.min)
        PH.reset_launch_counts()
        got = [PS.seg_reduce(sg, lane[:sg.numel()], domain, is_min, ident)
               for sg in segs]
        # one launch per call: identities and float64 values written by
        # the kernel itself, narrow lanes read as they lie
        assert PH.LAUNCHES["seg_reduce"] == len(segs)
        for sg, c in zip(segs, got):
            p = PS.seg_reduce_plain(sg, lane[:sg.numel()], domain, is_min,
                                    ident)
            assert c.dtype == lane.dtype
            assert np.array_equal(_bits(c.cpu().numpy()),
                                  _bits(p.cpu().numpy()))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs(cuda):
    seg = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        PS.seg_sums(seg, [], [], 4)


# caps around a thread's 16 rows and a tile's 4,096, and the main
# path's; none kept and all kept
_COMPACT_CASES = [(1, 0.5), (15, 0.5), (16, 0.5), (17, 0.5), (1023, 0.5),
                  (1024, 0.5), (4095, 0.5), (4096, 0.5), (4097, 0.5),
                  (1 << 20, 0.05), (3_000_017, 0.3), (3_000_017, 0.99),
                  (1 << 16, 0.0), (1 << 16, 1.0), (4097, 0.0), (4097, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,p", _COMPACT_CASES)
def test_compaction_order_kernel_matches_plain(cuda, cap, p):
    keep = torch.from_numpy(np.random.default_rng(cap).random(cap) < p) \
        .to(cuda)
    PH.reset_launch_counts()
    order, count = PC.compaction_order(keep)
    porder, pcount = PC.compaction_order_plain(keep)
    # the look-back scan and the identity tail
    assert PH.LAUNCHES["compaction_order"] == 2
    assert count.dim() == 0 and int(count) == int(pcount)
    assert torch.equal(order, porder)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [5, 4095, 100_003])
def test_compaction_order_kernel_takes_misaligned_masks(cuda, cap):
    # slices such as mask[1:] start off 16-byte alignment: the head and
    # tail rows load one by one, the rest 16 at a time
    base = torch.from_numpy(np.random.default_rng(cap).random(cap + 16)
                            < 0.4).to(cuda)
    for off in (1, 3, 8, 15):
        keep = base[off:off + cap]
        assert keep.data_ptr() % 16 == off
        order, count = PC.compaction_order(keep)
        porder, pcount = PC.compaction_order_plain(keep)
        assert int(count) == int(pcount)
        assert torch.equal(order, porder)


@pytest.mark.cuda
def test_compaction_order_kernel_back_to_back_and_on_a_side_stream(cuda):
    # the tile counter and the status words are reused without a fill:
    # calls queued back to back, and a call on another stream (its own
    # scratch)
    rng = np.random.default_rng(3)
    masks = [torch.from_numpy(rng.random(n) < p).to(cuda)
             for n, p in ((1 << 20, 0.5), (70_001, 0.9), (1 << 20, 0.01))]
    got = [PC.compaction_order(m) for m in masks]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = PC.compaction_order(masks[0])
    torch.cuda.current_stream(cuda).wait_stream(side)
    for m, (order, count) in zip(masks + masks[:1], got + [on_side]):
        porder, pcount = PC.compaction_order_plain(m)
        assert int(count) == int(pcount)
        assert torch.equal(order, porder)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 100, 1023])
def test_compact_batch_launches_the_kernel_below_1024_rows(cuda, n):
    # the reference keeps its argsort below 1024 rows; the port has no
    # such tier and launches the kernel at every capacity
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.device import to_device, to_host
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    from spark_rapids_tpu_torch.ops.filter import compact_batch
    rng = np.random.default_rng(n)
    schema = T.StructType([T.StructField("x", T.LONG)])
    x = rng.integers(-99, 99, n)
    batch = from_numpy({"x": x}, schema)
    keep = rng.random(n) < 0.6
    got = {}
    for dev in ("cpu", "cuda"):
        db = to_device(batch, device=dev)
        mask = np.zeros(db.capacity, bool)
        mask[:n] = keep
        PH.reset_launch_counts()
        out = compact_batch(db, torch.from_numpy(mask).to(dev))
        got[dev] = (PH.LAUNCHES["compaction_order"],
                    to_host(out, int(out.num_rows)).to_pydict())
    assert got["cpu"][0] == 0 and got["cuda"][0] == 2
    assert got["cuda"][1] == got["cpu"][1]
    assert got["cpu"][1]["x"] == x[keep].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("cap,span,dead", [(1024, 50, 0.1),
                                           (1 << 20, 1 << 40, 0.2),
                                           (4096, 3, 0.0), (2048, 9, 1.0),
                                           (1 << 16, 2 ** 62, 0.0)])
def test_build_table_and_probe_first_kernels_match_plain(cuda, cap, span,
                                                         dead):
    rng = np.random.default_rng(cap + int(dead * 10))
    lane = torch.from_numpy(rng.integers(-span, span, cap)).to(cuda)
    lane[:2] = torch.tensor([2 ** 63 - 1, -2 ** 63])
    valid = torch.from_numpy(rng.random(cap) >= dead).to(cuda)
    PH.reset_launch_counts()
    table = PHJ.build_table(lane, valid)
    ideal, lane_s, rid = PHJ.hash_order(lane, valid, table.nbits)
    slots = PHJ.build_layout_plain(ideal, lane_s, rid, table.span)
    # every slot's 16 bytes, dead rows' and empty slots' included
    assert torch.equal(table.slots, slots)
    probe = torch.from_numpy(rng.integers(-span, span, cap)).to(cuda)
    probe[: cap // 2] = lane[torch.randperm(cap, device=cuda)[: cap // 2]]
    pvalid = torch.from_numpy(rng.random(cap) > 0.1).to(cuda)
    row, ok = PHJ.probe_first(table, probe, pvalid)
    prow, pok = PHJ.probe_first_plain(table, probe, pvalid)
    assert torch.equal(row, prow) and torch.equal(ok, pok)
    # build_table: the scan of the finals and the slot pass;
    # probe_first: one
    assert PH.LAUNCHES["build_table"] == 2
    assert PH.LAUNCHES["probe_first"] == 1


def _pushed(nbits, n):
    """n distinct keys homed at the last two of 2^nbits slots."""
    cand = torch.from_numpy(np.random.default_rng(5).integers(
        -2 ** 62, 2 ** 62, 1 << 18))
    home = (PHJ.mix64(cand) >> (64 - nbits)) & ((1 << nbits) - 1)
    return cand[home >= (1 << nbits) - 2][:n]


def _layout_lane(kind, cap, rng):
    """(build lane, valid) on the CPU for one layout case."""
    lane = torch.from_numpy(rng.permutation(cap * 4)[:cap].astype(
        np.int64) - cap)
    valid = torch.ones(cap, dtype=torch.bool)
    if kind == "sparse":
        valid = torch.from_numpy(rng.random(cap) < 0.01)
    elif kind == "2,000 valid":
        valid[2000:] = False
    elif kind == "all dead":
        valid[:] = False
    elif kind == "pushed":
        # six keys homed at the last two home slots, 200 rows each:
        # their run crosses row tiles and slot chunks into the tail
        lane[-1200:] = _pushed(PHJ.table_geometry(cap)[0], 6) \
            .repeat_interleave(200)
    elif kind == "key 10,000 times":
        lane[rng.permutation(cap)[:10_000]] = 12345
    elif kind == "odd capacity":
        valid = torch.from_numpy(rng.random(cap) < 0.8)
    return lane, valid


# a chunk with no row, a chunk of dead rows only, a chunk that starts
# inside a pushed run, runs across 4,096-row tiles and 2,048-slot
# chunks, capacities off both
_LAYOUT_CASES = [("sparse", 8192), ("sparse", 1 << 20),
                 ("2,000 valid", 2_097_152), ("pushed", 2048),
                 ("pushed", 1 << 16), ("key 10,000 times", 1 << 20),
                 ("all dead", 5000), ("all dead", 1 << 20),
                 ("odd capacity", 3001), ("odd capacity", 3_000_017),
                 ("odd capacity", 1), ("odd capacity", 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap", _LAYOUT_CASES)
def test_build_layout_kernel_writes_every_slot_as_plain(cuda, kind, cap):
    lane, valid = _layout_lane(kind, cap, np.random.default_rng(cap))
    lane, valid = lane.to(cuda), valid.to(cuda)
    nbits, span = PHJ.table_geometry(cap)
    ideal, lane_s, rid = PHJ.hash_order(lane, valid, nbits)
    PH.reset_launch_counts()
    got = PHJ.build_layout(ideal, lane_s, rid, span)
    assert PH.LAUNCHES["build_table"] == 2
    assert torch.equal(got, PHJ.build_layout_plain(ideal, lane_s, rid, span))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,span,wild", [(1000, 1200, False),
                                           (5000, 5100, False),
                                           (20_001, 20_001, True)])
def test_build_layout_kernel_clips_hand_built_finals(cuda, cap, span, wild):
    # ideal below 0 and past the span stack rows on slots 0 and span - 1
    # after the clip (with `wild`, int32 extremes up front stack nearly
    # every row on span - 1, more rows than a chunk holds); the last of
    # them keeps the slot, in both versions
    rng = np.random.default_rng(cap)
    ideal = torch.from_numpy(np.sort(rng.integers(-60, span + 100, cap))
                             .astype(np.int32))
    if wild:
        ideal[: cap // 7] = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31 - 1, cap // 7, endpoint=True).astype(np.int32))
    lane = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, cap,
                                         endpoint=True))
    rid = torch.from_numpy(rng.integers(-1, cap, cap).astype(np.int32))
    want = PHJ.build_layout_plain(ideal, lane, rid, span)
    got = PHJ.build_layout(ideal.to(cuda), lane.to(cuda), rid.to(cuda),
                           span)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_build_layout_kernel_back_to_back_misaligned_and_on_a_side_stream(
        cuda):
    # the tile counter, status words and chunk words are reused without
    # a fill: builds of other sizes queued back to back, inputs off
    # 16-byte alignment (the scalar path), and a build on another stream
    rng = np.random.default_rng(9)
    cases = []
    for cap, p in ((1 << 20, 0.5), (70_001, 0.9), (1 << 16, 0.01)):
        lane = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, cap)).to(cuda)
        valid = torch.from_numpy(rng.random(cap) < p).to(cuda)
        nbits, span = PHJ.table_geometry(cap)
        cases.append((*PHJ.hash_order(lane, valid, nbits), span))
    got = [PHJ.build_layout(*c) for c in cases]
    ideal, lane_s, rid, span = cases[1]
    odd = (ideal[1:], lane_s[1:], rid[1:], span)
    assert odd[0].data_ptr() % 16 == 4
    got.append(PHJ.build_layout(*odd))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = PHJ.build_layout(*cases[0])
    torch.cuda.current_stream(cuda).wait_stream(side)
    for c, slots in zip(cases + [odd, cases[0]], got + [on_side]):
        assert torch.equal(slots, PHJ.build_layout_plain(*c))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,span,dead,pcap", [
    (1024, 50, 0.1, 1000), (1 << 20, 1 << 19, 0.2, 1 << 20),
    (4096, 3, 0.0, 3001), (2048, 9, 1.0, 2048), (1 << 16, 2 ** 62, 0.0,
                                                 1 << 16)])
def test_probe_counts_and_expand_pairs_kernels_match_plain(cuda, cap, span,
                                                           dead, pcap):
    rng = np.random.default_rng(cap + pcap)
    lane = torch.from_numpy(rng.integers(-span, span, cap)).to(cuda)
    lane[:2] = torch.tensor([2 ** 63 - 1, -2 ** 63])
    valid = torch.from_numpy(rng.random(cap) >= dead).to(cuda)
    table = PHJ.build_table(lane, valid)
    probe = torch.from_numpy(rng.integers(-span, span, pcap)).to(cuda)
    probe[: pcap // 2] = lane[torch.randint(0, cap, (pcap // 2,),
                                            device=cuda)]
    probe[-2:] = torch.tensor([2 ** 63 - 1, -2 ** 63])
    pvalid = torch.from_numpy(rng.random(pcap) > 0.1).to(cuda)
    PH.reset_launch_counts()
    first, counts, cum = PHJ.probe_counts(table, probe, pvalid)
    pfirst, pcounts = PHJ.probe_counts_plain(table, probe, pvalid)
    assert torch.equal(first, pfirst) and torch.equal(counts, pcounts)
    assert torch.equal(cum, torch.cumsum(pcounts, 0, dtype=torch.int32))
    total = int(cum[-1])
    for out_cap in (max(total, 1), total + 1000):
        got = PHJ.expand_pairs(table, first, counts, cum, out_cap, total)
        want = PHJ.expand_pairs_plain(table, first, counts, cum, out_cap,
                                      total)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert PH.LAUNCHES["probe_counts"] == 1
    assert PH.LAUNCHES["expand_pairs"] == 2
    flags = PHJ.build_matched_flags(table, first, counts, cap)
    cpu_table = PHJ.HashTable(table.keys.cpu(), table.rows.cpu(),
                              table.nbits, table.span)
    assert torch.equal(flags.cpu(), PHJ.build_matched_flags(
        cpu_table, first.cpu(), counts.cpu(), cap))


def _probe_case(rng, cuda, pcap, p_valid, span=1 << 19, cap=1 << 16):
    lane = torch.from_numpy(rng.integers(-span, span, cap)).to(cuda)
    table = PHJ.build_table(lane, torch.ones(cap, dtype=torch.bool,
                                             device=cuda))
    probe = torch.from_numpy(rng.integers(-span, span, pcap)).to(cuda)
    probe[: pcap // 2] = lane[torch.randint(0, cap, (pcap // 2,),
                                            device=cuda)]
    pvalid = torch.from_numpy(rng.random(pcap) < p_valid).to(cuda)
    return table, probe, pvalid


def _check_counts(table, probe, pvalid):
    first, counts, cum = PHJ.probe_counts(table, probe, pvalid)
    pfirst, pcounts = PHJ.probe_counts_plain(table, probe, pvalid)
    assert torch.equal(first, pfirst) and torch.equal(counts, pcounts)
    assert torch.equal(cum, torch.cumsum(counts, 0, dtype=torch.int32))
    return int(cum[-1])


def _check_first(table, probe, pvalid):
    row, ok = PHJ.probe_first(table, probe, pvalid)
    prow, pok = PHJ.probe_first_plain(table, probe, pvalid)
    assert torch.equal(row, prow) and torch.equal(ok, pok)
    return int(ok.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("pcap,p_valid", [
    (1 << 16, 0.0), (1 << 16, 1.0), (1, 1.0), (2047, 0.5), (2049, 0.5),
    (4095, 0.5), (4096, 0.5), (4097, 0.5), (3_000_017, 0.54)])
def test_probe_first_kernel_edges(cuda, pcap, p_valid):
    # no valid probe row, every row valid, capacities around the
    # 2,048-row tile and its double, and one that is a multiple of
    # neither; one launch
    rng = np.random.default_rng(pcap + int(100 * p_valid))
    table, probe, pvalid = _probe_case(rng, cuda, pcap, p_valid)
    PH.reset_launch_counts()
    matched = _check_first(table, probe, pvalid)
    assert PH.LAUNCHES["probe_first"] == 1
    assert p_valid > 0.0 or matched == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_probe_first_kernel_takes_misaligned_validity(cuda, offset):
    rng = np.random.default_rng(offset)
    table, probe, pvalid = _probe_case(rng, cuda, 50_001, 0.6)
    wide = torch.cat([pvalid[:offset], pvalid])
    assert wide[offset:].data_ptr() % 16 == offset
    _check_first(table, probe, wide[offset:])


@pytest.mark.cuda
def test_probe_first_kernel_back_to_back_and_on_a_side_stream(cuda):
    rng = np.random.default_rng(21)
    cases = [_probe_case(rng, cuda, n, p) for n, p in
             ((1 << 20, 0.5), (70_001, 0.9), (1 << 18, 0.05))]
    got = [PHJ.probe_first(*c) for c in cases]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = PHJ.probe_first(*cases[0])
    torch.cuda.current_stream(cuda).wait_stream(side)
    for case, (row, ok) in zip(cases + cases[:1], got + [on_side]):
        prow, pok = PHJ.probe_first_plain(*case)
        assert torch.equal(row, prow) and torch.equal(ok, pok)


# expand_pairs over counted-probe outputs made by hand (counts per probe
# row, their cum, random run starts) against a table of random rows:
# (case, probe capacity, pairs owned by row 777, leading rows owning
# nothing, dead slots past the total)
_EXPAND_CASES = [("total 0", 1 << 16, None, 0, 5000),
                 ("total = out_cap", 1 << 16, None, 0, 0),
                 ("out_cap off the tile", 1 << 16, None, 0, 16_411),
                 ("probe capacity 1", 1, None, 0, 3),
                 ("one row owns 100,000 pairs", 1 << 16, 100_000, 0, 10),
                 ("3,000,000 leading rows own nothing", 1 << 16, None,
                  3_000_000, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,pcap,big,lead,dead", _EXPAND_CASES)
def test_expand_pairs_kernel_edges(cuda, case, pcap, big, lead, dead):
    rng = np.random.default_rng(len(case))
    counts = rng.integers(1, 4, pcap) * (rng.random(pcap) < 0.3)
    if case == "total 0":
        counts[:] = 0
    if case == "probe capacity 1":
        counts[:] = 7
    if big is not None:
        counts[777] = big
    counts = np.concatenate([np.zeros(lead, np.int64), counts])
    cum = np.cumsum(counts)
    total = int(cum[-1])
    out_cap = total + dead
    span = 1 << 18
    table = PHJ.HashTable(
        torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, span)).to(cuda),
        torch.from_numpy(rng.integers(-1, 1 << 20, span).astype(np.int32))
        .to(cuda), 17, span)
    first, counts, cum = (torch.from_numpy(x.astype(np.int32)).to(cuda)
                          for x in (rng.integers(0, span, len(counts)),
                                    counts, cum))
    PH.reset_launch_counts()
    got = PHJ.expand_pairs(table, first, counts, cum, out_cap, total)
    want = PHJ.expand_pairs_plain(table, first, counts, cum, out_cap, total)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert PH.LAUNCHES["expand_pairs"] == 1
    assert int(got[2].sum()) == total


@pytest.mark.cuda
@pytest.mark.parametrize("pcap,p_valid", [
    (1 << 16, 0.0), (1 << 16, 1.0), (4097, 0.5), (4095, 1.0), (1, 1.0),
    (3001, 0.14), (1 << 20, 0.14)])
def test_probe_counts_kernel_edges(cuda, pcap, p_valid):
    # no valid probe row, every row valid, capacities that are not a
    # multiple of the 4,096-row tile, m2m's share of valid rows
    rng = np.random.default_rng(pcap + int(100 * p_valid))
    table, probe, pvalid = _probe_case(rng, cuda, pcap, p_valid)
    PH.reset_launch_counts()
    total = _check_counts(table, probe, pvalid)
    assert PH.LAUNCHES["probe_counts"] == 1
    assert p_valid > 0.0 or total == 0        # no valid row, no pair


@pytest.mark.cuda
def test_probe_counts_kernel_back_to_back_and_misaligned(cuda):
    # calls queued back to back share the look-back scratch; a validity
    # lane off 16-byte alignment
    rng = np.random.default_rng(9)
    cases = [_probe_case(rng, cuda, n, p) for n, p in
             ((1 << 20, 0.5), (50_001, 0.9), (1 << 18, 0.05))]
    for table, probe, pvalid in cases + cases:
        _check_counts(table, probe, pvalid)
    table, probe, pvalid = cases[1]
    wide = torch.cat([pvalid[:3], pvalid])
    assert wide[3:].data_ptr() % 16 == 3
    _check_counts(table, probe, wide[3:])


@pytest.mark.cuda
def test_probe_counts_kernel_reaches_the_clamped_last_slot(cuda):
    # a hand-built table whose runs end at span - 1: the reference
    # re-reads that slot for the steps it has left, and each re-read of
    # a hit counts again
    nbits, span = 4, 24
    keys = np.zeros(span, np.int64)
    rows = np.full(span, -1, np.int32)
    cand = torch.arange(1, 5000, dtype=torch.int64)
    home = (PHJ.mix64(cand) >> (64 - nbits)) & ((1 << nbits) - 1)
    k_hi = int(cand[home == 15][0])
    k_lo = int(cand[home == 2][0])
    # slots 2-14 hold key 7 (home 7), 15-19 k_hi (home 15) and 20-23
    # k_lo (home 2): k_lo's walk passes 18 slots and its run ends at
    # the last one
    keys[2:15], rows[2:15] = 7, np.arange(9, 22)
    keys[15:20], rows[15:20] = k_hi, np.arange(5)
    keys[20:], rows[20:] = k_lo, np.arange(5, 9)
    table = PHJ.HashTable(torch.from_numpy(keys).to(cuda),
                          torch.from_numpy(rows).to(cuda), nbits, span)
    probe = torch.tensor([k_hi, k_lo, 7, 123456, k_lo, k_hi],
                         device=cuda)
    pvalid = torch.tensor([True, True, True, True, False, True],
                          device=cuda)
    _check_counts(table, probe, pvalid)
    _f, counts, _c = PHJ.probe_counts(table, probe, pvalid)
    # 4 slots of k_lo's run, and 2 re-reads of the last (its home)
    assert counts.tolist() == [5, 6, 8, 0, 0, 5]
    # the unique-build probe walks the same table to its last slot
    _check_first(table, probe, pvalid)


def _cpu_and_cuda(build):
    from spark_rapids_tpu_torch.session import TpuSession
    cpu = build(TpuSession(device="cpu")).to_pydict()
    gpu = build(TpuSession(device="cuda")).to_pydict()
    return ({k: [repr(v) for v in vs] for k, vs in cpu.items()},
            {k: [repr(v) for v in vs] for k, vs in gpu.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q1", "q3", "q6"])
def test_tpch_on_the_card_equals_cpu_and_launches_kernels(cuda, query):
    from spark_rapids_tpu_torch import tpch
    tables = tpch.gen_tables(0.001, tables=("customer", "orders",
                                            "lineitem"))
    PH.reset_launch_counts()
    cpu, gpu = _cpu_and_cuda(lambda s: tpch.QUERIES[query](s, tables))
    assert gpu == cpu
    # q6 is a global sum: no kernel
    want = {"q1": ("seg_sums",), "q3": ("build_table", "probe_first",
                                        "compaction_order"), "q6": ()}
    for kernel in want[query]:
        assert PH.LAUNCHES[kernel] > 0


@pytest.mark.cuda
def test_sort_and_float_minmax_on_the_card_equal_cpu(cuda):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    from spark_rapids_tpu_torch.plan.aggregates import Max, Min
    from spark_rapids_tpu_torch.session import col
    schema = T.StructType([T.StructField("k", T.STRING),
                           T.StructField("x", T.DOUBLE)])
    cols = {"k": np.array(["a", "a", "b", "b", "c", "c", "d"], object),
            "x": np.array([0.0, -0.0, np.nan, 1.0, -0.0, 0.0, -np.inf])}
    batch = from_numpy(cols, schema)
    cpu, gpu = _cpu_and_cuda(lambda s: s.from_host(batch).sort(
        ("x", False, False), "k"))
    assert gpu == cpu
    PH.reset_launch_counts()
    cpu, gpu = _cpu_and_cuda(lambda s: s.from_host(batch)
                             .group_by("k").agg((Min(col("x")), "mn"),
                                                (Max(col("x")), "mx"))
                             .sort("k"))
    assert gpu == cpu
    assert PH.LAUNCHES["seg_reduce"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["m2m", "outer", "semi"])
def test_join_queries_on_the_card_equal_cpu_and_launch_kernels(cuda, query):
    from spark_rapids_tpu_torch import tpch
    tables = tpch.gen_tables(0.001, tables=("partsupp", "lineitem"))
    PH.reset_launch_counts()
    cpu, gpu = _cpu_and_cuda(lambda s: tpch.JOIN_QUERIES[query](s, tables))
    assert gpu == cpu
    # m2m's expanded pairs reach its aggregation as a selection vector
    # (sql.join.lazySelection): no compaction
    want = {"m2m": ("build_table", "probe_counts", "expand_pairs",
                    "seg_sums"),
            "outer": ("build_table", "probe_counts", "expand_pairs",
                      "compaction_order"),
            "semi": ("build_table", "probe_first", "compaction_order")}
    for kernel in want[query]:
        assert PH.LAUNCHES[kernel] > 0


@pytest.mark.cuda
def test_decimal_to_double_on_the_card_is_correctly_rounded(cuda):
    # a true division by a Python scalar multiplies by its reciprocal on
    # the card; to_double divides, as on the CPU (ROADMAP Queue 3 item 1)
    from spark_rapids_tpu_torch.ops import decimal as PD
    rng = np.random.default_rng(9)
    u = np.concatenate([[96509304917, -16983427970],
                        rng.integers(-10 ** 12, 10 ** 12, 100_000)])
    for scale in (2, 6):
        gpu = PD.to_double(torch.from_numpy(u).to(cuda), scale).cpu().numpy()
        np.testing.assert_array_equal(gpu.view(np.int64), (
            u.astype(np.float64) / float(10 ** scale)).view(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q4", "q5", "q7", "q8", "q10", "q11",
                                   "q12", "q15", "q17", "q18", "q19",
                                   "q2", "q9", "q13", "q14", "q16", "q20",
                                   "q21", "q22"])
def test_later_queries_on_the_card_equal_cpu(cuda, query):
    # DOUBLE sums may add in another order on the card (segagg's atomics,
    # a device reduction): those compare within rtol 1e-12
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.session import TpuSession
    tables = tpch.gen_tables(0.01)
    cpu, gpu = (tpch.QUERIES[query](TpuSession(device=d), tables)
                .to_pydict() for d in ("cpu", "cuda"))
    assert list(gpu) == list(cpu)
    for name, want in cpu.items():
        if want and isinstance(want[0], float):
            np.testing.assert_allclose(gpu[name], want, rtol=1e-12, atol=0)
        else:
            assert gpu[name] == want, name


@pytest.mark.cuda
def test_string_byte_work_on_the_card_equals_cpu(cuda):
    # 1- to 4-byte characters and empty entries: the device encoding,
    # the matchers, Substring's decode and unique, and their remaps
    from spark_rapids_tpu_torch.ops import strings as S
    rng = np.random.default_rng(11)
    alphabet = list("abgren ") + ["é", "日", "😀"]
    words = {"".join(alphabet[i] for i in rng.integers(0, len(alphabet), k))
             for k in rng.integers(0, 9, 20_000)}
    d = np.array(sorted(words), str)
    cpu, gpu = (S.dict_byte_tensors(d, dev) for dev in ("cpu", cuda))
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())
    for match in (S.match_prefix, S.match_suffix, S.match_contains,
                  S.match_equals):
        for pat in ("", "a", "é日", "😀", "x" * 12):
            raw = pat.encode("utf-8")
            assert torch.equal(match(*cpu, raw), match(*gpu, raw).cpu())
    assert torch.equal(S.char_lengths(*cpu), S.char_lengths(*gpu).cpu())
    for pos, length in ((1, 2), (0, 3), (-2, None), (3, 0), (2, -1)):
        want, remap = S.transform_dict_device(d, "substr", (pos, length),
                                              "cpu")
        got, remap_gpu = S.transform_dict_device(d, "substr", (pos, length),
                                                 cuda)
        assert got.tolist() == want.tolist()
        assert torch.equal(remap, remap_gpu.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("device_min", ["1", "8192"])
def test_substring_and_count_distinct_on_the_card_equal_cpu(cuda,
                                                             device_min):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.plan.aggregates import CountDistinct
    from spark_rapids_tpu_torch.session import TpuSession, col
    tables = tpch.gen_tables(0.01, tables=("customer", "orders",
                                           "lineitem"))
    conf = {"spark.rapids.tpu.sql.string.transformDeviceMinUnique":
            device_min}
    cpu, gpu = (tpch.q22(TpuSession(conf, device=d), tables).to_pydict()
                for d in ("cpu", "cuda"))
    assert gpu["cntrycode"] == cpu["cntrycode"] and \
        gpu["numcust"] == cpu["numcust"]
    np.testing.assert_allclose(gpu["totacctbal"], cpu["totacctbal"],
                               rtol=1e-12, atol=0)
    cpu, gpu = _cpu_and_cuda(lambda s: s.from_host(tables["lineitem"])
                             .group_by("l_orderkey")
                             .agg((CountDistinct(col("l_suppkey")), "n"))
                             .sort("l_orderkey"))
    assert gpu == cpu


@pytest.mark.cuda
def test_a_spillable_round_trips_a_cuda_batch_through_pinned_host_and_disk(
        cuda):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.columnar.device import to_device
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.runtime.memory import MemoryBudget, Spillable
    li = tpch.gen_tables(0.001, tables=("lineitem",))["lineitem"]
    db = to_device(li, device=cuda)
    lanes = [(c.data.clone(), c.validity.clone()) for c in db.columns]
    budget = MemoryBudget(TpuConf({}), cuda)
    # allocFraction x the card's memory
    assert budget.limit == int(0.85 * torch.cuda.mem_get_info(cuda)[1])
    sp = Spillable(db, budget)
    del db
    sp.spill()
    assert sp.on_host and all(x.is_pinned() for x in sp._host)
    back = sp.get()
    assert back.device.type == "cuda"
    for c, (d, v) in zip(back.columns, lanes):
        assert torch.equal(c.data, d) and torch.equal(c.validity, v)
    sp.spill()
    sp.to_disk()
    assert sp.on_disk and budget.metrics["disk_batches"] == 1
    back = sp.get()
    for c, (d, v) in zip(back.columns, lanes):
        assert torch.equal(c.data, d) and torch.equal(c.validity, v)
    sp.close()
    assert budget.live == budget.host_live == 0


@pytest.mark.cuda
def test_partition_ids_on_the_card_equal_the_cpus(cuda):
    from spark_rapids_tpu_torch.columnar.device import to_device
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    from spark_rapids_tpu_torch.exec.plan import _agg_partition_ids
    rng = np.random.default_rng(41)
    n = 100_000
    f = rng.standard_normal(n) * 1e9
    f[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300]
    from spark_rapids_tpu_torch import types as t
    hb = from_numpy({"i": rng.integers(-2 ** 63, 2 ** 63 - 1, n),
                     "d": f, "s": rng.choice(["a", "é", "zz", ""], n)},
                    t.StructType([t.StructField("i", t.LONG),
                                  t.StructField("d", t.DOUBLE),
                                  t.StructField("s", t.STRING)]))
    cpu, gpu = to_device(hb, device="cpu"), to_device(hb, device=cuda)
    for k, salt in ((2, 0), (8, 1), (61, 3)):
        assert torch.equal(_agg_partition_ids(gpu, 3, k, salt).cpu(),
                           _agg_partition_ids(cpu, 3, k, salt))


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left_outer", "right_outer",
                                 "full_outer", "left_semi", "left_anti"])
def test_a_sub_partitioned_join_on_the_card_equals_the_resident_join(
        cuda, how):
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.session import TpuSession
    from spark_rapids_tpu_torch import types as t

    def longs(*names):
        return t.StructType([t.StructField(n, t.LONG) for n in names])
    rng = np.random.default_rng(43)
    fact = from_numpy({"fk": rng.integers(-50, 5000, 40_000),
                       "x": rng.integers(0, 100, 40_000)}, longs("fk", "x"))
    dim = from_numpy({"dk": rng.integers(0, 4000, 9_000),
                      "w": rng.integers(0, 100, 9_000)}, longs("dk", "w"))
    small = {"spark.rapids.tpu.sql.batchSizeRows": "4096"}
    out = {}
    for name, conf in (("resident", {}), ("sub", small)):
        s = TpuSession(conf)
        q = s.from_host(fact).join(s.from_host(dim), how=how,
                                   left_on=["fk"], right_on=["dk"]) \
            .physical()
        ctx = ExecContext(q.conf, q.device)
        got = q.collect(ctx).to_pydict()
        out[name] = sorted(zip(*got.values()),
                           key=lambda r: tuple((v is None, v) for v in r))
        assert (ctx.metrics.get("join_subpartition_fallbacks", 0) > 0) == \
            (name == "sub")
    assert out["sub"] == out["resident"] and len(out["sub"]) > 0


def _window_lanes(n, seed):
    """A partition-sorted batch's lanes for window_trace: INT partition
    key with nulls, LONG order key with nulls and duplicates, DOUBLE
    values with NaN and ±0.0, LONG values, decimal(7,2) values."""
    from spark_rapids_tpu_torch import types as t
    rng = np.random.default_rng(seed)
    g = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    gv = rng.random(n) > 0.02
    o = rng.integers(0, 300, n).astype(np.int64)
    o[rng.random(n) < 0.05] = 2 ** 62
    ov = rng.random(n) > 0.05
    v = rng.standard_normal(n)
    v[::17], v[3::17], v[5::23] = np.nan, -0.0, 0.0
    i = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
    m = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
    vv = rng.random(n) > 0.1
    return ((t.INT, g, gv), (t.LONG, o, ov),
            [(t.DOUBLE, v, vv), (t.LONG, i, None),
             (t.DecimalType(7, 2), m, vv)])


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [
    None, ("rows", None, 0), ("rows", -3, 3), ("rows", None, 2),
    ("rows", -2, None), ("range", None, None), ("range", 0, None),
    ("range", 0, 0), ("range", -30, 0), ("range", -5, 12),
    ("range", -(2 ** 62), 2 ** 62)])
def test_window_trace_on_the_card_equals_cpu(cuda, frame):
    from spark_rapids_tpu_torch.ops.window import window_trace
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan import window as W
    n = 6000
    (pdt, g, gv), (odt, o, ov), vals = _window_lanes(n, 45)
    fr = None if frame is None else W.WindowFrame(*frame)
    specs = [W.RowNumber(), W.Rank(), W.DenseRank(), W.PercentRank(),
             W.CumeDist(), W.NTile(4), W.Lead(E.ColumnRef("v0"), 1, 0.5),
             W.Lag(E.ColumnRef("v1"), 2, -7)]
    for k in range(3):
        c = E.ColumnRef(f"v{k}")
        specs += [W.WinSum(c, fr), W.WinCount(c, fr), W.WinMin(c, fr),
                  W.WinMax(c, fr), W.WinAverage(c, fr), W.FirstValue(c, fr),
                  W.LastValue(c, fr)]
    specs.append(W.WinCount(None, fr))
    from spark_rapids_tpu_torch import types as t
    schema = t.StructType([t.StructField(f"v{k}", dt)
                           for k, (dt, _d, _v) in enumerate(vals)])
    specs = [s.bind(schema) for s in specs]
    frames = [(s, s.frame if s.frame is not None else (
        W.WindowFrame("range", None, None) if s.kind in (
            "row_number", "rank", "dense_rank", "percent_rank",
            "cume_dist", "ntile", "lead", "lag")
        else W.default_frame(True)),
        -1 if s.child is None else int(s.child.name[1:])) for s in specs]
    # sort rows by (partition, order) as WindowExec does: nulls first
    key_g = np.where(gv, g, -1)
    key_o = np.where(ov, o, -(2 ** 63))
    perm = np.lexsort((key_o, key_g))
    out = []
    for dev in ("cpu", cuda):
        def lane(x):
            return None if x is None else torch.from_numpy(
                np.ascontiguousarray(x[perm])).to(dev)
        fn = window_trace(((pdt,),), ((odt,),),
                          tuple((dt,) for dt, _d, _v in vals), frames, n,
                          order_dirs=((True, True),))
        outs = fn((lane(g),), (lane(gv),), (lane(o),), (lane(ov),),
                  tuple(lane(d) for _dt, d, _v in vals),
                  tuple(lane(v) for _dt, _d, v in vals),
                  torch.ones(n, dtype=torch.bool, device=dev))
        out.append([(d.cpu(), v.cpu()) for d, v in outs])
    # a DOUBLE sum or average over a bounded frame is a difference of
    # prefix sums, which the card's cumsum adds in another order than
    # the CPU's, so their rounding differs by a few ulps of the prefix
    # sums (|prefix| < 200 here): within 1e-9 absolute (README);
    # everything else exactly
    bounded = fr is not None and (fr.kind == "rows" and not fr.is_running
                                  or fr.is_value_offset)
    for s, (a, av), (b, bv) in zip(specs, *out):
        assert torch.equal(av, bv), s
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a) & av, torch.isnan(b) & bv), s
            a = torch.where(av & ~torch.isnan(a), a, torch.zeros_like(a))
            b = torch.where(bv & ~torch.isnan(b), b, torch.zeros_like(b))
            if bounded and s.kind in ("agg_sum", "agg_avg"):
                torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-9,
                                           msg=repr(s))
                continue
        assert torch.equal(torch.where(av, a, torch.zeros_like(a)),
                           torch.where(bv, b, torch.zeros_like(b))), s


@pytest.mark.cuda
def test_a_union_and_rollup_query_on_the_card_equals_cpu(cuda):
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.session import TpuSession
    tables = tpcds.gen_tables(0.01)
    for q in ("q27", "q36", "q76", "q70", "q98"):
        cpu, gpu = (tpcds.QUERIES[q](TpuSession(device=d), tables)
                    .to_pydict() for d in ("cpu", cuda))
        assert list(gpu) == list(cpu), q
        for k in cpu:
            if any(isinstance(x, float) for x in cpu[k]):
                assert [x is None for x in gpu[k]] == \
                    [x is None for x in cpu[k]], (q, k)
                np.testing.assert_allclose(
                    np.array([x for x in gpu[k] if x is not None], float),
                    np.array([x for x in cpu[k] if x is not None], float),
                    rtol=1e-12, atol=0, err_msg=f"{q}.{k}")
            else:
                assert gpu[k] == cpu[k], (q, k)


def _dense_inputs(rng, cap, sizes):
    keys = [rng.integers(0, s, cap).astype(np.int32) for s in sizes]
    kvalid = [rng.random(cap) > 0.05 for _ in sizes]
    f = rng.standard_normal(cap)
    f[::37], f[1::37], f[::101] = -0.0, 0.0, np.nan
    data = [rng.integers(-2 ** 40, 2 ** 40, cap), f,
            rng.random(cap) > 0.4,
            rng.integers(-2 ** 31, 2 ** 31 - 1, cap).astype(np.int32)]
    valid = [rng.random(cap) > 0.2 for _ in data]
    return keys, kvalid, data, valid, rng.random(cap) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(1800,), (1300, 2), (10, 16, 8)])
def test_dense_groupby_on_the_card_equals_cpu(cuda, sizes):
    """The dense tier's buckets, group order, counts, integer sums,
    MIN/MAX, FIRST/LAST and ANY/EVERY equal the CPU's exactly; float64
    sums are atomics in run-dependent order on the card: rtol 1e-12."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import groupby as G
    kinds = [("sum", 0, T.LONG), ("sum", 1, T.DOUBLE), ("count", 1, T.LONG),
             ("count_all", -1, T.LONG), ("min", 1, T.DOUBLE),
             ("max", 1, T.DOUBLE), ("min", 0, T.LONG), ("max", 3, T.INT),
             ("min", 2, T.BOOLEAN), ("first", 0, T.LONG),
             ("last", 1, T.DOUBLE), ("first_nn", 3, T.INT),
             ("last_nn", 1, T.DOUBLE), ("any", 2, T.BOOLEAN),
             ("every", 2, T.BOOLEAN)]
    specs = [G.AggSpec(k, i, t) for k, i, t in kinds]
    cap = 1 << 18
    inputs = _dense_inputs(np.random.default_rng(sum(sizes)), cap, sizes)
    outs = []
    for dev in ("cpu", cuda):
        keys, kvalid, data, valid, live = [
            [torch.from_numpy(a).to(dev) for a in x]
            if isinstance(x, list) else torch.from_numpy(x).to(dev)
            for x in inputs]
        outs.append(G.dense_groupby_trace(list(sizes), specs, cap)(
            keys, kvalid, data, valid, live))
    (ck, co, cn), (gk, go, gn) = outs
    n = int(cn)
    assert int(gn) == n and n > 0
    for (a, av), (b, bv) in zip(ck, gk):
        assert torch.equal(av[:n], bv[:n].cpu())
        assert torch.equal(a[:n], b[:n].cpu())
    for (k, _i, _t), (a, av), (b, bv) in zip(kinds, co, go):
        b, bv = b[:n].cpu(), bv[:n].cpu()
        a, av = a[:n], av[:n]
        assert torch.equal(av, bv), k
        a = torch.where(av, a, torch.zeros_like(a))
        b = torch.where(bv, b, torch.zeros_like(b))
        if k == "sum" and a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=1e-12, atol=0,
                                       equal_nan=True, msg=k)
        elif a.is_floating_point():
            assert torch.equal(a.view(torch.int64) if a.dtype ==
                               torch.float64 else a,
                               b.view(torch.int64) if b.dtype ==
                               torch.float64 else b), k
        else:
            assert torch.equal(a, b), k


@pytest.mark.cuda
def test_sample_and_range_on_the_card_keep_the_cpus_rows(cuda):
    from spark_rapids_tpu_torch.exec import plan as P
    from spark_rapids_tpu_torch.session import TpuSession
    pos = torch.arange(0, 3 * 2 ** 31, 4097, dtype=torch.int64)
    for seed in (0, 7, -3):
        assert torch.equal(P.sample_hash_u32(pos.to(cuda), seed).cpu(),
                           P.sample_hash_u32(pos, seed))
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "65536"}
    for seed, frac in ((7, 0.01), (1, 0.3), (2, 1.0), (3, 0.0)):
        cpu, gpu = (TpuSession(conf, device=d).range(-100_000, 400_000)
                    .sample(frac, seed=seed).to_pydict()
                    for d in ("cpu", cuda))
        assert gpu == cpu, (seed, frac)
    assert TpuSession(conf, device=cuda).range(0, 1_000_000).sample(
        0.01, seed=7).count() == TpuSession(conf, device="cpu").range(
        0, 1_000_000).sample(0.01, seed=7).count()


def _edge_table():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    rng = np.random.default_rng(5)
    n = 50_000
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n)
    f[::17], f[1::17], f[2::17] = np.nan, np.inf, -np.inf
    f[3::17], f[4::17] = 0.0, -0.0
    g = rng.standard_normal(n) * 3.0
    g[::23] = 0.0
    longs = rng.integers(-2 ** 62, 2 ** 62, n)
    longs[:4] = [-2 ** 63, 2 ** 63 - 1, -1, 0]
    m = rng.integers(-9, 9, n)
    m[:4] = [-1, -1, 0, -2 ** 63]
    schema = T.StructType([T.StructField("f", T.DOUBLE),
                           T.StructField("g", T.DOUBLE),
                           T.StructField("l", T.LONG),
                           T.StructField("m", T.LONG),
                           T.StructField("d", T.DecimalType(9, 2))])
    return from_numpy({"f": (f, rng.random(n) > 0.05), "g": g, "l": longs,
                       "m": (m, rng.random(n) > 0.05),
                       "d": rng.integers(-10 ** 6, 10 ** 6, n)}, schema)


#: family -> (builder over E, col, T; ulps allowed against the CPU)
_CARD_FAMILIES = {
    "arithmetic": (lambda E, c, T: [
        E.IntegralDivide(c("l"), c("m")), E.Remainder(c("l"), c("m")),
        E.Remainder(c("f"), c("g")), E.UnaryMinus(c("l")), E.Abs(c("l")),
        E.Abs(c("f")), E.EqualNullSafe(c("f"), c("g")), E.IsNaN(c("f"))],
        0),
    "rounding": (lambda E, c, T: [
        E.Floor(c("f")), E.Ceil(c("f")), E.Floor(c("d")), E.Ceil(c("d")),
        E.Round(c("f"), 2), E.BRound(c("f"), 2), E.Round(c("f"), -1),
        E.Round(c("d"), 1), E.BRound(c("d"), 0), E.Round(c("d"), -2),
        E.Round(c("l"), -3), E.Rint(c("f")), E.Signum(c("f")),
        E.ToDegrees(c("f")), E.ToRadians(c("f"))], 0),
    "ordering": (lambda E, c, T: [
        E.Greatest(c("f"), c("g")), E.Least(c("f"), c("g"), E.Literal(0.0)),
        E.Greatest(c("l"), c("m")), E.WidthBucket(
            c("f"), E.Literal(-5.0), E.Literal(5.0), E.Literal(7))], 0),
    # the CPU's vectorized sqrt is within 1 ulp; the card's is exact
    "sqrt": (lambda E, c, T: [E.Sqrt(c("f")), E.Sqrt(c("d"))], 1),
    "transcendental": (lambda E, c, T: [
        getattr(E, n)(c("f")) for n in (
            "Exp", "Expm1", "Log", "Log10", "Log2", "Log1p", "Cbrt", "Sin",
            "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh",
            "Cot", "Sec", "Csc")] + [
        E.Pow(c("f"), c("g")), E.Atan2(c("f"), c("g")),
        E.Hypot(c("f"), c("g")), E.Log(c("d"))], 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(_CARD_FAMILIES))
def test_scalar_family_on_the_card_equals_cpu(cuda, family):
    """Each family's projection on the card against the port's CPU path
    on the same input: exact families bit for bit, the transcendental
    ones within 4 ulps (CUDA's libdevice and glibc round differently)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import TpuSession, col
    build, ulps = _CARD_FAMILIES[family]
    table = _edge_table()
    out = []
    for d in ("cpu", cuda):
        exprs = build(E, col, T)
        out.append(TpuSession(device=d).from_host(table).select(
            *[E.Alias(e, f"c{i}") for i, e in enumerate(exprs)]).collect())
    for a, b in zip(*[o.columns for o in out]):
        assert np.array_equal(a.valid_mask(), b.valid_mask())
        v = a.valid_mask()
        x, y = a.data[v], b.data[v]
        if x.dtype == np.float64:
            same = (x.view(np.int64) == y.view(np.int64)) | \
                (np.isnan(x) & np.isnan(y))
            if ulps:
                ok = ~same & np.isfinite(x) & np.isfinite(y) & \
                    (np.sign(x) == np.sign(y))
                dist = np.abs(x.view(np.int64) - y.view(np.int64))
                same |= ok & (dist <= ulps)
            assert same.all(), (family, x[~same][:5], y[~same][:5])
        else:
            assert np.array_equal(x, y), family


@pytest.mark.cuda
def test_statistics_on_the_card_equal_cpu(cuda):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.session import TpuSession, col
    tables = tpch.gen_tables(0.01, tables=("lineitem",))

    def q(d):
        q_, p, t = (col(c) for c in ("l_quantity", "l_extendedprice",
                                     "l_tax"))
        return (TpuSession(device=d).from_host(tables["lineitem"])
                .group_by("l_returnflag", "l_linestatus")
                .agg((A.VariancePop(q_), "vp"), (A.VarianceSamp(p), "vs"),
                     (A.StddevPop(t), "sp"), (A.StddevSamp(q_), "ss"),
                     (A.CovarPop(q_, p), "cp"), (A.CovarSamp(p, q_), "cs"),
                     (A.Corr(q_, p), "corr"))
                .sort("l_returnflag", "l_linestatus").to_pydict())
    cpu, gpu = q("cpu"), q(cuda)
    for k in cpu:
        if k.startswith("l_"):
            assert gpu[k] == cpu[k]
        else:
            np.testing.assert_allclose(gpu[k], cpu[k], rtol=1e-9, atol=0,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The device string functions (ops/strings.py, plan/strings.py)
# ---------------------------------------------------------------------------

#: ASCII letters, white space (Python's: \x1c-\x1f too) and one- to
#: four-byte characters whose case or length changes ('ß'.upper() is
#: 'SS', 'ﬆ'.upper() 'ST')
_STRING_ALPHABET = list("aAbZz %_\\\t\n\x1f") + [
    "é", "ß", "ﬆ", "\u0301", "ǅ", "日", "😀"]


def _string_dictionary(seed, n=3000, ascii_only=False):
    rng = np.random.default_rng(seed)
    alphabet = [c for c in _STRING_ALPHABET if c.isascii() or not ascii_only]
    words = {"", " ", "  x  ", "ß", "ﬆ"} if not ascii_only else {"", " "}
    for k in rng.integers(0, 10, n).tolist():
        words.add("".join(alphabet[i] for i in rng.integers(
            0, len(alphabet), k)))
    return np.array(sorted(words), str)


@pytest.mark.cuda
@pytest.mark.parametrize("ascii_only", [True, False], ids=["ascii", "utf8"])
@pytest.mark.parametrize("kind", ["upper", "lower", "trim", "ltrim", "rtrim"])
def test_device_string_transform_on_the_card_equals_cpu(cuda, kind,
                                                        ascii_only):
    from spark_rapids_tpu_torch.ops import strings as S
    d = _string_dictionary(21, ascii_only=ascii_only)
    fn = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
          "ltrim": str.lstrip, "rtrim": str.rstrip}[kind]
    out = {}
    for dev in ("cpu", cuda):
        words, remap = S.transform_dict_device(d, kind, (), dev)
        assert remap.device.type == torch.device(dev).type
        out[str(dev)] = (words.tolist(), remap.cpu().tolist())
        assert words[remap.cpu().numpy()].tolist() == [fn(s) for s in d]
    assert out["cpu"] == out[str(cuda)]


_CARD_LIKE = ["a%", "%z", "%ß%", "a", "%", "", "a%z", "%a%b%", "_", "a_%",
              r"%\%%", "%\\\\%", "%😀"]


@pytest.mark.cuda
@pytest.mark.parametrize("ascii_only", [True, False], ids=["ascii", "utf8"])
@pytest.mark.parametrize("pattern", _CARD_LIKE)
def test_like_mask_on_the_card_equals_cpu(cuda, pattern, ascii_only):
    import re
    from spark_rapids_tpu_torch.ops import strings as S
    from spark_rapids_tpu_torch.plan.strings import Like
    from spark_rapids_tpu_torch.session import col
    d = _string_dictionary(22, ascii_only=ascii_only)
    masks = [Like(col("s"), pattern).entry_mask(d, dev).cpu().tolist()
             for dev in ("cpu", cuda)]
    rx = re.compile(S.like_to_regex(pattern), re.DOTALL)
    assert masks[0] == masks[1] == [rx.fullmatch(s) is not None for s in d]


@pytest.mark.cuda
def test_string_edges_on_the_card_equal_cpu(cuda):
    """Every new string class, LIKE shape, ordering and cast
    (chip_smoke_strings.EDGE_CASES) on the card against the port's CPU
    path over the same rows, value for value."""
    import chip_smoke_strings as CS
    from spark_rapids_tpu_torch.session import TpuSession
    table = CS.edge_table(rows=1 << 14, entries=2048)
    card, cpu = (CS.edge_values(TpuSession(device=d), table).collect()
                 for d in (cuda, "cpu"))
    bad = [n for n, a, b in zip(card.names, card.columns, cpu.columns)
           if CS.column_digest(a) != CS.column_digest(b)]
    assert not bad


@pytest.mark.cuda
def test_device_transforms_on_the_card_equal_the_host_loop(cuda):
    # the device rewrite (transformDeviceMinUnique=1) against the host
    # loop, each on the card, over the edge dictionary
    import chip_smoke_strings as CS
    from spark_rapids_tpu_torch.session import TpuSession
    table = CS.edge_table(rows=1 << 14, entries=2048)
    names = ("upper", "lower", "trim", "ltrim", "rtrim", "substring")
    out = [CS.edge_values(TpuSession(conf, device=cuda), table, names)
           .collect() for conf in (
               {"spark.rapids.tpu.sql.string.transformDeviceMinUnique": "1"},
               None)]
    assert all(CS.column_digest(a) == CS.column_digest(b)
               for a, b in zip(out[0].columns, out[1].columns))


def _fallback_batch(n: int, seed: int):
    """A host batch with strings (many entries), nulls and doubles."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i % 997}" for i in range(n)], dtype=object)
    words[rng.random(n) < 0.05] = None
    schema = t.StructType([t.StructField("k", t.LONG),
                           t.StructField("x", t.DOUBLE),
                           t.StructField("s", t.STRING)])
    x = rng.standard_normal(n)
    x[::11] = np.nan
    return from_numpy({"k": rng.permutation(n).astype(np.int64),
                       "x": (x, rng.random(n) > 0.03), "s": words}, schema)


def _device_rows(db):
    from spark_rapids_tpu_torch.columnar.device import fetch_result_batch
    hb = fetch_result_batch(db)
    return [c.to_pylist() for c in hb.columns]


@pytest.mark.cuda
def test_host_to_device_of_a_cpu_operator_equals_to_device(cuda):
    # a CPU projection's output (a re-encoded string dictionary, nulls)
    # uploads in slices of sql.batchSizeRows, each equal to to_device of
    # the same rows
    from spark_rapids_tpu_torch.columnar.device import to_device
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.host_exec import (CpuProjectExec,
                                                      HostSourceExec,
                                                      HostToDeviceExec)
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.plan import strings as S
    from spark_rapids_tpu_torch.session import col
    hb = _fallback_batch(10_000, 5)
    conf = TpuConf({"spark.rapids.tpu.sql.batchSizeRows": "4096"})
    proj = CpuProjectExec([col("k"), col("x"), S.Upper(col("s"))],
                          ["k", "x", "u"], HostSourceExec(hb))
    ctx = ExecContext(conf, cuda)
    host_out = proj.collect(ExecContext(conf, cuda))
    d = host_out.column_by_name("u").dictionary
    assert bool(np.all(d[:-1] < d[1:]))
    batches = list(HostToDeviceExec(proj).execute(ctx))
    assert [int(b.num_rows) for b in batches] == [4096, 4096, 1808]
    for i, db in enumerate(batches):
        want = to_device(host_out.slice(i * 4096, int(db.num_rows)), conf,
                         device=cuda)
        assert np.array_equal(db.columns[2].dictionary,
                              host_out.columns[2].dictionary)
        assert repr(_device_rows(db)) == repr(_device_rows(want))
    assert ctx.metrics["h2d_rows"] == 10_000


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi",
                                 "left_anti", "full_outer"])
def test_device_to_host_of_a_join_equals_the_cpu_engine(cuda, how):
    # a join on the card under a CPU aggregate (DeviceToHostExec) equals
    # the whole plan on the CPU engine
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import TpuSession, col
    fact = _fallback_batch(20_000, 6)
    dim = _fallback_batch(3_000, 7).select(["k", "s"])

    def build(s):
        j = s.from_host(fact).join(s.from_host(dim).select(
            E.Alias(col("k"), "dk"), E.Alias(col("s"), "ds")), how=how,
            left_on=["k"], right_on=["dk"])
        key = "s"
        return j.group_by(key).agg(
            (A.CountDistinct(col("k")), "n"), (A.Sum(col("x")), "sx"),
            (A.Min(col("s")), "ms")).sort(key)
    q = build(TpuSession()).physical()
    assert "DeviceToHostExec" in q.physical_tree()
    assert q.meta.children[0].reasons       # the aggregate runs on the host
    got = q.collect().to_pydict()
    cpu = build(TpuSession({"spark.rapids.tpu.sql.enabled": "false"},
                           device="cpu")).collect().to_pydict()
    assert got.keys() == cpu.keys()
    for k in got:
        if k == "sx":
            assert np.allclose(np.array(got[k], float), np.array(cpu[k],
                               float), rtol=1e-12, equal_nan=True)
        else:
            assert got[k] == cpu[k]


def _wide_sum_batch(n: int, seed: int):
    """A DECIMAL(18,0) column at the int64 edges (values near +-10^18 and
    +-2^62, nulls) and three key columns: a small-range LONG (segagg), a
    6-entry string (dense with segagg off) and a DOUBLE (sorted)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    rng = np.random.default_rng(seed)
    edges = np.array([10 ** 18 - 1, -(10 ** 18 - 1), 2 ** 62, -2 ** 62,
                      1, -1, 0], np.int64)
    d = edges[rng.integers(0, len(edges), n)]
    valid = rng.random(n) > 0.05
    k = rng.integers(0, 9, n)
    words = np.array(["a", "b", "c", "d", "e", "f"])
    schema = T.StructType([T.StructField("d", T.DecimalType(18, 0)),
                           T.StructField("k", T.LONG),
                           T.StructField("s", T.STRING),
                           T.StructField("f", T.DOUBLE)])
    return from_numpy({"d": (d, valid), "k": k,
                       "s": words[rng.integers(0, 6, n)],
                       "f": rng.integers(0, 7, n) + 0.25}, schema)


@pytest.mark.cuda
@pytest.mark.parametrize("key,tier", [("k", "segagg"), ("s", "dense"),
                                      ("f", "sort"), (None, None)])
def test_wide_decimal_half_lane_sums_on_the_card(cuda, key, tier):
    # SUM and AVG of DECIMAL(18,0) are DECIMAL(28,0) / (22,4): two int64
    # half lanes a sum through seg_sums, the dense or the sorted tier on
    # the card, equal to the plain path on CPU tensors and to Python ints
    import decimal as pydec
    from spark_rapids_tpu_torch.exec import aggregate as AG
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.session import TpuSession, col
    hb = _wide_sum_batch(300_000, 11)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "65536"}
    if tier == "dense":
        conf["spark.rapids.tpu.sql.kernels.pallas.segagg"] = "OFF"

    def build(s):
        df = s.from_host(hb)
        aggs = [(A.Sum(col("d")), "sum"), (A.Average(col("d")), "avg")]
        return df.agg(*aggs) if key is None else \
            df.group_by(key).agg(*aggs).sort(key)
    AG.reset_groupby_tiers()
    PH.reset_launch_counts()
    got = build(TpuSession(conf)).collect().to_pydict()
    if tier == "segagg":
        assert PH.LAUNCHES["seg_sums"] > 0
    if tier is not None:
        assert AG.GROUPBY_TIERS[tier] > 0
    plain = build(TpuSession(conf, device="cpu")).collect().to_pydict()
    assert got == plain
    d = hb.column_by_name("d")
    keys = [None] * hb.num_rows if key is None else \
        hb.column_by_name(key).to_pylist()
    sums, counts = {}, {}
    for kk, v, ok in zip(keys, d.data.tolist(), d.valid_mask().tolist()):
        if ok:
            sums[kk] = sums.get(kk, 0) + v
            counts[kk] = counts.get(kk, 0) + 1
    order = sorted(sums, key=lambda x: (x is not None, x))
    assert got["sum"] == [pydec.Decimal(sums[kk]) for kk in order]
    assert any(abs(sums[kk]) >= 2 ** 63 for kk in order)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["join", "compact"])
@pytest.mark.parametrize("query", ["q3", "m2m", "outer", "semi"])
def test_kernel_off_tiers_on_the_card_equal_the_kernel_path(cuda, family,
                                                            query):
    """The sorted join tier and the argsort compaction on the card: with
    the family off each query equals the kernel path's result and
    launches none of that family's kernels."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.session import TpuSession
    tables = tpch.gen_tables(0.001, tables=("customer", "orders",
                                            "lineitem", "partsupp"))
    build = tpch.JOIN_QUERIES.get(query) or tpch.QUERIES[query]
    want = build(TpuSession(device="cuda"), tables).to_pydict()
    PH.reset_launch_counts()
    off = TpuSession({f"spark.rapids.tpu.sql.kernels.pallas.{family}":
                      "OFF"}, device="cuda")
    got = build(off, tables).to_pydict()
    assert got == want
    family_kernels = {"join": ("build_table", "probe_first", "probe_counts",
                               "expand_pairs"),
                      "compact": ("compaction_order",)}[family]
    for kernel in family_kernels:
        assert PH.LAUNCHES[kernel] == 0, kernel


@pytest.mark.cuda
def test_sorted_tier_pairs_on_the_card_equal_the_hash_table(cuda):
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        DeviceColumn)
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import join as PJ
    rng = np.random.default_rng(12)
    cap, pcap = 1 << 16, 1 << 18
    bk = torch.from_numpy(rng.integers(0, 20_000, cap)).to(cuda)
    bvalid = torch.from_numpy(rng.random(cap) < 0.9).to(cuda)
    pk = torch.from_numpy(rng.integers(-100, 20_100, pcap)).to(cuda)
    pvalid = torch.from_numpy(rng.random(pcap) < 0.95).to(cuda)
    col = DeviceColumn(bk, bvalid, None, None)
    out = []
    for tier in (PH.kernel_tier(TpuConf()), None):
        bt = PJ.BuildTable(DeviceBatch([col], cap, ["k"]), [col],
                           hash_tier=tier)
        first, counts, cum, total = PJ.probe_counts(bt, [pk], pvalid)
        p, b, ok, pm = PJ.expand_pairs(bt, [pk], pvalid, first, counts, cum,
                                       total + 1, total)
        out.append((p[ok].cpu(), b[ok].cpu(), pm.cpu(),
                    PJ.build_matched(bt, first, counts).cpu(),
                    PJ.probe_matched_lazy(bt, [pk], pvalid).cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_argsort_compaction_on_the_card_equals_the_kernel(cuda):
    from spark_rapids_tpu_torch.ops import filter as PF
    rng = np.random.default_rng(13)
    for cap, p in ((1 << 20, 0.3), (1023, 0.5), (4096, 1.0), (5000, 0.0)):
        keep = torch.from_numpy(rng.random(cap) < p).to(cuda)
        order, count = PF.compaction_order(keep)
        korder, kcount = PC.compaction_order(keep)
        n = int(kcount)
        assert int(count) == n
        assert torch.equal(order[:n].to(torch.int32), korder[:n])


# ---------------------------------------------------------------------------
# the join tiers, the bloom filter and the Spark hashes: CUDA tensors
# against CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_hash_lanes_on_the_card_equal_the_cpu(cuda):
    from spark_rapids_tpu_torch.ops import hashing as H
    rng = np.random.default_rng(21)
    n = 1 << 20
    x = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n))
    s32 = torch.from_numpy(rng.integers(0, 2 ** 32, n))
    s64 = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n))
    for fn, seed in ((H.hash_int32, s32), (H.hash_int64, s32),
                     (H.xxhash64_int_lane, s64), (H.xxhash64_long_lane, s64)):
        assert torch.equal(fn(x.to(cuda), seed.to(cuda)).cpu(), fn(x, seed))
    d = np.array(["", "a", "abcd", "héllo", "x" * 33, "y" * 70], str)
    tabs = H.StringTables(d)
    codes = torch.from_numpy(rng.integers(0, len(d), n))
    for fn, seed in ((H.murmur3_strings, s32), (H.xxhash64_strings, s64)):
        assert torch.equal(
            fn(codes.to(cuda), seed.to(cuda), tabs.to(cuda)).cpu(),
            fn(codes, seed, tabs.to("cpu")))
    f = torch.from_numpy(rng.standard_normal(n))
    f[:4] = torch.tensor([float("nan"), -0.0, 0.0, float("inf")])
    assert torch.equal(H.double_bits(f.to(cuda)).cpu(), H.double_bits(f))


def _session_pair(cuda, conf=None):
    from spark_rapids_tpu_torch.session import TpuSession
    return (TpuSession(dict(conf or {}), device=cuda),
            TpuSession(dict(conf or {}), device="cpu"))


@pytest.mark.cuda
def test_spark_hash_expressions_on_the_card_equal_the_cpu(cuda):
    import pyarrow as pa
    from spark_rapids_tpu_torch.plan import expressions as PE
    from spark_rapids_tpu_torch.session import col
    rng = np.random.default_rng(22)
    n = 100_000
    t = pa.table({
        "i": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "l": pa.array(rng.integers(-2 ** 63, 2 ** 63 - 1, n)),
        "d": pa.array(np.where(rng.random(n) < 0.05, -0.0,
                               rng.standard_normal(n))),
        "s": pa.array(rng.choice(["", "AIR", "REG AIR", "x" * 40], n),
                      mask=rng.random(n) < 0.1)})
    exprs = [PE.Alias(PE.Murmur3Hash(col("i"), col("s"), col("d")), "m"),
             PE.Alias(PE.XxHash64(col("s"), col("l"), col("i")), "x")]
    card, cpu = _session_pair(cuda)
    got = card.from_arrow(t).select(*exprs).to_pydict()
    assert got == cpu.from_arrow(t).select(*exprs).to_pydict()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ON", "AUTO", "OFF"])
@pytest.mark.parametrize("how", ["inner", "right_outer", "full_outer",
                                 "left_semi", "left_anti"])
def test_join_tiers_on_the_card_equal_the_cpu(cuda, mode, how):
    """Composite keys (two strings, a string and an integer) on the
    multi-lane sorted tier and a single key on the dense or hash tier,
    on the card against the CPU path."""
    import pyarrow as pa
    rng = np.random.default_rng(23)
    n, nb = 200_000, 30_000
    probe = pa.table({"a": pa.array(rng.choice(["p", "q", "r", "s"], n)),
                      "b": pa.array(rng.integers(0, 9000, n),
                                    mask=rng.random(n) < 0.05),
                      "x": pa.array(np.arange(n))})
    build = pa.table({"a2": pa.array(rng.choice(["p", "q", "zz"], nb)),
                      "b2": pa.array(rng.integers(0, 8000, nb)),
                      "y": pa.array(np.arange(nb))})
    conf = {"spark.rapids.tpu.sql.kernels.pallas.join.denseReplace": mode}
    card, cpu = _session_pair(cuda, conf)
    for keys in ((["a", "b"], ["a2", "b2"]), (["b"], ["b2"])):
        def q(s):
            return s.from_arrow(probe).join(s.from_arrow(build), how=how,
                                            left_on=keys[0],
                                            right_on=keys[1]).to_pydict()
        assert q(card) == q(cpu), keys


@pytest.mark.cuda
def test_dense_tables_and_bloom_on_the_card_equal_the_cpu(cuda):
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        DeviceColumn)
    from spark_rapids_tpu_torch.ops import bloom as PB
    from spark_rapids_tpu_torch.ops import join as PJ
    rng = np.random.default_rng(24)
    cap, pcap = 1 << 16, 1 << 18
    bk = torch.from_numpy(rng.integers(0, 1 << 20, cap))
    bvalid = torch.from_numpy(rng.random(cap) < 0.9)
    pk = torch.from_numpy(rng.integers(-100, (1 << 20) + 100, pcap))
    pvalid = torch.from_numpy(rng.random(pcap) < 0.95)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        col = DeviceColumn(bk.to(dev), bvalid.to(dev), None, None)
        res = []
        for via_sort in (True, False):
            for via_merge in (True, False):
                bt = PJ.BuildTable(DeviceBatch([col], cap, ["k"]), [col],
                                   domain=(0, (1 << 20) - 1),
                                   dense_via_sort=via_sort,
                                   matched_via_merge=via_merge)
                lanes, pv = [pk.to(dev)], pvalid.to(dev)
                first, counts, cum, total = PJ.probe_counts(bt, lanes, pv)
                p, b, ok, pm = PJ.expand_pairs(bt, lanes, pv, first, counts,
                                               cum, total + 1, total)
                res += [bt.offs, bt.present, p[ok], b[ok], pm,
                        PJ.build_matched(bt, first, counts, b, ok),
                        PJ.probe_matched_lazy(bt, lanes, pv)]
        m = PB.optimal_slots(cap)
        k = PB.optimal_hashes(cap, m)
        bits = PB.bloom_build([col], DeviceBatch([col], cap, ["k"]), m, k)
        pcol = DeviceColumn(pk.to(dev), pvalid.to(dev), None, None)
        res += [bits, PB.bloom_might_contain(
            bits, [pcol], DeviceBatch([pcol], pcap, ["k"]), k)]
        out[dev.type] = [r.cpu() for r in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("zone", ["UTC", "America/Los_Angeles",
                                  "Australia/Lord_Howe"])
def test_session_timezone_fields_on_the_card_equal_the_cpu(cuda, zone):
    import pyarrow as pa
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import datetime as DT
    from spark_rapids_tpu_torch.plan import expressions as PE
    from spark_rapids_tpu_torch.session import col
    rng = np.random.default_rng(25)
    n = 1 << 18
    days = rng.integers(7000, 11000, n)
    us = days * 86_400_000_000 + rng.integers(0, 86_400_000_000, n)
    t = pa.table({"ts": pa.array(us).cast(pa.timestamp("us", tz="UTC")),
                  "d": pa.array(days.astype(np.int32)).cast(pa.date32())})
    exprs = [PE.Alias(DT.Hour(col("ts")), "h"),
             PE.Alias(DT.Minute(col("ts")), "mi"),
             PE.Alias(DT.DayOfMonth(col("ts")), "dd"),
             PE.Alias(PE.Cast(col("ts"), T.DATE), "td"),
             PE.Alias(PE.Cast(col("d"), T.TIMESTAMP), "dt"),
             PE.Alias(DT.ToUnixTimestamp(col("d")), "u"),
             PE.Alias(DT.AddMonths(col("d"), 7), "am"),
             PE.Alias(DT.TruncDate(col("d"), "quarter"), "tq")]
    card, cpu = _session_pair(cuda, {"spark.sql.session.timeZone": zone})
    assert card.from_arrow(t).select(*exprs).to_pydict() == \
        cpu.from_arrow(t).select(*exprs).to_pydict()


def _thin_batch(dev, rng, cap=1 << 16, src_cap=1 << 14):
    """A thin batch on `dev`: one materialized column and three deferred
    ones (int64, a string's codes, a two-lane decimal) behind an int32
    row-id lane with -1 (null-extended) rows, and a selection vector."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import lanes as L
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        DeviceColumn)
    src_rows = src_cap - 77
    srcv = torch.from_numpy(rng.random(src_cap) < 0.9)
    src = DeviceBatch([
        DeviceColumn(torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62,
                                                   src_cap)).to(dev),
                     srcv.to(dev), T.LONG),
        DeviceColumn(torch.from_numpy(rng.integers(0, 5, src_cap)
                                      .astype(np.int32)).to(dev),
                     srcv.to(dev), T.STRING,
                     np.array(["a", "b", "c", "d", "e"], str)),
        DeviceColumn(torch.from_numpy(rng.integers(-9, 9, src_cap)).to(dev),
                     srcv.to(dev), T.DecimalType(38, 2), None, None,
                     torch.from_numpy(rng.integers(-3, 3, src_cap)).to(dev))],
        src_rows, ["v", "s", "w"])
    lane = rng.integers(-1, src_cap + 10, cap).astype(np.int32)
    mat = DeviceColumn(torch.from_numpy(np.arange(cap)).to(dev),
                       torch.ones(cap, dtype=torch.bool, device=dev),
                       T.LONG)
    sel = torch.from_numpy(rng.random(cap) < 0.6).to(dev)
    thin = L.ThinState(cap, [L.LaneSource(src, torch.from_numpy(lane)
                                          .to(dev))],
                       {1: (0, 0), 2: (0, 1), 3: (0, 2)})
    cols = [mat] + [L.deferred_column(c) for c in src.columns]
    return DeviceBatch(cols, sel.sum(dtype=torch.int32), ["m", "v", "s", "w"],
                       sel, thin), src


def _columns_cpu(db):
    return [(c.data.cpu(), c.validity.cpu(),
             None if c.hi is None else c.hi.cpu()) for c in db.columns]


@pytest.mark.cuda
def test_compact_thin_and_gather_deferred_on_the_card_equal_the_cpu(cuda):
    """columnar/lanes.compact_thin (its order from the compaction kernel
    on the card) and gather_deferred on CUDA tensors against CPU
    tensors."""
    from spark_rapids_tpu_torch.columnar import lanes as L
    out = []
    for dev in (cuda, torch.device("cpu")):
        db, _src = _thin_batch(dev, np.random.default_rng(41))
        compacted = L.compact_thin(db, db.sel)
        gathered = L.gather_deferred(db.thin.sources[0], [0, 1, 2],
                                     db.sel)
        out.append((int(compacted.num_rows), _columns_cpu(compacted),
                    [(c.data.cpu(), c.validity.cpu(),
                      None if c.hi is None else c.hi.cpu())
                     for c in gathered]))
    assert out[0][0] == out[1][0] > 0
    for part in (1, 2):
        for a, b in zip(out[0][part], out[1][part]):
            valid = b[1]
            assert torch.equal(a[1], valid)
            assert torch.equal(a[0][valid], b[0][valid])
            if b[2] is not None:
                assert torch.equal(a[2][valid], b[2][valid])


@pytest.mark.cuda
@pytest.mark.parametrize("narrow", ["int8", "int16", "int32"])
def test_narrow_compare_on_the_card_equals_the_cpu(cuda, narrow):
    from spark_rapids_tpu_torch.ops.encodings import narrow_compare
    rng = np.random.default_rng(42)
    info = np.iinfo(narrow)
    n = 1 << 18
    lane = rng.integers(info.min, info.max, n, dtype=narrow, endpoint=True)
    lane[:4] = [info.min, info.max, 0, -1]
    wide = rng.integers(-2 ** 40, 2 ** 40, n)
    wide[::3] = lane[::3]
    wide[1::7] = info.max + 1
    wide[2::7] = info.min - 1
    for sym in ("=", "!=", "<", "<=", ">", ">="):
        got = narrow_compare(sym, torch.from_numpy(lane).to(cuda),
                             torch.from_numpy(wide).to(cuda)).cpu()
        want = narrow_compare(sym, torch.from_numpy(lane),
                              torch.from_numpy(wide))
        exact = {"=": np.equal, "!=": np.not_equal, "<": np.less,
                 "<=": np.less_equal, ">": np.greater,
                 ">=": np.greater_equal}[sym](lane.astype(np.int64), wide)
        assert torch.equal(got, want) and np.array_equal(want.numpy(),
                                                         exact), sym


@pytest.mark.cuda
def test_narrow_upload_on_the_card_equals_the_cpu(cuda):
    """A FOR-narrowed scan lane uploads at its narrow dtype on the card,
    widens exactly, and a query over narrowed lanes equals the CPU's."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import device as D
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    from spark_rapids_tpu_torch.plan import expressions as PE
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.session import col
    rng = np.random.default_rng(43)
    n = 300_000
    x = rng.integers(-128, 128, n)
    y = rng.integers(-40_000, 40_000, n)
    d = rng.integers(8000, 11000, n).astype(np.int32)
    hb = HostBatch([HostColumn(x, None, T.LONG), HostColumn(y, None, T.LONG),
                    HostColumn(d, None, T.DATE)], ["x", "y", "d"])
    lanes = {i: D.narrowed_lane(hb, name, 0, n)
             for i, name in enumerate(hb.names)}
    assert [lanes[i][0].dtype for i in range(3)] == \
        [np.int8, np.int32, np.int16]
    card = D.to_device(hb, device=cuda, narrowed=lanes)
    cpu = D.to_device(hb, device="cpu", narrowed=lanes)
    for a, b in zip(card.columns, cpu.columns):
        assert a.lane.dtype == b.lane.dtype
        assert torch.equal(a.lane.cpu(), b.lane) and \
            torch.equal(a.data.cpu(), b.data)
    card_s, cpu_s = _session_pair(cuda)

    def q(s):
        return (s.from_host(hb)
                .filter(PE.And(PE.LessThan(col("x"), PE.Literal(300)),
                               PE.GreaterThan(col("y"), PE.Literal(-1000))))
                .select(col("d"), PE.Alias(PE.Multiply(col("x"), col("x")),
                                           "xx"), names=["d", "xx"])
                .group_by("d").agg((Sum(col("xx")), "s"),
                                   (Count(None), "n"))
                .sort("d").to_pydict())
    assert q(card_s) == q(cpu_s)


def _graph_replays(cuda, fn, plain, variants):
    """Capture fn over static copies of variants[0], then replay it with
    each variant copied into the static buffers: every replay equals
    plain(*variant)."""
    static = [x.clone() for x in variants[0]]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream(cuda).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with PH.capture_scratch(cuda) as scratch:
        with torch.cuda.graph(g, stream=side):
            out = fn(*static)
    assert scratch[0] is not None          # the graph's own scratch
    for v in variants:
        for s, x in zip(static, v):
            s.copy_(x)
        g.replay()
        for a, b in zip(out, plain(*v)):
            assert torch.equal(a, b)
    g.reset()


@pytest.mark.cuda
def test_lookback_kernels_replayed_from_a_graph_equal_plain(cuda):
    """The three look-back kernels (compaction_order, build_table's
    layout, probe_counts) replayed 3 times from one graph with new
    inputs: the graph's scratch is zeroed by its own captured fills, so
    no replay reads the previous one's status words as ready."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n = 3_000_017
    keeps = [torch.rand(n, generator=g, device=cuda) < p
             for p in (0.5, 0.01, 0.99)]
    _graph_replays(cuda, lambda k: PC.compaction_order(k),
                   lambda k: PC.compaction_order_plain(k),
                   [[k] for k in keeps])
    cap = 1 << 20
    nbits, span = PHJ.table_geometry(cap)
    builds = []
    for hi in (1 << 40, 1000, 1 << 20):
        lane = torch.randint(0, hi, (cap,), generator=g, device=cuda)
        builds.append([lane, torch.rand(cap, generator=g, device=cuda) < .9])
    _graph_replays(
        cuda, lambda ln, vl: [PHJ.build_table(ln, vl).slots],
        lambda ln, vl: [PHJ.build_layout_plain(*PHJ.hash_order(ln, vl, nbits),
                                               span)], builds)
    table = PHJ.build_table(builds[1][0], builds[1][1])
    probes = [[torch.randint(0, 1200, (cap,), generator=g, device=cuda),
               torch.rand(cap, generator=g, device=cuda) < p]
              for p in (0.5, 0.1, 1.0)]

    def counts_plain(p, v):
        first, counts = PHJ.probe_counts_plain(table, p, v)
        return [first, counts, PHJ.inclusive_cumsum(counts)]
    _graph_replays(cuda, lambda p, v: list(PHJ.probe_counts(table, p, v)),
                   counts_plain, probes)


@pytest.mark.cuda
def test_q6_captured_and_replayed_with_two_literal_sets(cuda):
    """q6 and a literal variant share one captured graph; each replay
    equals the eager engine."""
    import datetime as pydt
    import chip_smoke_capture as CAP
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.exec import compiled as CC
    from spark_rapids_tpu_torch.session import TpuSession
    tables = tpch.gen_tables(0.01)
    on = TpuSession({"spark.rapids.tpu.sql.compile.wholePlan": "ON"})
    off = TpuSession({"spark.rapids.tpu.sql.compile.wholePlan": "OFF"})
    CC.clear_caches()
    progs = []
    try:
        for lits in ((pydt.date(1994, 1, 1), pydt.date(1995, 1, 1), "0.05",
                      "0.07", "24"), CAP.Q6_VARIANT):
            build = CAP.q6_with(*lits)
            q = build(on, tables).physical()
            got = q.collect().to_pydict()
            assert CC.decision(q) == "whole"
            progs += CC.plan_programs(q)
            assert got == build(off, tables).to_pydict()
            assert q.collect().to_pydict() == got          # a replay
        assert progs[0] is progs[1] and progs[0].graph is not None
    finally:
        CC.clear_caches()


@pytest.mark.cuda
def test_captured_and_eager_queries_run_on_two_threads_at_once(cuda):
    """A capture changes no setting of the process: while one thread
    warms up and captures q1, q6 and q3 (each collect after a cleared
    cache), another runs them eager, reading row counts on the host.
    Neither fails or falls back, and each answers as the eager engine
    does alone."""
    import threading
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.exec import compiled as CC
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.session import TpuSession
    tables = tpch.gen_tables(0.01)
    on = TpuSession({"spark.rapids.tpu.sql.compile.wholePlan": "ON"})
    off = TpuSession({"spark.rapids.tpu.sql.compile.wholePlan": "OFF"})
    names = ("q1", "q6", "q3")
    want = {n: getattr(tpch, n)(off, tables).to_pydict() for n in names}
    errors, results = [], []
    start = threading.Barrier(2)

    def worker(mode, session, order):
        try:
            start.wait()
            for _ in range(3):
                for n in order:
                    if mode == "on":
                        CC.clear_caches()        # each collect captures
                    q = getattr(tpch, n)(session, tables).physical()
                    ctx = ExecContext(q.conf, q.device)
                    results.append((mode, n, q.collect(ctx).to_pydict(),
                                    ctx))
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=a) for a in (
        ("on", on, names), ("off", off, names[::-1]))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        CC.clear_caches()
    assert not errors, errors
    assert len(results) == 18
    for mode, n, got, ctx in results:
        assert got.keys() == want[n].keys(), n
        for k in got:
            if got[k] and isinstance(got[k][0], float):
                np.testing.assert_allclose(got[k], want[n][k], rtol=1e-9,
                                           err_msg=f"{mode} {n} {k}")
            else:
                assert got[k] == want[n][k], (mode, n, k)
        if mode == "on":
            assert ctx.metrics.get("whole_plan_compiled_queries") == 1, n
        else:
            assert not ctx.metrics.get("whole_plan_fallbacks"), n


def _ragged_table(rng, n: int = 6000):
    """Per-row integer lists with null rows and null elements, a string
    column and group keys (numpy, no pyarrow)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import host as H
    lists = []
    for _ in range(n):
        if rng.random() < 0.05:
            lists.append(None)
        else:
            lists.append([None if rng.random() < 0.1 else
                          int(rng.integers(-100, 100))
                          for _ in range(rng.integers(0, 9))])
    x = rng.standard_normal(n)
    x[rng.random(n) < 0.05] = np.nan
    schema = T.StructType([T.StructField("id", T.LONG),
                           T.StructField("a", T.ArrayType(T.LONG)),
                           T.StructField("k", T.LONG),
                           T.StructField("s", T.STRING),
                           T.StructField("x", T.DOUBLE)])
    return H.from_numpy({
        "id": np.arange(n), "a": lists, "k": rng.integers(0, 37, n),
        "s": np.array(["AIR", "MAIL", "SHIP", "RAIL"])[
            rng.integers(0, 4, n)],
        "x": (x, rng.random(n) > 0.03)}, schema)


def _both(cuda, build, table, conf=None):
    """(card, CPU) results of one DataFrame function."""
    from spark_rapids_tpu_torch.session import TpuSession
    got = build(TpuSession(conf, device=cuda), table).to_pydict()
    want = build(TpuSession(conf, device="cpu"), table).to_pydict()
    return got, want


def _nan_eq(a, b) -> bool:
    def canon(v):
        if isinstance(v, float) and v != v:
            return "nan"
        if isinstance(v, list):
            return [canon(x) for x in v]
        return v
    return {k: [canon(v) for v in vs] for k, vs in a.items()} == \
        {k: [canon(v) for v in vs] for k, vs in b.items()}


@pytest.mark.cuda
def test_ragged_upload_fetch_and_expressions_on_the_card_equal_the_cpu(
        cuda):
    from spark_rapids_tpu_torch.columnar import device as D
    from spark_rapids_tpu_torch.plan import collections as C
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    hb = _ragged_table(np.random.default_rng(31))
    db = D.to_device(hb.select(["id", "a"]), device=cuda)
    assert db.column_by_name("a").offsets.device.type == cuda.type
    assert D.fetch_result_batch(db).to_pydict() == \
        hb.select(["id", "a"]).to_pydict()
    x = C.LambdaVar("x")

    def build(s, t):
        a = col("a")
        return s.from_host(t).select(
            col("id"), C.Size(a), C.GetArrayItem(a, 2),
            C.ArrayContains(a, 7), C.ArrayMin(a), C.ArrayMax(a),
            C.SortArray(a), C.SortArray(a, False), C.ElementAt(a, -1),
            C.ArrayPosition(a, 5), C.Slice(a, 2, 3), C.ReverseArray(a),
            C.ArrayTransform(a, E.Multiply(x, E.Literal(3)), "x"),
            C.ArrayFilter(a, E.GreaterThan(x, E.Literal(0)), "x"),
            C.ArrayExists(a, E.GreaterThan(x, E.Literal(90)), "x"),
            C.ArrayForAll(a, E.GreaterThan(x, E.Literal(-90)), "x"),
            names=["id", "n", "i2", "c7", "mn", "mx", "sa", "sd", "last",
                   "p5", "sl", "rev", "t", "f", "e", "fa"])
    got, want = _both(cuda, build, hb.select(["id", "a"]))
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("pos,outer", [(False, False), (True, True)])
def test_explode_on_the_card_equals_the_cpu(cuda, pos, outer):
    from spark_rapids_tpu_torch.plan import collections as C
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.session import DataFrame
    hb = _ragged_table(np.random.default_rng(32)).select(["id", "a"])

    def build(s, t):
        names = ["pos", "v"] if pos else ["v"]
        gen = L.LogicalGenerate(C.ExplodeGen(E.ColumnRef("a"), pos=pos,
                                             outer=outer),
                                L.LogicalScan(t), names)
        proj = L.LogicalProject([E.ColumnRef(n) for n in ["id"] + names],
                                gen, ["id"] + names)
        return DataFrame(proj, s)
    got, want = _both(cuda, build, hb)
    key = lambda r: repr(r)                       # noqa: E731
    assert sorted(zip(*got.values()), key=key) == \
        sorted(zip(*want.values()), key=key)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["4194304", "1024"])
def test_collect_and_percentile_on_the_card_equal_the_cpu(cuda, batch):
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.session import col
    hb = _ragged_table(np.random.default_rng(33))
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch}

    def collect(s, t):
        return s.from_host(t).group_by("k").agg(
            (A.CollectList(col("id")), "l"), (A.CollectSet(col("s")), "st"),
            (A.CollectSet(col("x")), "sx")).sort("k")

    def pct(s, t):
        return s.from_host(t).group_by("s").agg(
            (A.Percentile(col("x"), 0.3), "p"), (A.Median(col("k")), "m"),
            (A.Percentile(col("x"), 1.0), "mx")).sort("s")

    def approx(s, t):
        return s.from_host(t).group_by("s").agg(
            (A.ApproximatePercentile(col("x"), 0.5), "a"),
            (A.ApproximatePercentile(col("k"), 0.9), "b")).sort("s")
    for build in (collect, pct, approx):
        got, want = _both(cuda, build, hb, conf)
        assert _nan_eq(got, want), build.__name__


def _p_name_like(rng, n):
    """A sorted, duplicate-free dictionary of TPC-H p_name-like entries
    (five colour words), with a few non-ASCII and empty entries."""
    words = ["almond", "antique", "green", "forest", "navy", "smoke",
             "spring", "thistle", "lace", "ghost", "frosted", "日本"]
    vals = [" ".join(rng.choice(words, 5)) for _ in range(n)] + ["", "x"]
    return np.unique(np.array(vals, str))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [r"green", r"special.*requests",
                                     r"^forest", r"(lace|ghost)$", r"日本"])
def test_the_dfa_runner_on_the_card_equals_the_cpu(cuda, pattern):
    from spark_rapids_tpu_torch.ops import regex as R
    from spark_rapids_tpu_torch.ops import strings as S
    d = _p_name_like(np.random.default_rng(41), 50_000)
    dfa = R.compile_dfa(pattern)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        offsets, bytes_ = S.dict_byte_tensors(d, dev)
        order = R.entry_order(R.utf8_lengths(d), dev)
        outs.append(R.dfa_matches_lanes(
            torch.from_numpy(dfa.table.T.astype(np.int16).copy()).to(dev),
            torch.from_numpy(dfa.accepting.copy()).to(dev), offsets,
            bytes_, order).cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    import re
    want = np.array([re.search(pattern, v) is not None for v in d.tolist()])
    np.testing.assert_array_equal(outs[0], want)


def _nested_table(rng, n=20_000):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import host as H
    k = H.HostColumn(np.arange(n, dtype=np.int64), None, T.LONG)
    a = H.HostColumn(rng.integers(0, 9, n).astype(np.int32),
                     rng.random(n) > 0.1, T.INT)
    st = H.struct_column([a, H.string_column(rng.choice(["p", "q", "r"],
                                                        n))],
                         ["a", "c"], rng.random(n) > 0.09)
    lens = rng.integers(0, 5, n)
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.cumsum(lens)
    keys = H.HostColumn((np.arange(off[-1]) - np.repeat(off[:-1], lens))
                        .astype(np.int32), None, T.INT)
    vals = H.HostColumn(rng.integers(0, 1000, int(off[-1])), None, T.LONG)
    mp = H.map_column(keys, vals, off, rng.random(n) > 0.07)
    return H.HostBatch([k, st, mp], ["id", "s", "m"])


@pytest.mark.cuda
def test_shattered_map_element_at_on_the_card_equals_the_cpu(cuda):
    from spark_rapids_tpu_torch.plan import collections as C
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    hb = _nested_table(np.random.default_rng(42))

    def build(s, t):
        return s.from_host(t).select(
            col("id"), C.MapElementAt(col("m"), 1), C.Size(col("m")),
            C.MapKeys(col("m")), C.MapElementAt(col("m"), 2),
            names=["id", "v", "n", "ks", "v2"])
    from spark_rapids_tpu_torch.session import TpuSession
    q = build(TpuSession(device=cuda), hb).physical()
    assert q.kind == "device" and "cannot" not in q.explain()
    got, want = _both(cuda, build, hb)
    assert got == want


@pytest.mark.cuda
def test_a_struct_round_trips_through_upload_and_renest_on_the_card(cuda):
    from spark_rapids_tpu_torch.plan import collections as C
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    hb = _nested_table(np.random.default_rng(43))

    def build(s, t):
        return s.from_host(t).filter(E.LessThan(
            C.GetStructField(col("s"), "a"), E.Literal(5))).sort("id")
    got, want = _both(cuda, build, hb)
    assert got == want
    assert got["s"] == [v for v, a in zip(hb.to_pydict()["s"],
                                          hb.to_pydict()["s"])
                        if v is not None and v["a"] is not None and
                        v["a"] < 5]


def _udf_table(rng, n=100_003):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import host as H
    valid = rng.random(n) > 0.05
    return H.HostBatch([
        H.HostColumn(rng.integers(-1000, 1000, n), valid, T.LONG),
        H.HostColumn(rng.standard_normal(n) * 100, None, T.DOUBLE),
        H.HostColumn(rng.integers(1, 50_000, n).astype(np.int64), None,
                     T.DecimalType(12, 2))], ["a", "b", "p"])


class _Cube:
    """A hive UDF with a columnar form (TpuHiveUDF) and its row form."""

    def evaluate(self, x):
        return None if x is None else x * x * x

    def evaluate_columnar(self, x):
        return x * x * x


@pytest.mark.cuda
def test_udfs_on_the_card_equal_the_cpu_engine(cuda):
    """A compiled UDF, a TpuUDF and a TpuHiveUDF on CUDA tensors, each
    equal to the CPU engine's answer (`sql.enabled=false`: the compiled
    tree's numpy form, the TpuUDF over CPU tensors, the hive UDF's row
    form)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.hive_udf import (HiveSimpleUDF,
                                                      TpuHiveUDF)
    from spark_rapids_tpu_torch.plan.udf import TpuUDF
    from spark_rapids_tpu_torch.plan.udf_compiler import compile_udf
    from spark_rapids_tpu_torch.session import TpuSession, col

    class Cube(_Cube, TpuHiveUDF):
        pass
    hb = _udf_table(np.random.default_rng(7))

    def build(s, t):
        df = s.from_host(t)
        return df.select(
            compile_udf(lambda a, b: a * (1 - b) if b > 0.0 else -b,
                        [col("a"), col("b")], df.schema),
            compile_udf(lambda p: p * (1 - p), [col("p")], df.schema),
            TpuUDF(lambda a, b: a * 2 + b, T.DOUBLE, col("a"), col("b")),
            HiveSimpleUDF(Cube(), T.LONG, col("a")),
            names=["c", "cp", "t", "h"])
    q = build(TpuSession(device=cuda), hb).physical()
    assert q.kind == "device" and "cannot" not in q.explain()
    got = build(TpuSession(device=cuda), hb).to_pydict()
    want = build(TpuSession({"spark.rapids.tpu.sql.enabled": "false"},
                            device="cpu"), hb).to_pydict()
    assert got == want


@pytest.mark.cuda
def test_a_tpu_udf_captured_into_a_graph_replays_new_inputs(cuda):
    """The TpuUDF's ops recorded into one CUDA graph over static input
    lanes, replayed 3 times with new data copied in, each equal to the
    function run eagerly; and a TpuUDF query under wholePlan=ON
    captures whole and equals the eager answer."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec import compiled as CC
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    from spark_rapids_tpu_torch.plan.udf import TpuUDF
    from spark_rapids_tpu_torch.session import TpuSession, col
    fn = lambda a, b: torch.where(a > 0, a * 3 + b, b / 2)  # noqa: E731
    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randint(-100, 100, (n,), generator=g, device=cuda)
    b = torch.randn(n, generator=g, device=cuda, dtype=torch.float64)
    va = torch.rand(n, generator=g, device=cuda) < 0.9
    udf = TpuUDF(fn, T.DOUBLE, col("a"), col("b")).bind(T.StructType(
        [T.StructField("a", T.LONG), T.StructField("b", T.DOUBLE)]))
    ctx = E.EvalCtx(n, n, {"a": E.DevVal(a, va, T.LONG),
                           "b": E.DevVal(b, None, T.DOUBLE)}, None, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        udf.eval_dev(ctx)                         # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = udf.eval_dev(ctx)
    for seed in (4, 5, 6):
        g.manual_seed(seed)
        a.copy_(torch.randint(-100, 100, (n,), generator=g, device=cuda))
        b.copy_(torch.randn(n, generator=g, device=cuda,
                            dtype=torch.float64))
        va.copy_(torch.rand(n, generator=g, device=cuda) < 0.5)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.data, fn(a, b).double())
        assert torch.equal(out.validity, va)
    hb = _udf_table(np.random.default_rng(9))

    def query(s, t):
        return s.from_host(t).select(
            TpuUDF(fn, T.DOUBLE, col("a"), col("b")), names=["r"]) \
            .agg((Sum(col("r")), "s"), (Count(col("r")), "n"))
    CC.clear_caches()
    try:
        on = TpuSession({"spark.rapids.tpu.sql.compile.wholePlan": "ON"},
                        device=cuda)
        q = query(on, hb).physical()
        got = q.collect().to_pydict()
        assert CC.decision(q) == "whole"
        assert q.collect().to_pydict() == got          # a replay
        eager = query(TpuSession(device=cuda), hb).to_pydict()
        assert got["n"] == eager["n"]
        assert abs(got["s"][0] - eager["s"][0]) <= 1e-9 * abs(eager["s"][0])
    finally:
        CC.clear_caches()


@pytest.mark.cuda
def test_the_numpy_wire_through_a_forked_worker_after_cuda(cuda):
    """With a CUDA context in the process, a forked worker receives a
    batch of numpy lanes (one dictionary-coded, one with nulls) and sends
    it back unchanged; the worker's own error comes back as
    PythonWorkerError."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import host as H
    from spark_rapids_tpu_torch.exec import python_exec as PE
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    torch.ones(1, device=cuda).sum().item()            # CUDA is live
    rng = np.random.default_rng(2)
    n = 1_000_003
    hb = H.HostBatch([
        H.HostColumn(np.arange(n, dtype=np.int64), None, T.LONG),
        H.HostColumn(rng.standard_normal(n), rng.random(n) > 0.1,
                     T.DOUBLE),
        H.dictionary_column(rng.integers(0, 5, n), ["1-URGENT", "2-HIGH",
                                                   "3-MEDIUM", "4-NOT",
                                                   "5-LOW"]),
        H.HostColumn(rng.integers(0, 9000, n).astype(np.int32), None,
                     T.DATE)], ["k", "x", "s", "d"])
    ctx = ExecContext(device=cuda)
    parts = [hb.slice(i, min(1 << 18, n - i)) for i in range(0, n, 1 << 18)]
    back = list(PE.worker_stream(ctx, (((p,), None) for p in parts),
                                 lambda frames: (b[0] for b, _x in frames)))
    got = H.concat_host(back)
    assert got.to_pydict() == hb.to_pydict()
    assert ctx.metrics["python_workers_started"] == 1

    def boom(frames):
        for _f in frames:
            raise ValueError("wire boom")
        yield from ()
    with pytest.raises(PE.PythonWorkerError, match="wire boom"):
        list(PE.worker_stream(ctx, (((p,), None) for p in parts), boom))
