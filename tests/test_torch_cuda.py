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
    want = {"m2m": ("build_table", "probe_counts", "expand_pairs",
                    "compaction_order", "seg_sums"),
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
                                   "q12", "q15", "q17", "q18", "q19"])
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
