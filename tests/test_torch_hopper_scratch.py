"""The host side of the port's look-back scans (ops/hopper/__init__.py):
the tile geometry over a bool mask and its alignment split, and the one
per-stream scratch that segagg, compact and hashjoin share.  Runs on the
CPU; the kernels themselves are held against their plain versions on the
card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import hopper as PH
from spark_rapids_tpu_torch.ops.hopper import compact as PC
from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
from spark_rapids_tpu_torch.ops.hopper import segagg as PS

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

_CHUNK = 16                                   # rows a thread, one uint4


@pytest.mark.parametrize("ptr,cap,tile,want", [
    (0, 1, 4096, (0, 1)), (512, 4096, 4096, (0, 1)),
    (512, 4097, 4096, (0, 2)), (513, 4095, 4096, (1, 1)),
    (513, 4096, 4096, (1, 2)), (527, 4081, 4096, (15, 1)),
    (527, 4082, 4096, (15, 2)), (1024, 3_000_017, 4096, (0, 733)),
    (1031, 4_194_304, 4096, (7, 1025)), (1031, 4_194_304, 8192, (7, 513)),
    (1024, 4_194_304, 8192, (0, 512)), (513, 8191, 8192, (1, 1))])
def test_mask_tiles_geometry(ptr, cap, tile, want):
    assert PH.mask_tiles(ptr, cap, tile) == want


def test_the_wrappers_tile_sizes_match_their_kernels():
    # csrc/compact.cu: 256 threads x 32 rows; csrc/hashjoin.cu
    # probe_counts: 256 threads x 16 rows
    assert PC.TILE_ROWS == 256 * 32
    assert PHJ.PROBE_TILE_ROWS == 256 * 16


@pytest.mark.parametrize("tile", [4096, 8192])
@pytest.mark.parametrize("mis", [0, 1, 7, 15])
@pytest.mark.parametrize("cap", [1, 15, 16, 17, 4095, 4097, 10_007])
def test_mask_tiles_split_covers_every_row_once(tile, mis, cap):
    # thread chunk c covers rows 16c - mis .. 16c - mis + 15; a chunk
    # wholly inside the mask is one aligned 16-byte load, the others load
    # their rows one by one: at most the head's chunk and the tail's
    mis_, tiles = PH.mask_tiles(4096 + mis, cap, tile)
    assert mis_ == mis
    chunks = tiles * tile // _CHUNK
    r0 = np.arange(chunks) * _CHUNK - mis
    covered = (r0[:, None] + np.arange(_CHUNK)).ravel()
    inside = covered[(covered >= 0) & (covered < cap)]
    assert np.array_equal(inside, np.arange(cap))
    vector = (r0 >= 0) & (r0 + _CHUNK <= cap)
    partial = ((r0 + _CHUNK > 0) & (r0 < cap)) & ~vector
    assert partial.sum() <= 2
    head = -mis % _CHUNK                      # rows before an aligned one
    assert vector.sum() == max(cap - head, 0) // _CHUNK
    # the last tile holds a row of the mask, or the tile count is too big
    assert (tiles - 1) * tile - mis < cap


def test_stream_scratch_is_one_per_device_and_stream():
    dev = torch.device("cpu")
    a = PH.stream_scratch(dev, 101)
    assert PH.stream_scratch(dev, 101) is a
    assert PH.stream_scratch(dev, 202) is not a
    # segagg's tickets and the look-back counter: zero, one array
    assert a.tickets.dtype == torch.int32
    assert a.tickets.numel() == PH.TICKETS + 1
    assert not a.tickets.any()


def test_stream_scratch_lookback_epochs_and_growth():
    s = PH.StreamScratch(torch.device("cpu"))
    status, counter, epoch = s.lookback(3)
    assert epoch == 1 and s.status.numel() >= 3 and not s.status.any()
    assert status == s.status.data_ptr()
    # the tile counter is the ticket after segagg's
    assert counter == s.tickets.data_ptr() + 4 * PH.TICKETS
    s.status[:3] = 77                         # words a launch left behind
    again, _c, epoch = s.lookback(2)
    assert epoch == 2 and again == status     # reused, not refilled
    assert s.status[:3].tolist() == [77] * 3
    _s, _c, epoch = s.lookback(5)
    assert epoch == 3 and s.status.numel() >= 6 and not s.status.any()


def test_stream_scratch_clears_status_when_the_epoch_wraps(monkeypatch):
    monkeypatch.setattr(PH, "EPOCHS", 4)
    s = PH.StreamScratch(torch.device("cpu"))
    for want in (1, 2, 3):
        _s, _c, epoch = s.lookback(8)
        assert epoch == want
        s.status.fill_(want)
    _s, _c, epoch = s.lookback(8)
    assert epoch == 1 and not s.status.any()


def test_the_kernels_share_one_scratch_helper():
    # segagg's flush tickets moved into the shared helper: one source
    for mod in (PS, PC, PHJ):
        assert mod.stream_scratch is PH.stream_scratch
    assert PS.TICKETS == PH.TICKETS
    assert not hasattr(PS, "_tickets")


def test_cpu_wrappers_do_not_touch_the_scratch():
    # on the CPU the wrappers run their plain versions: no scratch
    before = dict(PH._SCRATCH)
    keep = torch.from_numpy(np.random.default_rng(0).random(5000) < 0.5)
    order, count = PC.compaction_order(keep)
    assert int(count) == int(keep.sum())
    lane = torch.arange(64, dtype=torch.int64)
    table = PHJ.build_table(lane, torch.ones(64, dtype=torch.bool))
    _f, counts, cum = PHJ.probe_counts(table, lane.flip(0),
                                       torch.ones(64, dtype=torch.bool))
    assert int(cum[-1]) == int(counts.sum()) == 64
    assert PH._SCRATCH == before
