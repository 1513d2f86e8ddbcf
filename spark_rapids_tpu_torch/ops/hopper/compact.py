"""Selection compaction on Hopper: the kernel wrapper and its plain
PyTorch version.

Counterpart of spark_rapids_tpu/ops/pallas/compact.py.
`compaction_order` replaces `_order_trace` (compact.py:53): the int32
order bringing `keep=True` rows to the front stably, with the identity
in every slot past the kept count (consumers mask validity beyond it,
so only the front is contractual — the tail is pinned all the same).
The kernel is hand-written CUDA (csrc/compact.cu: a grid-wide scan of
the mask and a scatter of each kept row to its rank; the design and
what bounds it are noted there).  Unlike the reference it also returns
the kept count, as a 0-d int32 device tensor, so `compact_batch` needs
no second reduction.

Given CUDA tensors the wrapper checks them, allocates the outputs and
scratch, launches on PyTorch's current stream and raises if the launch
fails; given CPU tensors it runs the plain version.  Nothing falls back
from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_launch, library, stream_ptr

_VP = ctypes.c_void_p
#: rows per tile of the kernel's grid-wide scan (csrc/tile_scan.cuh
#: kTileRows): the wrapper sizes the per-tile scratch with it
TILE_ROWS = 1024


def _fn():
    f = library("compact").compact_order
    if f.argtypes is None:
        f.argtypes = [_VP, ctypes.c_longlong, _VP, _VP, _VP, _VP]
        f.restype = ctypes.c_int
    return f


def compaction_order_plain(keep: torch.Tensor):
    """Plain version: a stable argsort of the inverted mask for the front,
    the identity written over the tail."""
    cap = keep.numel()
    order = torch.argsort((~keep).to(torch.int8), stable=True) \
        .to(torch.int32)
    count = keep.sum(dtype=torch.int32)
    iota = torch.arange(cap, dtype=torch.int32, device=keep.device)
    return torch.where(iota < count, order, iota), count


def compaction_order(keep: torch.Tensor):
    """(order int32[cap], count 0-d int32) for a 1-D bool keep mask."""
    if keep.device.type == "cpu":
        return compaction_order_plain(keep)
    if keep.device.type != "cuda":
        raise ValueError(f"compaction_order: unsupported device "
                         f"{keep.device}")
    if keep.dtype != torch.bool or keep.dim() != 1 or \
            not keep.is_contiguous() or keep.numel() == 0:
        raise ValueError("keep must be a non-empty contiguous 1-D bool "
                         "tensor")
    cap = keep.numel()
    dev = keep.device
    order = torch.empty(cap, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    tiles = torch.empty(-(-cap // TILE_ROWS), dtype=torch.int32, device=dev)
    err = _fn()(keep.data_ptr(), cap, tiles.data_ptr(), order.data_ptr(),
                count.data_ptr(), stream_ptr(dev))
    # three device launches: the tile counts, the carry scan of the tile
    # counts and the scatter pass (csrc/compact.cu)
    LAUNCHES["compaction_order"] += 3
    check_launch(err, "compaction_order")
    return order, count
