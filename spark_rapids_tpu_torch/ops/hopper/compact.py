"""Selection compaction on Hopper: the kernel wrapper and its plain
PyTorch version.

Counterpart of spark_rapids_tpu/ops/pallas/compact.py.
`compaction_order` replaces `_order_trace` (compact.py:53): the int32
order bringing `keep=True` rows to the front stably, with the identity
in every slot past the kept count (consumers mask validity beyond it,
so only the front is contractual — the tail is pinned all the same).
The kernel is hand-written CUDA (csrc/compact.cu: one pass over the
mask with a decoupled look-back scan, then a launch that writes the
identity tail; the design and what bounds it are noted there).  Unlike
the reference it also returns the kept count, as a 0-d int32 device
tensor, so `compact_batch` needs no second reduction.

Given CUDA tensors the wrapper checks them, allocates one int32 buffer
of cap + 1 entries (the order, then the count: the count is a view of
it), launches on PyTorch's current stream and raises if the launch
fails; given CPU tensors it runs the plain version.  Nothing falls back
from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, check_launch, library, mask_tiles, stream_ptr,
               stream_scratch)

_VP = ctypes.c_void_p
#: rows of one look-back tile (csrc/compact.cu kTileRows: 256 threads,
#: 32 rows each)
TILE_ROWS = 8192


def _fn():
    f = library("compact").compact_order
    if f.argtypes is None:
        f.argtypes = [_VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      _VP, _VP, _VP, ctypes.c_uint, _VP]
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
    ptr = keep.data_ptr()
    mis, tiles = mask_tiles(ptr, cap, TILE_ROWS)
    out = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    st = stream_ptr(dev)
    status, counter, epoch = stream_scratch(dev, st).lookback(tiles)
    err = _fn()(ptr, cap, mis, tiles, out.data_ptr(), status, counter, epoch,
                st)
    # two device launches: the look-back scan and the identity tail
    # (csrc/compact.cu)
    LAUNCHES["compaction_order"] += 2
    check_launch(err, "compaction_order")
    return out[:cap], out[cap]
