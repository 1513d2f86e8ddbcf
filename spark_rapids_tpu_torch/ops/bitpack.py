"""Lane codecs for the exchange's wire format.

Counterpart of spark_rapids_tpu/ops/bitpack.py (the role nvcomp's
cascaded codecs play in the reference's shuffle):

  * bit packing — a bool lane rides 1 bit a row instead of a byte;
  * frame-of-reference (FOR) narrowing — an integer lane whose
    [min, max] span fits a narrower unsigned word ships as
    `value - min` in uint8 / int16 / int32 words;
  * run-length encoding — sorted or low-cardinality lanes collapse into
    (value, run length) pairs at a static capacity.

Every function is capacity in, capacity out, on whatever device its
tensors lie.  PyTorch has no uint16 or uint32 arithmetic on CUDA, so a
FOR word wider than a byte is held in the signed dtype of its width:
the bits are the unsigned word's, and `for_decode` reads them back
masked.  The consumer, the exchange (parallel/exchange.py), ports with
ROADMAP Queue 1 item 9; `rle_predicate_mask` (ops/encodings.py) reads
the RLE form.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..runtime.capture import host_constant

_UNSIGNED_WIDTHS = ((np.uint8, 1), (np.uint16, 2), (np.uint32, 4))
#: the torch dtype holding an unsigned word's bits
_WORD_DTYPE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor's last axis (a multiple of 8) into uint8 bytes:
    (..., N) -> (..., N // 8), bit b of byte i holding row 8 * i + b."""
    n = x.shape[-1]
    assert n % 8 == 0, f"pack_bits needs a multiple of 8 rows, got {n}"
    g = x.reshape(x.shape[:-1] + (n // 8, 8)).to(torch.uint8)
    weights = host_constant(np.array([1 << b for b in range(8)], np.uint8),
                            x.device)
    return (g * weights).sum(-1, dtype=torch.int32).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_bits`: (..., M) uint8 -> (..., 8 * M) bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)) \
        .to(torch.bool)


def wire_dtype_for(lo: int, hi: int, logical) -> np.dtype:
    """The narrowest unsigned FOR word for an integer lane whose live
    values span [lo, hi] (the host-side plan step); the logical dtype
    when no narrower word saves bytes.  lo > hi means no live row: the
    cheapest legal width."""
    logical = np.dtype(logical)
    if lo > hi:
        return np.dtype(np.uint8) if logical.itemsize > 1 else logical
    span = int(hi) - int(lo)
    for cand, size in _UNSIGNED_WIDTHS:
        if size < logical.itemsize and span <= np.iinfo(cand).max:
            return np.dtype(cand)
    return logical


def _word_dtype(wire_dtype) -> torch.dtype:
    return _WORD_DTYPE[np.dtype(wire_dtype).itemsize]


def for_encode(x: torch.Tensor, bias: int, wire_dtype) -> torch.Tensor:
    """FOR encode: `x - bias` as the planned wire word (the low bits of
    the difference, computed in int64).  Dead rows may wrap: receivers
    drop them."""
    wire = np.dtype(wire_dtype)
    if wire.kind != "u":
        return x
    diff = x.to(torch.int64) - bias
    mask = (1 << (8 * wire.itemsize)) - 1
    low = diff & mask
    if wire.itemsize < 8:
        # two's complement of the word in its signed holder
        sign = 1 << (8 * wire.itemsize - 1)
        low = torch.where(low >= sign, low - (mask + 1), low) \
            if wire.itemsize > 1 else low
    return low.to(_word_dtype(wire))


def for_decode(w: torch.Tensor, bias: int, logical_dtype) -> torch.Tensor:
    """Inverse of `for_encode` back to the logical dtype."""
    from ..columnar.device import torch_dtype
    logical = torch_dtype(logical_dtype)
    if w.dtype == logical:
        return w
    size = w.element_size()
    word = w.to(torch.int64) & ((1 << (8 * size)) - 1)
    return (word + bias).to(logical)


def bytes_to_words(x: torch.Tensor) -> torch.Tensor:
    """A fixed-width lane slab (..., Q) as wire bytes (..., Q, itemsize),
    so that lanes of several dtypes concatenate into one word a slot (a
    one-byte lane other than uint8 keeps its shape, as the reference's
    bitcast does)."""
    if x.dtype == torch.uint8:
        return x.unsqueeze(-1)
    if x.element_size() == 1:
        return x.view(torch.uint8)
    return x.contiguous().view(torch.uint8).reshape(
        x.shape + (x.element_size(),))


def words_to_lane(w: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `bytes_to_words` for one lane's byte slice."""
    from ..columnar.device import torch_dtype
    dt = torch_dtype(dtype) if not isinstance(dtype, torch.dtype) else dtype
    if dt == torch.uint8:
        return w[..., 0]
    if torch.empty((), dtype=dt).element_size() == 1:
        return w.view(dt)
    return w.contiguous().view(dt).reshape(w.shape[:-1])


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x, 0)[:-1]
    return out


def rle_encode(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encode a lane at its capacity: (run values (C,), run
    lengths (C,) int32, the run count as a 0-d int32); only the first
    run-count entries are meaningful."""
    cap = x.shape[0]
    b = torch.ones(cap, dtype=torch.bool, device=x.device)
    b[1:] = x[1:] != x[:-1]
    run_id = torch.cumsum(b.to(torch.int64), 0) - 1
    n_runs = b.sum(dtype=torch.int32)
    lengths = torch.zeros(cap, dtype=torch.int32, device=x.device)
    lengths.index_add_(0, run_id, torch.ones(cap, dtype=torch.int32,
                                             device=x.device))
    iota = torch.arange(cap, dtype=torch.int64, device=x.device)
    starts = torch.sort(torch.where(b, iota, torch.full_like(iota, cap)))[0]
    values = x[torch.clamp(starts, 0, cap - 1)]
    return values, lengths, n_runs


def rle_decode(values: torch.Tensor, lengths: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Expand (run values, run lengths) back to a (cap,) lane; rows past
    the encoded total repeat the last run's value (callers carry a live
    mask, as every exchange lane does)."""
    starts = _exclusive_cumsum(lengths.to(torch.int64))
    rows = torch.arange(cap, dtype=torch.int64, device=values.device)
    idx = torch.searchsorted(starts, rows, right=True) - 1
    return values[torch.clamp(idx, 0, values.shape[0] - 1)]
