"""Vectorized binary search in one place.

Counterpart of spark_rapids_tpu/ops/search.py, which picks the method
of `jnp.searchsorted` for the TPU's cost model.  `torch.searchsorted` is
one binary search a query on both devices (a CUDA kernel on the card),
so the wrapper only fixes the semantics: numpy's `side`, over 1-D
lanes, the query dtype promoted to the sorted lane's.
"""
from __future__ import annotations

import torch


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left"
                 ) -> torch.Tensor:
    """np.searchsorted(a, v, side) over a sorted 1-D lane `a`: int64
    insertion points of `v`."""
    if v.dtype != a.dtype:
        v = v.to(a.dtype)
    return torch.searchsorted(a.contiguous(), v.contiguous(),
                              right=side == "right")
