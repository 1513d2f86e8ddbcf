"""Low-level tensor helpers shared by the expression/operator layers.

Counterpart of spark_rapids_tpu/ops/kernels.py:

  * storage<->compute views (identity for every type here: DOUBLE is
    native float64 on the card, see columnar/device.py)
  * validity lane algebra (Spark three-valued logic)
  * row-liveness masking for reductions over padded buckets
  * cumulative scans: torch.cumsum / torch.cummax, except that a
    floating prefix sum keeps the reference's 512-row blocked order,
    which decides how its float64 sums round
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import types as t
from ..columnar.device import storage_dtype


def compute_dtype(dt: t.DataType) -> torch.dtype:
    """torch dtype used for arithmetic on this logical type."""
    return storage_dtype(dt)


def compute_view(data: torch.Tensor, dt: t.DataType) -> torch.Tensor:
    """Storage lane -> compute representation (the same tensor: DOUBLE
    is stored as float64)."""
    return data


def storage_view(data: torch.Tensor, dt: t.DataType) -> torch.Tensor:
    """Compute representation -> storage lane."""
    return data.to(storage_dtype(dt))


def merge_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of validity lanes; None means all-valid."""
    present = [v for v in vs if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = out & v
    return out


def valid_or_true(v: Optional[torch.Tensor], capacity: int,
                  device=None) -> torch.Tensor:
    if v is not None:
        return v
    return torch.ones(capacity, dtype=torch.bool, device=device)


def live_mask(capacity: int, num_rows, device=None) -> torch.Tensor:
    """Mask of logically-live rows in a padded bucket; `num_rows` may be
    a host int or a 0-d device tensor (no sync either way)."""
    iota = torch.arange(capacity, dtype=torch.int32, device=device)
    if isinstance(num_rows, torch.Tensor):
        return iota < num_rows.to(torch.int32)
    return iota < int(num_rows)


_SCAN_BLOCK = 512
_SCAN_MIN = 4096


def blocked_cumsum(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Cumulative sum along axis 0 of a 1-D lane.  Integer lanes scan in
    one pass (any order gives the same sums); floating lanes add in the
    reference's blocked order — 512-row blocks scanned along their rows,
    then the exclusive scan of the block totals added on — so a float64
    prefix sum rounds as the reference's does, on the card as well (a
    (nb, 512) scan along dim 1 runs many short rows)."""
    assert axis == 0
    n = a.shape[0]
    if not a.dtype.is_floating_point or n < _SCAN_MIN or \
            n % _SCAN_BLOCK != 0:
        return torch.cumsum(a, dim=0)
    within = torch.cumsum(a.reshape(n // _SCAN_BLOCK, _SCAN_BLOCK), dim=1)
    totals = within[:, -1]
    offs = torch.cumsum(totals, dim=0) - totals
    return (within + offs[:, None]).reshape(n)


def blocked_cummax(a: torch.Tensor) -> torch.Tensor:
    """Cumulative max along axis 0."""
    return torch.cummax(a, dim=0).values
