"""Row selection: mask compaction and index gather.

Counterpart of spark_rapids_tpu/ops/filter.py (GpuFilterExec's
`Table.filter` and the join gather maps):

  * `compact_batch` keeps the rows of a keep-mask, in order, at the same
    capacity.  The order and the kept count come from the compaction
    kernel (ops/hopper/compact.py) at every capacity; with the kernel
    tier off it refuses, as the port has no portable compaction tier.
    The kept count stays a 0-d device tensor unless `sync=True`, which
    reads it and re-buckets down;
  * `gather_batch` takes rows at indices, with out-of-range indices
    nulled on request (cuDF's OutOfBoundsPolicy.NULLIFY, outer joins);
  * `grouped_take` / `take_keys_valid` gather many lanes at one index
    lane.  The reference stacks same-dtype lanes into one matrix because
    a TPU gather pays per row; a CUDA gather pays per byte, so here each
    lane is gathered on its own.

The reference's thin (late-materialized) batches port with Queue 1
item 4.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..columnar.device import DeviceBatch, DeviceColumn
from ..config import DEFAULT_CONF, TpuConf
from .kernels import live_mask


def grouped_take(lanes, idx: torch.Tensor) -> List[torch.Tensor]:
    """Every lane gathered at the same indices."""
    idx = idx.long()
    return [lane[idx] for lane in lanes]


def take_keys_valid(keys, keys_valid, extra, idx):
    """grouped_take of key lanes, their (possibly None) validity lanes
    and extra lanes at `idx`, keeping the None validity slots.  Returns
    (keys_out, keys_valid_out, extra_out)."""
    kv = [v for v in keys_valid if v is not None]
    moved = grouped_take(list(keys) + kv + list(extra), idx)
    nk = len(keys)
    it = iter(moved[nk:nk + len(kv)])
    out_kv = [None if v is None else next(it) for v in keys_valid]
    return moved[:nk], out_kv, moved[nk + len(kv):]


def compact_batch(db: DeviceBatch, keep: torch.Tensor,
                  conf: TpuConf = DEFAULT_CONF,
                  sync: bool = False) -> DeviceBatch:
    """Keep the rows where `keep` is True (padding rows must already be
    False).  The surviving count stays on the device (`num_rows` a 0-d
    tensor) so a filter feeding another device operator costs no host
    round trip; `sync=True` reads it and re-buckets down."""
    from .batch_ops import shrink_to_rows
    from .hopper import compact, elect_compact
    if elect_compact(conf) is None:
        raise NotImplementedError(
            "compaction with the kernel tier or its compact family off "
            "runs the reference's portable argsort tier, which ports with "
            "the kernel-off tiers (ROADMAP Queue 1 item 1)")
    order, count = compact.compaction_order(keep.contiguous())
    live = live_mask(db.capacity, count, db.device)
    lanes = []
    for c in db.columns:
        lanes += [c.data, c.validity] + ([] if c.hi is None else [c.hi])
    moved = iter(grouped_take(lanes, order))
    cols = []
    for c in db.columns:
        data, valid = next(moved), next(moved)
        cols.append(DeviceColumn(data, valid & live, c.dtype, c.dictionary,
                                 None, None if c.hi is None else next(moved)))
    out = DeviceBatch(cols, count, list(db.names))
    if not sync:
        return out
    n = int(count)
    return shrink_to_rows(DeviceBatch(cols, n, list(db.names)), n, conf)


def gather_batch(db: DeviceBatch, indices: torch.Tensor, out_rows,
                 names: Optional[List[str]] = None,
                 null_out_of_bounds: bool = False) -> DeviceBatch:
    """Rows of `db` at `indices` (shape (out_capacity,)).  With
    `null_out_of_bounds`, rows whose index is < 0 or >= db.num_rows come
    out null; rows past `out_rows` are padding."""
    cap_out = indices.shape[0]
    num_rows = db.num_rows
    if isinstance(num_rows, torch.Tensor):
        num_rows = num_rows.to(indices.dtype)
    in_bounds = (indices >= 0) & (indices < num_rows)
    safe = torch.clamp(indices, 0, max(db.capacity - 1, 0)).long()
    live = live_mask(cap_out, out_rows, indices.device)
    vmask = live & in_bounds if null_out_of_bounds else live
    cols = [c.take(safe, vmask) for c in db.columns]
    return DeviceBatch(cols, out_rows, names or list(db.names))
