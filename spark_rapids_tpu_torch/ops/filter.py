"""Row selection: mask compaction and index gather.

Counterpart of spark_rapids_tpu/ops/filter.py (GpuFilterExec's
`Table.filter` and the join gather maps):

  * `compact_batch` keeps the rows of a keep-mask, in order, at the same
    capacity.  The order and the kept count come from the compaction
    kernel (ops/hopper/compact.py) where `elect_compact` elects it, and
    otherwise (the family off, a capacity under 1024 rows, or a shed)
    from the portable tier, `compaction_order`: one stable argsort of
    the inverted mask, as in the reference.  The kept count stays a 0-d
    device tensor unless `sync=True`, which reads it and re-buckets
    down;
  * `gather_batch` takes rows at indices, with out-of-range indices
    nulled on request (cuDF's OutOfBoundsPolicy.NULLIFY, outer joins);
  * `grouped_take` / `take_keys_valid` gather many lanes at one index
    lane.  The reference stacks same-dtype lanes into one matrix because
    a TPU gather pays per row; a CUDA gather pays per byte, so here each
    lane is gathered on its own.

A thin batch (columnar/lanes.py, `sql.join.lateMaterialization.enabled`)
compacts through `lanes.compact_thin`: its deferred columns are gathered
once, from their sources straight into compacted position.  A batch with
a selection vector compacts like any other: its keep-mask must lie
inside the selection (`DeviceBatch.row_mask`).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..columnar.device import DeviceBatch
from ..config import DEFAULT_CONF, TpuConf
from ..runtime.capture import capturing
from .kernels import live_mask


def compaction_order(keep: torch.Tensor):
    """The portable compaction tier: (indices that bring the kept rows to
    the front, stably, the kept count as a 0-d tensor).  Both come from
    PyTorch's stable sort and sum, as the reference's come from jnp."""
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    return order, keep.sum(dtype=torch.int32)


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


def keep_order(keep: torch.Tensor, conf: TpuConf = DEFAULT_CONF):
    """(the stable order that brings the kept rows to the front, the kept
    count as a 0-d tensor): the compaction kernel where ops/hopper
    elects it for this capacity, else the portable tier."""
    from .hopper import compact, elect_compact
    if elect_compact(conf, keep.shape[0]) is None:
        return compaction_order(keep)
    return compact.compaction_order(keep.contiguous())


def compact_batch(db: DeviceBatch, keep: torch.Tensor,
                  conf: TpuConf = DEFAULT_CONF,
                  sync: bool = False) -> DeviceBatch:
    """Keep the rows where `keep` is True (padding rows, and rows outside
    a selection vector, must already be False).  The surviving count
    stays on the device (`num_rows` a 0-d tensor) so a filter feeding
    another device operator costs no host round trip; `sync=True` reads
    it and re-buckets down."""
    from .batch_ops import shrink_to_rows
    if db.thin is not None:
        from ..columnar.lanes import compact_thin
        out = compact_thin(db, keep, conf)
        if not sync or capturing():
            return out
        return shrink_to_rows(out, int(out.num_rows), conf)
    order, count = keep_order(keep, conf)
    live = live_mask(db.capacity, count, db.device)
    lanes = []
    for c in db.columns:
        if c.offsets is None:
            lanes += [c.stored, c.validity] + ([] if c.hi is None
                                               else [c.hi])
    moved = iter(grouped_take(lanes, order))
    cols = []
    for c in db.columns:
        if c.offsets is not None:      # a ragged column moves its values
            cols.append(c.take(order.long(), live))
            continue
        data, valid = next(moved), next(moved)
        cols.append(c.rebuilt(data, valid & live,
                              None if c.hi is None else next(moved)))
    out = DeviceBatch(cols, count, list(db.names),
                      origin_file=db.origin_file)
    if not sync or capturing():
        return out
    n = int(count)
    return shrink_to_rows(DeviceBatch(cols, n, list(db.names),
                                      origin_file=db.origin_file), n, conf)


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
