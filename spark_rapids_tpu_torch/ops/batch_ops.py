"""Device batch utilities: concat and re-bucketing.

Counterpart of spark_rapids_tpu/ops/batch_ops.py for what the
aggregation merge, the join build and probe sides and the limits need.
String columns carry per-batch dictionaries, so concat first unifies
them on the host (numpy) and remaps the codes on the device with one
gather per column, unless every batch carries the same sorted
dictionary (the batches of one scan), whose codes already agree.

A batch with a selection vector or deferred columns (DeviceBatch `sel`,
`thin`) becomes a row prefix in `ensure_prefix`, which concat and the
shrinks call on entry and then assert (`DeviceBatch.assert_prefix`).

`concat_batches` reads every row count that is still a device scalar
(one sync each) and concatenates the live prefixes tightly, where the
reference's lazy concat keeps whole capacities: a join's build side is
then the size of its rows, not the sum of its inputs' capacities.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, NarrowColumn,
                               merge_origin,
                               bucket_capacity)
from ..config import DEFAULT_CONF, TpuConf
from ..runtime.capture import capturing, host_constant, recording


def unify_dictionaries(dicts: Sequence[Optional[np.ndarray]]):
    """-> (sorted unified dictionary, [int32 remap array per input])."""
    arrs = [np.asarray(d, str) if d is not None else np.array([], str)
            for d in dicts]
    unified = np.unique(np.concatenate(arrs)) if arrs else np.array([], str)
    remaps = [np.searchsorted(unified, a).astype(np.int32) if len(a)
              else np.zeros(1, np.int32) for a in arrs]
    return unified.astype(str), remaps


def remap_string_column(col: DeviceColumn, remap: np.ndarray,
                        unified: np.ndarray) -> DeviceColumn:
    table = host_constant(remap, col.data.device)
    data = table[torch.clamp(col.data, 0, table.shape[0] - 1).to(torch.int64)]
    # an ARRAY<STRING> column remaps its values lane
    return DeviceColumn(data, col.validity, col.dtype, unified, None, None,
                        col.offsets, col.elem_valid)


_REMAP_CACHE: dict = {}


def remap_codes_into(col: DeviceColumn, target: np.ndarray) -> DeviceColumn:
    """A string column's codes in `target`'s code space (a join probe
    against its build's dictionary); a string absent from `target` maps
    to -1, which equals no code.  The host table is cached per (source,
    target) dictionary pair, so the batches of one scan share it."""
    src = col.dictionary
    if src is target:
        return col
    key = (id(src), id(target), str(col.data.device))
    hit = _REMAP_CACHE.get(key)
    if hit is None or hit[0] is not src or hit[1] is not target:
        s = np.asarray(src if src is not None else [], str)
        tgt = np.asarray(target, str)
        pos = np.searchsorted(tgt, s)
        found = pos < len(tgt)
        found[found] = tgt[pos[found]] == s[found]
        table = np.where(found, pos, -1).astype(np.int32)
        if not len(table):
            table = np.full(1, -1, np.int32)
        if len(_REMAP_CACHE) > 512:
            _REMAP_CACHE.clear()
        # pin both dictionaries so their ids stay valid while cached
        hit = (src, target, host_constant(table, col.data.device))
        if not recording():       # a recorded tensor fills at replay only
            _REMAP_CACHE[key] = hit
    table = hit[2]
    data = table[torch.clamp(col.data, 0, table.shape[0] - 1).to(
        torch.int64)]
    return DeviceColumn(data, col.validity, col.dtype, target)


def ensure_unique_dict(col: DeviceColumn) -> DeviceColumn:
    """Code equality == string equality requires a duplicate-free
    dictionary; host dictionaries are built sorted and unique, so this
    remaps only a dictionary that is not."""
    d = col.dictionary
    if d is None or len(d) <= 1 or bool(np.all(d[:-1] < d[1:])):
        return col
    unified, remaps = unify_dictionaries([d])
    return remap_string_column(col, remaps[0], unified)


def _shared_dictionary(cols: Sequence[DeviceColumn]
                       ) -> Optional[np.ndarray]:
    """The one dictionary every column carries, when it is a single
    sorted, duplicate-free array (the batches of one scan share their
    column's; an empty dictionary, every row null, takes any): the codes
    are already in one space, so nothing remaps.  None otherwise."""
    ds = [c.dictionary for c in cols]
    if any(x is None for x in ds):
        return None
    used = [x for x in ds if len(x)] or ds[:1]
    d = used[0]
    if any(x is not d for x in used[1:]):
        return None
    return d if len(d) <= 1 or bool(np.all(d[:-1] < d[1:])) else None


def ensure_prefix(db: DeviceBatch, conf: TpuConf = DEFAULT_CONF
                  ) -> DeviceBatch:
    """The batch in the dense front-prefix form every slicing, concat
    and fetch path assumes: a lazy selection vector compacts
    (`compact_batch`, which resolves deferred columns in the same pass,
    columnar/lanes.compact_thin) and deferred columns alone materialize
    (`lanes.materialize_batch`)."""
    if db.sel is None:
        if db.thin is None:
            return db
        from ..columnar.lanes import materialize_batch
        return materialize_batch(db, conf)
    from .filter import compact_batch
    return compact_batch(db, db.sel, conf)


def concat_batches(batches: List[DeviceBatch],
                   conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Concatenate same-schema device batches into one bucketed batch
    (live prefixes back to back, padding after)."""
    assert batches, "concat of zero batches"
    batches = [ensure_prefix(b, conf) for b in batches]
    for b in batches:
        b.assert_prefix()
    if len(batches) == 1:
        return batches[0]
    # under capture no count comes to the host: whole capacities stack,
    # and each batch's live prefix moves behind the ones before it by the
    # device counts (`_lazy_place`), the reference's lazy concat without
    # its compaction
    lazy = capturing()
    counts = [b.capacity if lazy else int(b.num_rows) for b in batches]
    total = sum(counts)
    cap = bucket_capacity(max(total, 1), conf)
    pad = cap - total
    dev = batches[0].device
    place = _lazy_place(batches, cap) if lazy else None
    out_cols = []
    for ci in range(batches[0].num_columns):
        cols = [b.column(ci) for b in batches]
        dt = cols[0].dtype
        unified = None
        if isinstance(dt.element_type if isinstance(dt, t.ArrayType)
                      else dt, t.StringType):
            unified = _shared_dictionary(cols)
            if unified is None:
                unified, remaps = unify_dictionaries(
                    [c.dictionary for c in cols])
                cols = [remap_string_column(c, r, unified)
                        for c, r in zip(cols, remaps)]
        if cols[0].offsets is not None:
            out_cols.append(_concat_ragged(cols, counts, cap, unified))
            continue
        # FOR-narrowed parts stay narrow, at the widest of their lanes
        narrow = all(isinstance(c, NarrowColumn) for c in cols)
        if narrow:
            lane_dt = cols[0].lane.dtype
            for c in cols[1:]:
                lane_dt = torch.promote_types(lane_dt, c.lane.dtype)
            data = [c.lane[:n].to(lane_dt) for c, n in zip(cols, counts)]
        else:
            data = [c.data[:n] for c, n in zip(cols, counts)]
        valid = [c.validity[:n] for c, n in zip(cols, counts)]
        hi = None
        if any(c.hi is not None for c in cols):
            hi = [(c.data[:n] >> 63) if c.hi is None else c.hi[:n]
                  for c, n in zip(cols, counts)]
        if place is not None:
            data, valid = [place(data)], [place(valid)]
            hi = None if hi is None else [place(hi)]
        elif pad:
            data.append(torch.zeros(pad, dtype=data[0].dtype, device=dev))
            valid.append(torch.zeros(pad, dtype=torch.bool, device=dev))
            if hi is not None:
                hi.append(torch.zeros(pad, dtype=torch.int64, device=dev))
        ranges = [c.value_range for c in cols]
        rng = None if any(r is None for r in ranges) else (
            min(r[0] for r in ranges), max(r[1] for r in ranges))
        if narrow:
            out_cols.append(NarrowColumn(torch.cat(data), torch.cat(valid),
                                         dt, unified, rng))
            continue
        out_cols.append(DeviceColumn(torch.cat(data), torch.cat(valid), dt,
                                     unified, rng,
                                     None if hi is None else torch.cat(hi)))
    return DeviceBatch(out_cols, place.rows if lazy else total,
                       list(batches[0].names), origin_file=merge_origin(
                           b.origin_file for b in batches))


def _concat_ragged(cols: List[DeviceColumn], counts: List[int], cap: int,
                   unified) -> DeviceColumn:
    """Ragged parts back to back: each part's live values and its
    offsets moved past the values before it.  The value counts come to
    the host (a host decision under capture)."""
    dev = cols[0].validity.device
    nvals = [int(c.offsets[n]) for c, n in zip(cols, counts)]
    total = sum(nvals)
    vcap = bucket_capacity(max(total, 1))
    offs, base = [], 0
    for c, n, nv in zip(cols, counts, nvals):
        offs.append(c.offsets[:n] + base)
        base += nv
    rows = sum(counts)
    offs.append(torch.full((cap + 1 - rows,), total, dtype=torch.int32,
                           device=dev))
    pad = vcap - total
    data = [c.data[:nv] for c, nv in zip(cols, nvals)] + \
        [torch.zeros(pad, dtype=cols[0].data.dtype, device=dev)]
    ev = [c.elem_valid[:nv] for c, nv in zip(cols, nvals)] + \
        [torch.zeros(pad, dtype=torch.bool, device=dev)]
    valid = [c.validity[:n] for c, n in zip(cols, counts)] + \
        [torch.zeros(cap - rows, dtype=torch.bool, device=dev)]
    dictionary = unified if unified is not None else cols[0].dictionary
    return DeviceColumn(torch.cat(data), torch.cat(valid), cols[0].dtype,
                        dictionary, None, None,
                        torch.cat(offs).to(torch.int32), torch.cat(ev))


def device_rows(db: DeviceBatch) -> torch.Tensor:
    """A batch's row count as a 0-d int64 tensor (no upload)."""
    if isinstance(db.num_rows, torch.Tensor):
        return db.num_rows.to(torch.int64)
    return torch.full((), db.num_rows, dtype=torch.int64, device=db.device)


def _lazy_place(batches: List[DeviceBatch], cap: int):
    """The placement of a sync-free concat of live-prefix batches into
    `cap` rows: row j of batch i goes to (rows of batches before i) + j
    when j < its count, else to one spare row past `cap`, dropped.
    -> a function from the batches' whole-capacity lanes (concatenated in
    batch order) to the output lane, with `.rows` the total count."""
    dev = batches[0].device
    dest, before = [], torch.zeros((), dtype=torch.int64, device=dev)
    for b in batches:
        n = device_rows(b)
        j = torch.arange(b.capacity, dtype=torch.int64, device=dev)
        dest.append(torch.where(j < n, before + j, torch.full_like(j, cap)))
        before = before + n
    dest = torch.cat(dest)

    def place(parts: List[torch.Tensor]) -> torch.Tensor:
        lane = torch.cat(parts)
        out = torch.zeros(cap + 1, dtype=lane.dtype, device=dev)
        out.index_copy_(0, dest, lane)
        return out[:cap]
    place.rows = before.to(torch.int32)
    return place


def shrink_to_capacity(db: DeviceBatch, row_bound: int,
                       conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Slice the lanes down to the bucket fitting `row_bound` WITHOUT
    reading a lazy `num_rows`: sound when the caller bounds the live
    rows statically (LIMIT n), since live rows are a prefix."""
    db = ensure_prefix(db, conf)
    db.assert_prefix()
    cap = bucket_capacity(max(row_bound, 1), conf)
    if cap >= db.capacity:
        return db
    cols = [c.prefix(cap) for c in db.columns]
    return DeviceBatch(cols, db.num_rows, db.names,
                       origin_file=db.origin_file)


def shrink_to_rows(db: DeviceBatch, num_rows: int,
                   conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Re-bucket a padded batch down to the bucket fitting `num_rows`
    (after a group-by whose occupancy dropped a bucket or more).  The
    kept rows are copied, so the full-capacity lanes they came from are
    freed: a group-by's partial of a few groups must not hold its
    capacity-sized outputs alive until the merge."""
    db = ensure_prefix(db, conf)
    db.assert_prefix()
    if isinstance(num_rows, torch.Tensor):
        # a device count (under capture): the static capacity stays
        return DeviceBatch(db.columns, num_rows, db.names,
                           origin_file=db.origin_file)
    cap = bucket_capacity(max(num_rows, 1), conf)
    if cap >= db.capacity:
        return DeviceBatch(db.columns, num_rows, db.names,
                           origin_file=db.origin_file)
    cols = [c.prefix(cap, copy=True) for c in db.columns]
    return DeviceBatch(cols, num_rows, db.names, origin_file=db.origin_file)
