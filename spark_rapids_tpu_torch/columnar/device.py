"""Device-side columnar batches over torch tensors.

Counterpart of spark_rapids_tpu/columnar/device.py.  The contract is
the same:

  * **Bucketed capacity.**  Every device column is padded to a capacity
    from the same geometric bucket ladder (`bucket_capacity`); the live
    row count travels beside it as a host int or a 0-d device tensor,
    and padding rows are invalid.  PyTorch runs eagerly, so buckets no
    longer bound a compile cache; they keep batch shapes (and so the
    kernels' launch shapes) identical to the reference's.
  * **Validity as a bool lane** per column (True = valid).
  * **Strings as dictionary codes**: int32 codes on the device, the
    sorted numpy dictionary on the host.
  * **Decimals as int64 unscaled lanes**, and a DECIMAL wider than 18
    digits with an optional high int64 lane (`DeviceColumn.hi`, the
    value hi * 2^64 + (data as unsigned), the reference's `data_hi`).

One deliberate difference: DOUBLE is stored as native float64.  The
reference keeps int64 bit patterns because the TPU emulates f64 lossily;
Hopper computes IEEE doubles exactly, so the lane is the value itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import types as t
from ..config import DEFAULT_CONF, TpuConf
from .host import HostBatch, HostColumn, list_column


def bucket_capacity(n: int, conf: TpuConf = DEFAULT_CONF) -> int:
    """Smallest static-shape bucket >= n (the reference's ladder:
    explicit `sql.shape.buckets`, else x bucketGrowth up to
    batchSizeRows, x2 above it)."""
    explicit = conf.bucket_set
    if explicit:
        for cap in explicit:
            if cap >= n:
                return cap
        cap = explicit[-1]
        while cap < n:
            cap *= 2
        return cap
    cap = conf.bucket_min_rows
    growth = conf.bucket_growth
    target = conf.batch_size_rows
    while cap < n:
        cap *= growth if cap < target else 2
    return cap


def torch_dtype(np_dtype) -> torch.dtype:
    """torch dtype of a numpy storage dtype."""
    return {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
            np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
            np.dtype(np.int64): torch.int64,
            np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(np_dtype)]


def storage_dtype(dt: t.DataType) -> torch.dtype:
    """torch dtype of the device storage lane of logical type `dt`."""
    return torch_dtype(t.physical_np_dtype(dt))


@dataclasses.dataclass
class DeviceColumn:
    """One column on the device: padded data lane + validity lane.

    data      : tensor (capacity,) in the storage dtype; strings are int32
                codes into `dictionary`.
    validity  : bool tensor (capacity,); padding rows are False.
    dtype     : logical Spark type.
    dictionary: host numpy array of the sorted unique strings (STRING).
    value_range: exact (lo, hi) of the valid integer values, where the
                expression that made the column knows one (a cast of a
                string: plan/expressions.DevVal); the group-by packs
                such a key.
    hi        : the high word of a DECIMAL wider than 18 digits (int64,
                capacity), or None: the value is `data` itself.  Every
                operator that moves rows moves it (`take`).

    A ragged ARRAY column (the reference's values+offsets layout):
    offsets   : int32 (row capacity + 1,); row i's elements are
                data[offsets[i]:offsets[i + 1]], a null or padding row an
                empty span.  `data` is then the flat values lane in its
                own bucket (`value_capacity`), with the element's
                dictionary, and `validity` stays per row.
    elem_valid: bool per value (null elements), the shape of `data`.
    """
    data: torch.Tensor
    validity: torch.Tensor
    dtype: t.DataType
    dictionary: Optional[np.ndarray] = None
    value_range: Optional[tuple] = None
    hi: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    elem_valid: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        return self.data.shape[0]

    @property
    def value_capacity(self) -> int:
        """The values lane's capacity of a ragged column."""
        return self.data.shape[0]

    def nbytes(self) -> int:
        """Device bytes of the padded lanes."""
        n = self.stored.numel() * self.stored.element_size() + \
            self.validity.numel()
        if self.hi is not None:
            n += self.hi.numel() * 8
        if self.offsets is not None:
            n += self.offsets.numel() * 4 + self.elem_valid.numel()
        return n

    @property
    def stored(self) -> torch.Tensor:
        """The data lane as the device holds it (a NarrowColumn's narrow
        lane): what byte counts read, without widening anything."""
        return self.data

    @property
    def data_dtype(self) -> torch.dtype:
        """The dtype `data` has (read without widening a narrow lane)."""
        return self.data.dtype

    def rebuilt(self, stored: torch.Tensor, validity: torch.Tensor,
                hi: Optional[torch.Tensor] = None,
                value_range=None) -> "DeviceColumn":
        """A column of the same kind over moved lanes (`stored` as
        `stored` gives it): what row moves (take, compaction, a lane
        gather, a re-bucketing) build."""
        return DeviceColumn(stored, validity, self.dtype, self.dictionary,
                            value_range, hi)

    def take(self, idx, live=None) -> "DeviceColumn":
        """The rows at `idx` (a tensor or a slice), validity ANDed with
        `live` when given; the high word comes along (a narrow lane
        stays narrow), and a ragged column's values with their rows."""
        valid = self.validity[idx]
        if live is not None:
            valid = valid & live
        if self.offsets is not None:
            return self._take_ragged(idx, valid)
        return self.rebuilt(self.stored[idx], valid,
                            None if self.hi is None else self.hi[idx])

    def _take_ragged(self, idx, valid) -> "DeviceColumn":
        """A ragged column's rows at `idx`: new offsets from the kept rows'
        lengths and one gather of the values lane through the value ->
        row map.  The output values bucket needs the value total on the
        host (one sync; a host decision under capture)."""
        off = self.offsets.to(torch.int64)
        starts = off[:-1][idx]
        lens = torch.where(valid, (off[1:] - off[:-1])[idx],
                           torch.zeros_like(starts))
        new_off = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                              device=off.device)
        new_off[1:] = torch.cumsum(lens, 0)
        total = int(new_off[-1])
        vcap = bucket_capacity(max(total, 1))
        j = torch.arange(vcap, dtype=torch.int64, device=off.device)
        row = torch.clamp(torch.searchsorted(new_off[1:], j, right=True),
                          max=max(lens.shape[0] - 1, 0))
        src = torch.clamp(starts[row] + j - new_off[row], 0,
                          max(self.value_capacity - 1, 0))
        ev = self.elem_valid[src] & (j < total)
        return dataclasses.replace(
            self, data=self.data[src], validity=valid,
            offsets=new_off.to(torch.int32), elem_valid=ev)

    def prefix(self, cap: int, copy: bool = False) -> "DeviceColumn":
        """The first `cap` rows (a shrink to a smaller bucket; `copy`
        releases the larger lanes).  A ragged column keeps its values
        lane whole behind the offsets' prefix (the reference's)."""
        if self.offsets is not None:
            off = self.offsets[:cap + 1]
            return dataclasses.replace(
                self, validity=self.validity[:cap].clone() if copy
                else self.validity[:cap],
                offsets=off.clone() if copy else off)
        cut = (lambda x: x[:cap].clone()) if copy else (lambda x: x[:cap])
        return self.rebuilt(cut(self.stored), cut(self.validity),
                            None if self.hi is None else cut(self.hi),
                            self.value_range)


class NarrowColumn(DeviceColumn):
    """A FOR-narrowed scan column (ops/encodings.py, the reference's
    `DeviceColumn.enc`): `lane` holds the exact values in a signed dtype
    narrower than the storage dtype of `dtype`.  `data` widens it to the
    storage dtype on first read (and keeps the widened lane): whatever
    reads a column's data sees its logical storage dtype, and only the
    encoded expression sites (plan/expressions.py) read `lane`.
    `enc` is ("for", lo, hi), the batch's live range."""

    def __init__(self, lane: torch.Tensor, validity: torch.Tensor,
                 dtype: t.DataType, dictionary=None, value_range=None,
                 enc: Optional[tuple] = None):
        self.lane = lane
        self.enc = enc
        super().__init__(None, validity, dtype, dictionary, value_range)

    @property
    def data(self) -> torch.Tensor:
        if self._wide is None:
            self._wide = self.lane.to(storage_dtype(self.dtype))
        return self._wide

    @data.setter
    def data(self, value) -> None:
        self._wide = value

    @property
    def capacity(self) -> int:
        return self.lane.shape[0]

    @property
    def stored(self) -> torch.Tensor:
        return self.lane

    @property
    def data_dtype(self) -> torch.dtype:
        return storage_dtype(self.dtype)

    def rebuilt(self, stored, validity, hi=None,
                value_range=None) -> "NarrowColumn":
        return NarrowColumn(stored, validity, self.dtype, self.dictionary,
                            value_range, self.enc)

    def __repr__(self):
        return (f"NarrowColumn({self.dtype.simple_string} as "
                f"{self.lane.dtype}, {self.enc})")


@dataclasses.dataclass
class DeviceBatch:
    """Device columns sharing one capacity and one logical row count.

    `num_rows` is a host int or a 0-d int tensor on the device: an
    operator whose output count is data-dependent may leave it there, and
    a consumer that needs the value syncs with `int(db.num_rows)`.

    `sel` is a lazy selection vector (`sql.join.lazySelection`): when
    set, the live rows are the rows where it is True, not a front prefix,
    and `num_rows` counts them.  A join whose parent reads liveness as a
    mask (an aggregation, another join's probe) emits one instead of
    compacting its output.  `thin` is the late-materialization state
    (columnar/lanes.ThinState, `sql.join.lateMaterialization.enabled`):
    the columns it lists are zero-length placeholders whose rows live in
    a source batch behind an int32 row-id lane.  Whatever slices or
    concatenates rows resolves both first (ops/batch_ops.ensure_prefix)
    and asserts that they are gone (`assert_prefix`): a zero-length
    placeholder sliced in PyTorch is silently empty, not a shape error."""
    columns: List[DeviceColumn]
    num_rows: object
    names: List[str]
    sel: Optional[torch.Tensor] = None
    thin: object = None
    #: scan provenance for input_file_name: "" = unknown, not a file,
    #: or several files
    origin_file: str = ""

    @property
    def capacity(self) -> int:
        if self.thin is not None:
            return self.thin.capacity
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.columns[0].validity.device

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def schema(self) -> t.StructType:
        return t.StructType([t.StructField(n, c.dtype)
                             for n, c in zip(self.names, self.columns)])

    def column(self, i: int) -> DeviceColumn:
        return self.columns[i]

    def column_by_name(self, name: str) -> DeviceColumn:
        return self.columns[self.names.index(name)]

    def select(self, indices) -> "DeviceBatch":
        """The batch with its columns reordered/subset by position (the
        selection vector and the deferred columns come along)."""
        return DeviceBatch([self.columns[i] for i in indices], self.num_rows,
                           [self.names[i] for i in indices], self.sel,
                           None if self.thin is None
                           else self.thin.select(indices), self.origin_file)

    def nbytes(self) -> int:
        """Device bytes of the padded lanes (capacity-based: no sync),
        the row-id lanes of a thin batch included."""
        n = sum(c.nbytes() for c in self.columns)
        if self.sel is not None:
            n += self.sel.numel()
        if self.thin is not None:
            n += self.thin.nbytes()
        return n

    def row_mask(self) -> torch.Tensor:
        """Bool mask of the live rows: the selection vector when there is
        one, else the live prefix (row < num_rows)."""
        if self.sel is not None:
            return self.sel
        from ..ops.kernels import live_mask
        return live_mask(self.capacity, self.num_rows, self.device)

    def assert_prefix(self) -> None:
        """Raise AssertionError unless the live rows are a front prefix
        and every column holds its rows: what slicing a row prefix
        needs."""
        assert self.sel is None and self.thin is None, \
            "a prefix consumer was handed a batch with a selection " \
            "vector or deferred columns (call ops.batch_ops.ensure_prefix)"

    def __repr__(self):
        return (f"DeviceBatch(rows={self.num_rows}/cap={self.capacity}, "
                f"{self.schema.simple_string})")


# ---------------------------------------------------------------------------
# Host -> device
# ---------------------------------------------------------------------------

def merge_origin(origins) -> str:
    """Provenance of data merged from several batches or files: the one
    shared file, or "" for mixed or unknown (input_file_name's rule)."""
    s = {o or "" for o in origins}
    return s.pop() if len(s) == 1 else ""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means "cuda".  Raises when
    CUDA is asked for and no CUDA device is present, so nothing carries
    on on the CPU unless the caller passes device="cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU explicitly")
    return device


#: host-to-device bytes `to_device` copied in this process, its batches,
#: and the host nanoseconds spent narrowing lanes (`narrowed_lane`;
#: `reset_upload_counts` zeroes them before a measured run)
UPLOADS = {"bytes": 0, "batches": 0, "narrow_ns": 0}


def reset_upload_counts() -> None:
    for k in UPLOADS:
        UPLOADS[k] = 0


def _upload(arr: np.ndarray, capacity: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Zero-padded device copy of a host lane (one host->device copy of
    the live rows; the padding is filled on the device)."""
    out = torch.zeros(capacity, dtype=dtype, device=device)
    if len(arr):
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:        # e.g. a view of an Arrow buffer
            arr = arr.copy()
        out[:len(arr)].copy_(torch.from_numpy(arr))
        UPLOADS["bytes"] += arr.nbytes
    return out


def narrowable(col: HostColumn) -> bool:
    """An integer-family, DATE, TIMESTAMP or one-lane DECIMAL column
    (not a string's codes, a DOUBLE or a boolean), which a scan may
    upload FOR-narrowed."""
    return col.hi is None and col.offsets is None and \
        col.data.dtype.kind == "i" and \
        not isinstance(col.dtype, (t.StringType, t.NullType)) and \
        col.data.dtype == np.dtype(t.physical_np_dtype(col.dtype))


def narrowed_lane(table: HostBatch, name: str, offset: int, length: int):
    """(the narrowed host lane, lo, hi) of rows offset..offset+length of
    a column, or None where it does not narrow: the smallest signed
    dtype holding [min(lo, 0), max(hi, 0)] of the slice's live values
    (ops/encodings.narrow_np_dtype, the reference's per-batch choice).
    Cached beside the table's statistics, keyed by (column, slice), so a
    warm query pays only the copy; the cache holds at most the narrowed
    columns' rows at their narrow width."""
    key = ("narrowed", name, offset, length)
    hit = table._stats.get(key, key)
    if hit is not key:
        return hit
    from ..ops.encodings import narrow_np_dtype
    t0 = time.perf_counter_ns()
    col = table.column_by_name(name)
    out = None
    if narrowable(col) and length:
        data = col.data[offset:offset + length]
        live = data if col.validity is None \
            else data[col.validity[offset:offset + length]]
        if live.size:
            lo, hi = int(live.min()), int(live.max())
            ndt = narrow_np_dtype(min(lo, 0), max(hi, 0), data.dtype)
            if ndt is not None:
                out = (data.astype(ndt), lo, hi)
    table._stats[key] = out
    UPLOADS["narrow_ns"] += time.perf_counter_ns() - t0
    return out


def column_to_device(col: HostColumn, capacity: int, device: torch.device,
                     narrowed=None) -> DeviceColumn:
    """One host column on the device; `narrowed` ((lane, lo, hi) from
    `narrowed_lane`) uploads the narrow lane as a NarrowColumn."""
    n = len(col)
    if col.validity is None:
        validity = torch.arange(capacity, device=device) < n
    else:
        validity = _upload(col.validity, capacity, torch.bool, device)
    if col.offsets is not None:
        # a ragged column: the values lane in its own bucket (never
        # narrowed), the offsets held at the last value past the rows
        nv = len(col.data)
        vcap = bucket_capacity(max(nv, 1))
        off = np.full(capacity + 1, int(col.offsets[-1]), np.int32)
        off[:n + 1] = col.offsets
        ev = torch.arange(vcap, device=device) < nv \
            if col.elem_valid is None else \
            _upload(col.elem_valid, vcap, torch.bool, device)
        return DeviceColumn(
            _upload(col.data, vcap, storage_dtype(col.dtype), device),
            validity, col.dtype, col.dictionary, None, None,
            _upload(off, capacity + 1, torch.int32, device), ev)
    if narrowed is not None:
        lane, lo, hi = narrowed
        from ..ops.encodings import count_dispatch
        count_dispatch("narrow_upload")
        return NarrowColumn(
            _upload(lane, capacity, torch_dtype(lane.dtype), device),
            validity, col.dtype, col.dictionary, None, ("for", lo, hi))
    sdt = storage_dtype(col.dtype)
    data = _upload(col.data, capacity, sdt, device)
    hi = None if col.hi is None else \
        _upload(col.hi, capacity, torch.int64, device)
    return DeviceColumn(data, validity, col.dtype, col.dictionary, None, hi)


def to_device(hb: HostBatch, conf: TpuConf = DEFAULT_CONF,
              capacity: Optional[int] = None, device=None,
              narrowed: Optional[dict] = None) -> DeviceBatch:
    """Upload a host batch into a bucket-capacity device batch
    (`device` as in `resolve_device`); `narrowed` maps a column index to
    its narrowed lane (`narrowed_lane`, a scan's encoded columns)."""
    device = resolve_device(device)
    cap = capacity or bucket_capacity(max(hb.num_rows, 1), conf)
    narrowed = narrowed or {}
    cols = [column_to_device(c, cap, device, narrowed.get(i))
            for i, c in enumerate(hb.columns)]
    UPLOADS["batches"] += 1
    return DeviceBatch(cols, hb.num_rows, list(hb.names))


def empty_device_batch(schema: t.StructType, conf: TpuConf = DEFAULT_CONF,
                       device=None) -> DeviceBatch:
    cols = []
    for f in schema.fields:
        dt = f.data_type
        elem = dt.element_type if isinstance(dt, t.ArrayType) else dt
        dictionary = np.array([], str) \
            if isinstance(elem, t.StringType) else None
        col = HostColumn(np.zeros(0, t.physical_np_dtype(elem)), None,
                         elem, dictionary)
        if isinstance(dt, t.ArrayType):
            col = list_column(col, np.zeros(1, np.int64))
        cols.append(col)
    return to_device(HostBatch(cols, schema.names), conf, device=device)


# ---------------------------------------------------------------------------
# Device -> host
# ---------------------------------------------------------------------------

def to_host(db: DeviceBatch, rows: int) -> HostBatch:
    """The first `rows` rows of every column, brought to the host (a
    selection vector or deferred columns resolve first)."""
    from ..ops.batch_ops import ensure_prefix
    db = ensure_prefix(db)
    db.assert_prefix()
    cols = []
    for c in db.columns:
        valid = c.validity[:rows].cpu().numpy()
        if c.offsets is not None:
            off = c.offsets[:rows + 1].cpu().numpy()
            nv = int(off[-1]) if len(off) else 0
            ev = c.elem_valid[:nv].cpu().numpy()
            cols.append(HostColumn(
                c.data[:nv].cpu().numpy(), None if valid.all() else valid,
                c.dtype, c.dictionary, None, off.astype(np.int32),
                None if ev.all() else ev))
            continue
        data = c.data[:rows].cpu().numpy()
        hi = None if c.hi is None else c.hi[:rows].cpu().numpy()
        cols.append(HostColumn(data, None if valid.all() else valid,
                               c.dtype, c.dictionary, hi))
    return HostBatch(cols, list(db.names))


def fetch_result_batch(db: DeviceBatch, bound: Optional[int] = None,
                       conf: Optional[TpuConf] = None) -> HostBatch:
    """Bring a RESULT batch to the host: only its live prefix (operator
    outputs keep live rows at the front — aggregates emit groups first,
    sorts order padding last), never the padded capacity.  A lazy count
    costs one scalar sync; a static `bound` caps the rows fetched.  A
    selection vector or deferred columns resolve first."""
    from ..ops.batch_ops import ensure_prefix
    db = ensure_prefix(db, conf or DEFAULT_CONF)
    db.assert_prefix()
    n = int(db.num_rows)
    if bound is not None:
        n = min(n, bound)
    return to_host(db, min(n, db.capacity))
