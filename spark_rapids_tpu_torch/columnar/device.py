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
from typing import List, Optional

import numpy as np
import torch

from .. import types as t
from ..config import DEFAULT_CONF, TpuConf
from .host import HostBatch, HostColumn


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
    """
    data: torch.Tensor
    validity: torch.Tensor
    dtype: t.DataType
    dictionary: Optional[np.ndarray] = None
    value_range: Optional[tuple] = None
    hi: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def take(self, idx, live=None) -> "DeviceColumn":
        """The rows at `idx` (a tensor or a slice), validity ANDed with
        `live` when given; the high word comes along."""
        valid = self.validity[idx]
        if live is not None:
            valid = valid & live
        return DeviceColumn(self.data[idx], valid, self.dtype,
                            self.dictionary, None,
                            None if self.hi is None else self.hi[idx])


@dataclasses.dataclass
class DeviceBatch:
    """Device columns sharing one capacity and one logical row count.

    `num_rows` is a host int or a 0-d int tensor on the device: an
    operator whose output count is data-dependent may leave it there, and
    a consumer that needs the value syncs with `int(db.num_rows)`."""
    columns: List[DeviceColumn]
    num_rows: object
    names: List[str]

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

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
        """The batch with its columns reordered/subset by position."""
        return DeviceBatch([self.columns[i] for i in indices], self.num_rows,
                           [self.names[i] for i in indices])

    def nbytes(self) -> int:
        """Device bytes of the padded lanes (capacity-based: no sync)."""
        return sum(c.data.numel() * c.data.element_size() +
                   c.validity.numel() +
                   (0 if c.hi is None else c.hi.numel() * 8)
                   for c in self.columns)

    def row_mask(self) -> torch.Tensor:
        """Bool mask of the live prefix (row < num_rows)."""
        from ..ops.kernels import live_mask
        return live_mask(self.capacity, self.num_rows, self.device)

    def __repr__(self):
        return (f"DeviceBatch(rows={self.num_rows}/cap={self.capacity}, "
                f"{self.schema.simple_string})")


# ---------------------------------------------------------------------------
# Host -> device
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means "cuda".  Raises when
    CUDA is asked for and no CUDA device is present, so nothing carries
    on on the CPU unless the caller passes device="cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU explicitly")
    return device


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
    return out


def column_to_device(col: HostColumn, capacity: int,
                     device: torch.device) -> DeviceColumn:
    n = len(col)
    sdt = storage_dtype(col.dtype)
    data = _upload(col.data, capacity, sdt, device)
    if col.validity is None:
        validity = torch.arange(capacity, device=device) < n
    else:
        validity = _upload(col.validity, capacity, torch.bool, device)
    hi = None if col.hi is None else \
        _upload(col.hi, capacity, torch.int64, device)
    return DeviceColumn(data, validity, col.dtype, col.dictionary, None, hi)


def to_device(hb: HostBatch, conf: TpuConf = DEFAULT_CONF,
              capacity: Optional[int] = None,
              device=None) -> DeviceBatch:
    """Upload a host batch into a bucket-capacity device batch
    (`device` as in `resolve_device`)."""
    device = resolve_device(device)
    cap = capacity or bucket_capacity(max(hb.num_rows, 1), conf)
    cols = [column_to_device(c, cap, device) for c in hb.columns]
    return DeviceBatch(cols, hb.num_rows, list(hb.names))


def empty_device_batch(schema: t.StructType, conf: TpuConf = DEFAULT_CONF,
                       device=None) -> DeviceBatch:
    cols = []
    for f in schema.fields:
        dictionary = np.array([], str) \
            if isinstance(f.data_type, t.StringType) else None
        cols.append(HostColumn(np.zeros(0, t.physical_np_dtype(f.data_type)),
                               None, f.data_type, dictionary))
    return to_device(HostBatch(cols, schema.names), conf, device=device)


# ---------------------------------------------------------------------------
# Device -> host
# ---------------------------------------------------------------------------

def to_host(db: DeviceBatch, rows: int) -> HostBatch:
    """The first `rows` rows of every column, brought to the host."""
    cols = []
    for c in db.columns:
        data = c.data[:rows].cpu().numpy()
        valid = c.validity[:rows].cpu().numpy()
        hi = None if c.hi is None else c.hi[:rows].cpu().numpy()
        cols.append(HostColumn(data, None if valid.all() else valid,
                               c.dtype, c.dictionary, hi))
    return HostBatch(cols, list(db.names))


def fetch_result_batch(db: DeviceBatch, bound: Optional[int] = None,
                       conf: Optional[TpuConf] = None) -> HostBatch:
    """Bring a RESULT batch to the host: only its live prefix (operator
    outputs keep live rows at the front — aggregates emit groups first,
    sorts order padding last), never the padded capacity.  A lazy count
    costs one scalar sync; a static `bound` caps the rows fetched."""
    n = int(db.num_rows)
    if bound is not None:
        n = min(n, bound)
    return to_host(db, min(n, db.capacity))
