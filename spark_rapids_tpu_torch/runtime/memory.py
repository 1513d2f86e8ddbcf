"""Device-memory budget and spill store (the RMM / spill framework role).

Counterpart of spark_rapids_tpu/runtime/memory.py.  Every long-lived
batch an operator holds across blocking points is registered with the
query's `MemoryBudget` as a `Spillable`; admitting a new reservation
spills least-recently-used device batches to the host until the budget
fits, and a host byte limit overflows the oldest host batches to disk.
The reactive half (a `torch.cuda.OutOfMemoryError` leaking past the
budget) is runtime/retry.py's.  Each admission fires the `reserve` chaos
site and counts toward `sql.test.injectRetryOOM`; the disk tier's writes
and reads fire `spill_write` and `spill_read` inside their `retry_io`
(runtime/faults.py).

The tiers differ from the reference's in their formats only:

  * **host** — the batch's lanes as CPU tensors, pinned when the batch
    came from the card and copied with `non_blocking=True`; the copy is
    waited for before the lanes are read.  The tier keeps the
    dictionaries, logical types, names and row count beside them.  (The
    reference keeps an Arrow batch; the card's machine has no pyarrow.)
  * **disk** — one block file per batch: a header (magic, version, lane
    count, payload length, `zlib.crc32` of the payload) then the raw lane
    bytes.  A block that fails its check raises `CorruptBlockError`.

The budget's limit is `memory.tpu.budgetBytes` when set, else
`memory.tpu.allocFraction` x the card's total memory
(`torch.cuda.mem_get_info`) for a CUDA context, else 0: unlimited
(accounting runs, nothing spills).
"""
from __future__ import annotations

import os
import shutil
import struct
import tempfile
import threading
import time
import weakref
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

from ..columnar.device import DeviceBatch, DeviceColumn
from ..config import (HBM_BUDGET_BYTES, HBM_BUDGET_FRACTION,
                      HOST_SPILL_LIMIT_BYTES, OOC_RESIDENT_FRACTION,
                      TEST_INJECT_RETRY_OOM, TpuConf)


class TpuRetryOOM(RuntimeError):
    """Budget exhausted; the retry framework catches this
    and replays the attempt (the GpuRetryOOM analogue)."""


class TpuSplitAndRetryOOM(TpuRetryOOM):
    """Retry after splitting the input (GpuSplitAndRetryOOM)."""


class CorruptBlockError(RuntimeError):
    """A spill block failed verification: the bytes the query needs are
    gone, so no retry can help."""

    def __init__(self, msg: str, path: Optional[str] = None):
        super().__init__(msg)
        self.path = path


def is_oom_error(exc: BaseException) -> bool:
    """The budget's OOM, the CUDA caching allocator's, or a kernel launch
    refused with cudaErrorMemoryAllocation (ops/hopper CudaLaunchError
    code 2)."""
    return isinstance(exc, (TpuRetryOOM, torch.cuda.OutOfMemoryError)) \
        or getattr(exc, "cuda_code", None) == 2


class DeviceCensus:
    """Live and peak budget-admitted bytes summed over every budget of
    the process (the reference's obs/memattr.py census): a serving
    tenant's bytes never inflate another query's per-budget peak."""

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
        self.peak = 0

    def register(self, budget) -> list:
        """-> a cell `[live bytes]` the budget keeps current; a collected
        budget's remaining bytes retire with it."""
        cell = [0]
        weakref.finalize(budget, self._retire, cell)
        return cell

    def _retire(self, cell: list) -> None:
        self.adjust(-cell[0])
        cell[0] = 0

    def adjust(self, delta: int) -> int:
        with self._lock:
            self.total = max(self.total + int(delta), 0)
            self.peak = max(self.peak, self.total)
            return self.total

    def totals(self) -> dict:
        with self._lock:
            return {"live_bytes": self.total, "peak_bytes": self.peak}


#: THE census every MemoryBudget reports into
CENSUS = DeviceCensus()


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """Total bytes of a CUDA device's memory; None for any other."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


class MemoryBudget:
    """Per-query (ExecContext) budget over registered Spillables.

    `limit == 0` means unlimited.  Every change holds one re-entrant
    lock, so threads may share a budget."""

    def __init__(self, conf: TpuConf, device: torch.device):
        limit = conf.get(HBM_BUDGET_BYTES)
        if limit == 0:
            total = device_memory_bytes(device)
            limit = int(total * conf.get(HBM_BUDGET_FRACTION)) if total \
                else 0
        self.limit = limit
        self.host_limit = conf.get(HOST_SPILL_LIMIT_BYTES)
        self.conf = conf
        self.live = 0                 # bytes of registered device batches
        self.host_live = 0
        self._lock = threading.RLock()   # re-entrant: the spill chain
        self._spillables: "OrderedDict[int, Spillable]" = OrderedDict()
        self._next_id = 0
        self._disk_dir: Optional[str] = None
        self._tls = threading.local()   # per-thread attempt scopes
        # sql.test.injectRetryOOM: TpuRetryOOM once, at the Nth
        # reservation (1-based); the chaos harness's `reserve` site fires
        # once per admission
        self._inject_at = conf.get(TEST_INJECT_RETRY_OOM)
        self._reservations = 0
        from .faults import get_injector
        self._injector = get_injector(conf)
        self.metrics = {"spilled_batches": 0, "spilled_bytes": 0,
                        "disk_batches": 0, "disk_bytes": 0,
                        "spill_ms": 0.0, "oom_retries": 0,
                        "batch_splits": 0, "peak_bytes": 0,
                        "release_underflow": 0, "io_retries": 0,
                        "attempt_rollback_bytes": 0}
        self._census_cell = CENSUS.register(self)

    def rebase(self, device_bytes: int) -> None:
        """Lower the limit to `sql.ooc.residentFraction` x `device_bytes`
        when that is under it (the out-of-core rung's answer to an
        allocator OOM below the budget, exec/ooc.escalate): of the bytes
        this process can really hold, that share for the batches the
        budget admits and the rest for the operators' working set, which
        the budget does not see (a 4M-row partial aggregation's sort, 2.3
        GiB at TPC-H SF10)."""
        cap = max(int(device_bytes * self.conf.get(OOC_RESIDENT_FRACTION)),
                  1)
        with self._lock:
            self.limit = min(self.limit, cap) if self.limit else cap

    # -- registration ------------------------------------------------------
    def register(self, sp: "Spillable") -> int:
        with self._lock:
            self._next_id += 1
            self._spillables[self._next_id] = sp
            return self._next_id

    def unregister(self, sid: int):
        with self._lock:
            self._spillables.pop(sid, None)

    def touch(self, sid: int):
        """LRU bump: the most recently used spills last."""
        with self._lock:
            if sid in self._spillables:
                self._spillables.move_to_end(sid)

    # -- attempt scopes (retry-ladder rollback) ----------------------------
    def _scopes(self) -> list:
        st = getattr(self._tls, "scopes", None)
        if st is None:
            st = self._tls.scopes = []
        return st

    @contextmanager
    def track_attempt(self):
        """Track this thread's net naked reservations (direct reserve /
        release pairs; Spillable-owned bytes excluded) so the retry
        ladder can release what a failed attempt leaked."""
        scope = _AttemptScope()
        st = self._scopes()
        st.append(scope)
        try:
            yield scope
        finally:
            st.pop()

    def rollback_attempt(self, scope: "_AttemptScope"):
        """Release the positive leftover of a failed attempt's naked
        reservations (after its scope exited)."""
        leftover = scope.naked
        if leftover > 0:
            self.release(leftover, _tracked=False)
            with self._lock:
                self.metrics["attempt_rollback_bytes"] += leftover
                # reserve() counted these bytes into every open scope:
                # the enclosing rungs must not release them again
                for outer in self._scopes():
                    outer.naked -= leftover
        scope.naked = 0

    # -- accounting --------------------------------------------------------
    def reserve(self, nbytes: int, _tracked: bool = True):
        """Admit `nbytes` of new device data, spilling LRU batches first;
        TpuRetryOOM when even spilling everything cannot fit them."""
        with self._lock:
            self._reservations += 1
            if self._inject_at and self._reservations == self._inject_at:
                self.metrics["oom_retries"] += 1
                raise TpuRetryOOM("injected OOM "
                                  f"(reservation #{self._reservations})")
            self._injector.fire("reserve")
            if self.limit:
                while self.live + nbytes > self.limit:
                    if not self._spill_one():
                        raise TpuRetryOOM(
                            f"device budget exhausted: live={self.live} "
                            f"+ {nbytes} > limit={self.limit} with "
                            "nothing left to spill")
            self.live += nbytes
            if _tracked:
                for scope in self._scopes():
                    scope.naked += nbytes
            self.metrics["peak_bytes"] = max(self.metrics["peak_bytes"],
                                             self.live)
            self._census_cell[0] = self.live
            CENSUS.adjust(nbytes)

    def release(self, nbytes: int, _tracked: bool = True):
        with self._lock:
            prev = self.live
            self.live -= nbytes
            if _tracked:
                for scope in self._scopes():
                    scope.naked -= nbytes
            if self.live < 0:
                # a double release: clamp so the budget does not widen,
                # and count it (the tests hold it at 0)
                self.metrics["release_underflow"] += 1
                self.live = 0
            self._census_cell[0] = self.live
            CENSUS.adjust(self.live - prev)

    def _spill_one(self) -> bool:
        for sp in self._spillables.values():
            if sp.on_device:
                sp.spill()
                return True
        return False

    def spill_all(self):
        """The reactive path (runtime/retry.py): push every held batch
        off the device before replaying a failed attempt."""
        with self._lock:
            for sp in list(self._spillables.values()):
                if sp.on_device:
                    sp.spill()

    # -- host tier ---------------------------------------------------------
    def host_reserve(self, nbytes: int):
        with self._lock:
            while self.host_limit and \
                    self.host_live + nbytes > self.host_limit:
                if not self._disk_one():
                    break        # the disk tier is unbounded: never refuse
            self.host_live += nbytes

    def host_release(self, nbytes: int):
        with self._lock:
            self.host_live -= nbytes
            if self.host_live < 0:
                self.metrics["release_underflow"] += 1
                self.host_live = 0

    def _disk_one(self) -> bool:
        for sp in self._spillables.values():
            if sp.on_host:
                sp.to_disk()
                return True
        return False

    def disk_dir(self) -> str:
        """The budget's spill directory (under TMPDIR), removed with the
        budget."""
        if self._disk_dir is None:
            self._disk_dir = tempfile.mkdtemp(prefix="srtpu_spill_")
            weakref.finalize(self, shutil.rmtree, self._disk_dir, True)
        return self._disk_dir


class _AttemptScope:
    """Net naked-reservation delta of one retry attempt on one thread."""

    __slots__ = ("naked",)

    def __init__(self):
        self.naked = 0


_MAGIC = b"SRTSPILL"
_VERSION = 1
_HEADER = struct.Struct("<8sIIQI")   # magic, version, lanes, bytes, crc32


def _lane_bytes(lanes: List[torch.Tensor]) -> int:
    return sum(x.numel() * x.element_size() for x in lanes)


def _byte_view(x: torch.Tensor) -> memoryview:
    """The raw bytes of a contiguous CPU tensor, without a copy."""
    return memoryview(x.contiguous().view(torch.uint8).numpy())


def write_block(path: str, lanes: List[torch.Tensor]) -> int:
    """Write CPU lanes as one checksummed block file; -> payload bytes."""
    views = [_byte_view(x) for x in lanes]
    crc = 0
    for v in views:
        crc = zlib.crc32(v, crc)
    payload = sum(v.nbytes for v in views)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, len(views), payload, crc))
        for v in views:
            f.write(v)
    return payload


def read_block(path: str, layout: List[Tuple[torch.dtype, int]]
               ) -> List[torch.Tensor]:
    """Read and verify a block written by `write_block`; `layout` is each
    lane's (dtype, length).  CorruptBlockError when the magic, the lane
    count, the length or the checksum disagree."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        buf = bytearray(f.read())
    if len(head) != _HEADER.size:
        raise CorruptBlockError(f"spill block {path} has no header", path)
    magic, version, nlanes, payload, crc = _HEADER.unpack(head)
    want = sum(torch.empty(0, dtype=dt).element_size() * n
               for dt, n in layout)
    if magic != _MAGIC or version != _VERSION or nlanes != len(layout) \
            or payload != len(buf) or payload != want:
        raise CorruptBlockError(f"spill block {path} is malformed", path)
    if zlib.crc32(buf) != crc:
        raise CorruptBlockError(
            f"spill block {path} failed its checksum", path)
    lanes, off = [], 0
    for dt, n in layout:
        size = torch.empty(0, dtype=dt).element_size() * n
        lanes.append(torch.frombuffer(buf, dtype=torch.uint8, count=size,
                                      offset=off).view(dt) if size
                     else torch.empty(0, dtype=dt))
        off += size
    return lanes


class Spillable:
    """A batch an operator holds across blocking points, owned by the
    budget: device <-> pinned host lanes <-> disk block
    (SpillableColumnarBatch and the three RapidsBufferStore tiers)."""

    def __init__(self, db: DeviceBatch, budget: MemoryBudget,
                 live_nbytes: Optional[int] = None):
        self._db: Optional[DeviceBatch] = db
        self._host: Optional[List[torch.Tensor]] = None
        self._ready: Optional[torch.cuda.Event] = None
        self._path: Optional[str] = None
        self._budget = budget
        self._nbytes = db.nbytes()
        # the bytes of its live rows, where the caller measured them (an
        # out-of-core operator sizes its buckets by these, not by padding)
        self.live_nbytes = self._nbytes if live_nbytes is None \
            else live_nbytes
        # what the lanes do not hold: kept beside every tier
        self._meta = [(c.dtype, c.dictionary, c.data.dtype, c.hi is not None)
                      for c in db.columns]
        self._names = list(db.names)
        self._capacity = db.capacity
        self._device = db.device
        # a device-resident row count stays there until someone needs
        # the host value (a spill does anyway)
        self._num_rows = db.num_rows
        # untracked: the spillable owns these bytes' lifecycle
        budget.reserve(self._nbytes, _tracked=False)
        self._sid = budget.register(self)
        self._closed = False

    @property
    def num_rows(self) -> int:
        if not isinstance(self._num_rows, int):
            self._num_rows = int(self._num_rows)
        return self._num_rows

    @property
    def on_device(self) -> bool:
        return self._db is not None

    @property
    def on_host(self) -> bool:
        return self._host is not None

    @property
    def on_disk(self) -> bool:
        return self._path is not None

    @property
    def nbytes(self) -> int:
        """Device bytes this spillable reserves when materialized."""
        return self._nbytes

    @property
    def closed(self) -> bool:
        return self._closed

    def _layout(self) -> List[Tuple[torch.dtype, int]]:
        out = []
        for _dt, _d, sdt, wide in self._meta:
            out += [(sdt, self._capacity), (torch.bool, self._capacity)]
            if wide:
                out.append((torch.int64, self._capacity))
        return out

    def spill(self):
        """device -> host tier.  Holds the budget lock: another thread's
        reserve() may drive it."""
        with self._budget._lock:
            if self._db is None:
                return
            t0 = time.perf_counter()
            db = self._db
            self._num_rows = self.num_rows
            pin = db.device.type == "cuda"
            host = []
            for c in db.columns:
                lanes = (c.data, c.validity) if c.hi is None \
                    else (c.data, c.validity, c.hi)
                for lane in lanes:
                    h = torch.empty(lane.shape, dtype=lane.dtype,
                                    pin_memory=pin)
                    h.copy_(lane, non_blocking=pin)
                    host.append(h)
            ready = None
            if pin:
                ready = torch.cuda.Event()
                ready.record()
            self._db = None
            self._budget.release(self._nbytes, _tracked=False)
            m = self._budget.metrics
            m["spilled_batches"] += 1
            m["spilled_bytes"] += self._nbytes
            m["spill_ms"] += (time.perf_counter() - t0) * 1e3
            # reserve BEFORE publishing the host tier: host_reserve may
            # drive _disk_one(), which must not find this batch on_host
            self._budget.host_reserve(_lane_bytes(host))
            self._host, self._ready = host, ready

    def _host_lanes(self) -> List[torch.Tensor]:
        """The host tier's lanes once their copy from the card is done."""
        if self._ready is not None:
            self._ready.synchronize()
            self._ready = None
        return self._host

    def to_disk(self):
        """host -> disk tier (holds the budget lock)."""
        with self._budget._lock:
            if self._host is None:
                return
            from .retry import retry_io
            host = self._host_lanes()
            path = os.path.join(self._budget.disk_dir(),
                                f"spill_{self._sid}.blk")
            t0 = time.perf_counter()
            nbytes = retry_io(self._budget.conf, "spill_write",
                              lambda: write_block(path, host),
                              budget=self._budget)
            m = self._budget.metrics
            m["spill_ms"] += (time.perf_counter() - t0) * 1e3
            m["disk_batches"] += 1
            m["disk_bytes"] += nbytes
            self._budget.host_release(_lane_bytes(host))
            self._host = None
            self._path = path

    def _read_disk(self) -> List[torch.Tensor]:
        from .retry import retry_io
        path = self._path
        t0 = time.perf_counter()
        lanes = retry_io(self._budget.conf, "spill_read",
                         lambda: read_block(path, self._layout()),
                         budget=self._budget, info={"path": path})
        self._budget.metrics["spill_ms"] += (time.perf_counter() - t0) * 1e3
        return lanes

    def get(self) -> DeviceBatch:
        """The batch on the device, re-uploaded through the budget when
        it was spilled.  The returned batch stays valid if the spillable
        spills again."""
        with self._budget._lock:
            if self._db is None:
                lanes = self._host_lanes() if self._host is not None \
                    else self._read_disk()
                if self._db is None:
                    self._budget.reserve(self._nbytes, _tracked=False)
                    dev = self._device
                    up = [x.to(dev, non_blocking=x.is_pinned())
                          for x in lanes]
                    it = iter(up)
                    cols = [DeviceColumn(next(it), next(it), dt, d, None,
                                         next(it) if wide else None)
                            for dt, d, _s, wide in self._meta]
                    self._db = DeviceBatch(cols, self._num_rows,
                                           list(self._names))
                    if self._host is not None:
                        self._budget.host_release(_lane_bytes(self._host))
                    self._host = None
                    if self._path is not None:
                        _unlink(self._path)
                        self._path = None
            self._budget.touch(self._sid)
            return self._db

    def close(self):
        """Release every tier still held (device reservation, host bytes,
        disk block).  IDEMPOTENT BY CONTRACT: the out-of-core operators
        close handles in their bucket loops and again in their `finally`
        sweeps, which an abandoned generator (a LIMIT above) reaches with
        some handles closed; a second close releases nothing twice."""
        with self._budget._lock:
            self._closed = True
            self._budget.unregister(self._sid)
            if self._db is not None:
                self._budget.release(self._nbytes, _tracked=False)
                self._db = None
            if self._host is not None:
                self._budget.host_release(_lane_bytes(self._host))
                self._host = None
                self._ready = None
            if self._path is not None:
                _unlink(self._path)
                self._path = None


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
