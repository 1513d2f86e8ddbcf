"""Host decisions under whole-plan capture (exec/compiled.py).

A CUDA graph records device work and replays it without Python: any
operator that reads a device value on the host while the graph is
captured (`int(db.num_rows)`, `.item()`, `.tolist()`, `bool()`, or an op
whose output shape depends on the data: `nonzero`, `masked_select`,
`unique`, `repeat_interleave` without `output_size`, a boolean index)
cannot be replayed.  Such a plan falls back to the eager engine, as the
reference's tracer-concretization errors do (`_TRACE_FALLBACK_ERRORS`).

  * `HostDecision` — the one error class that means "this plan needs a
    host decision"; nothing else falls back.
  * `capturing()` — True while this thread runs a plan for capture (the
    warm-up, the graph capture, the CPU detector run).  Operators that
    shrink a batch to its live rows on the eager path keep the static
    capacity and a device row count instead, as the reference does under
    its tracer.
  * `capture_scope(device)` — the scope that sets `capturing()` and runs
    `SyncDetector`, a TorchDispatchMode that raises HostDecision at every
    host read of a device value and every data-dependent shape.  On the
    CPU (the tests) this run IS the capture: there is no graph, and the
    plain versions are held to the kernels' sync-free contract, so the
    CPU sees the decisions the card makes.  On the card it guards the
    warm-up, before any graph exists; a sync it cannot see (one inside
    an op) fails the graph capture itself, which runs with
    `capture_error_mode="thread_local"`.  Both errors map to
    HostDecision (`map_capture_error`).  Nothing here changes a setting
    of the process: a query on another thread syncs as it always does.
  * `host_constant(array, device)` — a host array as a device tensor.
    Outside capture it uploads as before; in a graph's warm-up and
    capture it comes from pinned host memory kept alive with the graph
    (`graph_staging`), copied with `non_blocking=True`: a captured copy
    node that every replay repeats.  `recording()` tells the caches not
    to keep a tensor made while a graph records (it fills only when the
    graph replays).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class HostDecision(RuntimeError):
    """A plan read a device value on the host, or made a data-dependent
    shape, while it was captured: it runs on the eager engine."""


def _innermost_site(frames) -> str:
    """The port's innermost frame (outside this module) of `frames`,
    outermost first, as file:line: the site a HostDecision names."""
    here = __file__.rsplit("/", 1)[0].rsplit("/", 1)[0]
    site = "?"
    for f in frames:
        if f.filename.startswith(here) and \
                not f.filename.endswith("capture.py"):
            site = f"{f.filename[len(here) + 1:]}:{f.lineno}"
    return site


def _decision(what: str) -> HostDecision:
    """HostDecision naming `what` and the site that made it."""
    import traceback
    return HostDecision(f"{what} at "
                        f"{_innermost_site(traceback.extract_stack())}")


_TLS = threading.local()


def capturing() -> bool:
    """True while this thread runs a plan for capture."""
    return getattr(_TLS, "depth", 0) > 0


def recording() -> bool:
    """True while this thread records a CUDA graph: a tensor made now is
    filled only when the graph replays, so no cache may keep it."""
    return getattr(_TLS, "recording", False)


@contextlib.contextmanager
def recording_scope():
    """Mark this thread as recording a CUDA graph for the scope."""
    prev = getattr(_TLS, "recording", False)
    _TLS.recording = True
    try:
        yield
    finally:
        _TLS.recording = prev


def staging() -> Optional[dict]:
    """The pinned staging buffers of the graph this thread warms up or
    captures (None elsewhere)."""
    return getattr(_TLS, "stage", None)


_A = torch.ops.aten
#: ops whose output shape depends on the data (each syncs on the card)
_DATA_SHAPES = frozenset(
    op for op in (
        getattr(_A, n, None) for n in (
            "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
            "unique_consecutive", "argwhere", "bincount", "equal",
            "is_nonzero", "_local_scalar_dense"))
    if op is not None)


def _is_device(x, device: torch.device) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == device.type


class SyncDetector(TorchDispatchMode):
    """Raises HostDecision at each host read of a `device` tensor and at
    each data-dependent output shape.  On the CPU every tensor is a
    device tensor; on the card only CUDA tensors are."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_TLS, "detect", None) is None:      # host_reads_ok
            return func(*args, **kwargs)
        pk = func.overloadpacket
        if pk in _DATA_SHAPES:
            if any(_is_device(a, self.device) for a in args):
                raise _decision(f"{pk.__name__} reads a device value")
        elif pk is _A.repeat_interleave:
            if kwargs.get("output_size") is None and \
                    _is_device(args[0], self.device) and \
                    (len(args) > 1 and isinstance(args[1], torch.Tensor)
                     or isinstance(kwargs.get("repeats"), torch.Tensor)
                     or len(args) == 1):
                raise _decision("repeat_interleave without output_size")
        elif pk in (_A.index, _A.index_put, _A.index_put_):
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx or ()):
                raise _decision("a boolean index (a data-dependent shape)")
        elif pk in (_A._to_copy, _A.copy_) and self.device.type == "cuda":
            src = args[1] if pk is _A.copy_ else args[0]
            dst_cpu = (args[0].device.type == "cpu" if pk is _A.copy_
                       else str(kwargs.get("device", "")) == "cpu")
            if _is_device(src, self.device) and dst_cpu:
                raise _decision("a device-to-host copy")
        return func(*args, **kwargs)


_PATCH_LOCK = threading.Lock()
_PATCHED = {"n": 0, "numpy": None, "tolist": None}


def _guarded(name: str):
    orig = getattr(torch.Tensor, name)

    def method(self, *a, **k):
        det = getattr(_TLS, "detect", None)
        if det is not None and _is_device(self, det):
            raise _decision(f"Tensor.{name} reads a device value")
        return orig(self, *a, **k)
    return orig, method


def _install_guards() -> None:
    """`Tensor.numpy` and `Tensor.tolist` of a CPU tensor never reach the
    dispatcher: wrap them while any thread captures (they raise only on
    a capturing thread)."""
    with _PATCH_LOCK:
        if _PATCHED["n"] == 0:
            for name in ("numpy", "tolist"):
                orig, method = _guarded(name)
                _PATCHED[name] = orig
                setattr(torch.Tensor, name, method)
        _PATCHED["n"] += 1


def _remove_guards() -> None:
    with _PATCH_LOCK:
        _PATCHED["n"] -= 1
        if _PATCHED["n"] == 0:
            for name in ("numpy", "tolist"):
                setattr(torch.Tensor, name, _PATCHED[name])


@contextlib.contextmanager
def capture_scope(device: torch.device, detect: bool = True):
    """Run a plan for capture on this thread: `capturing()` is True, and
    with `detect` every host read of a `device` tensor raises
    HostDecision.  The detector is off inside a CUDA graph capture,
    where PyTorch refuses those reads itself."""
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    prev = getattr(_TLS, "detect", None)
    try:
        if not detect:
            yield
            return
        _TLS.detect = device
        _install_guards()
        try:
            with SyncDetector(device):
                yield
        finally:
            _remove_guards()
    finally:
        _TLS.detect = prev
        _TLS.depth -= 1


@contextlib.contextmanager
def host_reads_ok():
    """Suspend the detector on this thread for host math over CPU
    tensors that is no host decision on the card: a plain version's
    numpy twin of a device function, a constant computed on the host."""
    prev = getattr(_TLS, "detect", None)
    _TLS.detect = None
    try:
        yield
    finally:
        _TLS.detect = prev


@contextlib.contextmanager
def graph_staging(stage: dict):
    """Stage the host constants of one graph's warm-up and capture in
    `stage`, which the graph's owner keeps for the graph's life."""
    prev = getattr(_TLS, "stage", None)
    _TLS.stage = stage
    try:
        yield stage
    finally:
        _TLS.stage = prev


#: PyTorch's words for an operation refused while a stream captures
_CAPTURE_ERRORS = ("operation not permitted when stream is capturing",
                   "cudaErrorStreamCaptureUnsupported",
                   "cudaErrorStreamCaptureInvalidated",
                   "cudaErrorStreamCaptureImplicit")


def map_capture_error(e: BaseException) -> Optional[HostDecision]:
    """The HostDecision an error raised in a warm-up or a graph capture
    stands for (PyTorch's stream-capture refusals), naming the port's
    innermost frame; None when it is something else, which then
    propagates."""
    if isinstance(e, HostDecision):
        return e
    msg = str(e)
    if isinstance(e, RuntimeError) and any(w in msg for w in _CAPTURE_ERRORS):
        first = msg.strip().splitlines()[0][:160]
        import traceback
        site = _innermost_site(traceback.extract_tb(e.__traceback__))
        return HostDecision(f"{first} at {site}")
    return None


#: one capture at a time in the process: `torch.cuda.graph` synchronizes
#: the device and empties the allocator's cache as it starts
CAPTURE_LOCK = threading.RLock()


def host_constant(array, device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (numpy, a list or a CPU tensor) as a tensor on
    `device`.  Outside a graph it is a plain upload.  A graph's warm-up
    stages a pinned copy, keyed by its bytes, and copies from it with
    `non_blocking=True`; the capture copies from the same pinned buffer,
    a copy node that every replay repeats (a pageable upload synchronizes
    and cannot be captured)."""
    if isinstance(array, torch.Tensor):
        host = array
    else:
        a = np.asarray(array)
        host = torch.from_numpy(a if a.flags.writeable else a.copy())
    if dtype is not None:
        host = host.to(dtype)
    device = torch.device(device)
    stage = staging()
    if device.type != "cuda" or stage is None:
        return host.to(device)
    host = host.contiguous()
    key = (str(host.dtype), tuple(host.shape), host.numpy().tobytes())
    pinned = stage.get(key)
    if pinned is None:
        pinned = stage[key] = host.pin_memory()
    return pinned.to(device, non_blocking=True)
