"""Failure classes and device crash dumps (the GpuCoreDumpHandler role).

Counterpart of spark_rapids_tpu/runtime/failure.py.  Every error a query
raises falls in one of five classes (`classify`):

  * RETRYABLE — an OOM: the budget's `TpuRetryOOM`, the CUDA caching
    allocator's `torch.cuda.OutOfMemoryError`, or cudaErrorMemoryAllocation
    (2) at a kernel launch.  The retry ladder owns these.
  * FATAL_DEVICE — the sticky CUDA errors, after which the context is
    unusable: cudaErrorIllegalAddress (700), cudaErrorAssert (710),
    cudaErrorLaunchFailure (719) and cudaErrorECCUncorrectable (214),
    read from a kernel wrapper's `CudaLaunchError` code or from the text
    PyTorch raises them with.  The hosting process must exit.
  * CORRUPTION — a spill block failed its checksum: data loss.
  * IO — an OSError past the IO retry ladder.
  * QUERY — anything else: fail the query, keep the process.

`crash_capture(conf, ctx)` writes a dump on a fatal error to
`spark.rapids.tpu.coredump.path` and re-raises it as `FatalDeviceError`.
The dump holds the exception, its traceback and class, the card's name,
free/total memory and the allocator's peaks, the torch and CUDA versions,
the budget's counters, the query's metrics and the injected-fault record.
The reference's flight-recorder tail ports with the observability slice
(ROADMAP Queue 1 item 10): the dump says `"flight_recorder": null`.
The supervisor-side `write_worker_lost_dump` waits for the serving pool
(item 10).

`spark.rapids.tpu.test.injectFatalError` raises a synthetic fatal error
after N root batches, as `install_fault_injection` arms it beside the
chaos harness's `execute` site.
"""
from __future__ import annotations

import itertools
import json
import os
import time
import traceback
from contextlib import contextmanager
from typing import Optional

import torch

from .. import config as _config
from ..config import TpuConf, conf as _conf
from .memory import CorruptBlockError, is_oom_error

COREDUMP_PATH = _conf(
    "spark.rapids.tpu.coredump.path", "",
    "Directory for device crash dumps (GpuCoreDumpHandler role). Empty "
    "disables capture.")

INJECT_FATAL = _conf(
    "spark.rapids.tpu.test.injectFatalError", 0,
    "Test-only: raise a synthetic fatal device error after this many "
    "device batches (0 = off).", internal=True,
    checker=lambda v: None if v >= 0 else "must be >= 0")

_config.HONOURED_KEYS = _config.HONOURED_KEYS | {COREDUMP_PATH.key,
                                                 INJECT_FATAL.key}

RETRYABLE = "retryable"
FATAL_DEVICE = "fatal_device"
QUERY = "query"
IO = "io"
CORRUPTION = "corruption"

#: sticky CUDA error codes (cudaError_t) -> the text PyTorch raises them
#: with
STICKY_CUDA_ERRORS = {
    700: "illegal memory access",
    710: "device-side assert triggered",
    719: "unspecified launch failure",
    214: "uncorrectable ECC error",
}
_DUMP_SEQ = itertools.count()


class FatalDeviceError(RuntimeError):
    """The device or its context is unusable; the hosting process should
    exit (the CudaFatalException analogue)."""

    def __init__(self, msg: str, dump_path: Optional[str] = None):
        super().__init__(msg)
        self.dump_path = dump_path


class InjectedFatalError(Exception):
    """Synthetic fatal error from the fault-injection conf."""


def _device_error_classes() -> tuple:
    """The exception types PyTorch raises CUDA errors as (AcceleratorError
    where this torch has it, else RuntimeError)."""
    acc = getattr(torch, "AcceleratorError", None)
    return (RuntimeError,) if acc is None else (acc, RuntimeError)


def classify(exc: BaseException) -> str:
    if isinstance(exc, (FatalDeviceError, InjectedFatalError)):
        return FATAL_DEVICE
    if isinstance(exc, CorruptBlockError):
        return CORRUPTION
    if is_oom_error(exc):
        return RETRYABLE
    code = getattr(exc, "cuda_code", None)
    if code is not None:
        return FATAL_DEVICE if code in STICKY_CUDA_ERRORS else QUERY
    if isinstance(exc, _device_error_classes()):
        text = str(exc)
        if any(m in text for m in STICKY_CUDA_ERRORS.values()):
            return FATAL_DEVICE
    if isinstance(exc, OSError):
        return IO
    return QUERY


def _device_info(ctx) -> dict:
    """The card's name, memory and the allocator's peaks.  Each query may
    raise again after a sticky error, so each is guarded on its own."""
    dev = getattr(ctx, "device", None)
    if dev is None:
        dev = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    info = {"type": dev.type}
    if dev.type != "cuda":
        return info
    for key, read in (
            ("name", lambda: torch.cuda.get_device_name(dev)),
            ("mem_get_info", lambda: dict(zip(
                ("free_bytes", "total_bytes"),
                torch.cuda.mem_get_info(dev)))),
            ("memory_stats", lambda: {
                k: v for k, v in torch.cuda.memory_stats(dev).items()
                if k.endswith(".peak") and k.startswith(
                    ("allocated_bytes.all", "reserved_bytes.all"))})):
        try:
            info[key] = read()
        except Exception as e:                   # noqa: BLE001
            info[key] = f"unavailable: {e!r}"
    return info


def write_crash_dump(conf: TpuConf, exc: BaseException,
                     ctx=None) -> Optional[str]:
    """Serialize what a post-mortem needs next to the dying process.
    Returns the dump's path, or None when no dump directory is set."""
    dump_dir = conf.get(COREDUMP_PATH)
    if not dump_dir:
        return None
    os.makedirs(dump_dir, exist_ok=True)
    info = {
        "ts": time.time(),
        "pid": os.getpid(),
        "exception": repr(exc),
        "exception_class": type(exc).__name__,
        "traceback": traceback.format_exception(
            type(exc), exc, exc.__traceback__),
        "classification": classify(exc),
        # the reference's flight-recorder tail ports with ROADMAP Queue 1
        # item 10
        "flight_recorder": None,
        "device": _device_info(ctx),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if ctx is not None:
        info["query_metrics"] = dict(getattr(ctx, "metrics", {}))
        budget = getattr(ctx, "_budget", None)
        if budget is not None:
            info["memory_budget"] = dict(budget.metrics)
            info["memory_budget"]["live"] = int(budget.live)
            info["memory_budget"]["limit"] = int(budget.limit)
    from .faults import get_active_injector, get_injector
    for inj in (get_active_injector(), get_injector(conf)):
        if getattr(inj, "log", None):
            info["injected_faults"] = list(inj.log)
            break
    path = os.path.join(dump_dir,
                        f"tpu-coredump-{os.getpid()}-{int(time.time())}"
                        f"-{next(_DUMP_SEQ)}.json")
    with open(path, "w") as f:
        json.dump(info, f, indent=2, default=str)
    return path


@contextmanager
def crash_capture(conf: TpuConf, ctx=None):
    """On a fatal device error: write the dump, then re-raise as
    FatalDeviceError so the hosting process can exit."""
    try:
        yield
    except BaseException as exc:                 # noqa: BLE001
        if classify(exc) == FATAL_DEVICE and \
                not isinstance(exc, FatalDeviceError):
            path = write_crash_dump(conf, exc, ctx)
            raise FatalDeviceError(
                f"fatal device error: {exc!r}"
                + (f" (crash dump: {path})" if path else ""),
                dump_path=path) from exc
        raise


def install_fault_injection(root, conf: TpuConf) -> None:
    """Wrap a physical root's execute stream with the per-batch fault
    sites: the batch-count fatal injector and the chaos harness's
    `execute` site, which fire once per batch the root emits.  A root
    whose collect bypasses its stream (a global aggregate fetches its
    merged buffers) calls `root._fault_tick()` for its one batch."""
    from .faults import get_injector
    chaos = get_injector(conf)
    thr = int(conf.get(INJECT_FATAL))
    if (not thr and not chaos.has_site("execute")) or \
            getattr(root, "_fatal_injected", False):
        return
    inj = FatalInjector(conf)
    orig = root.execute

    def tick():
        inj.tick()
        chaos.fire("execute")

    def wrapped(ctx):
        for b in orig(ctx):
            tick()
            yield b

    root.execute = wrapped
    root._fault_tick = tick
    root._fatal_injected = True


class FatalInjector:
    """Counts root batches; raises at the configured threshold, once."""

    def __init__(self, conf: TpuConf):
        self.threshold = int(conf.get(INJECT_FATAL))
        self.count = 0

    def tick(self):
        if not self.threshold:
            return
        self.count += 1
        if self.count >= self.threshold:
            self.threshold = 0
            raise InjectedFatalError(
                "injected fatal device error "
                "(spark.rapids.tpu.test.injectFatalError)")
