"""Hand-written Hopper kernel tier.

Counterpart of spark_rapids_tpu/ops/pallas/__init__.py: the kernels the
JAX package wrote in Pallas for the TPU are written here by hand in CUDA
C++ for `sm_90a` (sources under csrc/), built with nvcc at first use and
bound through ctypes.  Three families: `segagg` (segmented aggregation),
`compact` (selection compaction) and `hashjoin` (hash-table build, the
unique-build probe, and the counted probe and pair expansion of
non-unique builds).  Every Pallas kernel of the JAX package has its
counterpart here.  This module holds what they share:

  * `KernelTier` / `kernel_tier` / `elect_segagg` / `elect_join` /
    `elect_compact` — the election.  The conf keys are the reference's
    (`sql.kernels.pallas.*`); the tier is on by default, segagg AUTO
    elects whenever the domain gate passes, and the join family's
    `join.denseReplace` defaults to ON here (AUTO in the reference):
    the hash table takes every join it can table, dense domains
    included, while AUTO and OFF weigh the dense direct-address tier as
    the reference does.  Each family's
    gate ends in `elect`, which fires the `kernel` chaos site: an OOM
    there sheds the operator onto its portable tier (the sorted
    group-by, the sorted join, the argsort compaction).  Which code runs
    is decided by where the tensors lie, never by
    `torch.cuda.is_available()`: a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes the kernel's plain PyTorch version.
  * `CudaLaunchError` / `check_launch` — a C entry point's CUDA error,
    with its code, which runtime/failure.classify reads.
  * `LAUNCHES` — a plain device-launch counter per kernel, raised by
    each wrapper where it launches its kernel and nowhere else, by the
    number of device launches of the kernel's own passes: every tile
    of `seg_sums`, the scan and the identity tail of
    `compaction_order`, the scan of the finals and the slot pass of
    `build_table`.  Helper launches (filling the output, converting it
    back) are not counted.
  * `StreamScratch` / `stream_scratch` — the scratch every kernel on
    one stream shares: segagg's flush tickets and the decoupled
    look-back's tile counter and status words (csrc/lookback.cuh),
    reused from launch to launch without a fill; `mask_tiles` — a
    look-back scan's tile geometry over a bool mask.
  * `build_libraries` / `library` — nvcc into `_build/` (one process per
    source, started together; the library name hashes the source, the
    shared csrc/*.cuh headers and the flags), then `ctypes.CDLL`.

The reference's dispatch metrics port with the observability slice
(ROADMAP Queue 1 item 10); a shed and every other fallback reason
(`count_fallback`) count in the query's metrics.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

from ...config import (IMPROVED_FLOAT_OPS, PALLAS_COMPACT, PALLAS_ENABLED,
                       PALLAS_JOIN, PALLAS_JOIN_DENSE_REPLACE,
                       PALLAS_JOIN_MAX_BUILD, PALLAS_SEGAGG,
                       PALLAS_SEGAGG_MAX_DOMAIN, TpuConf)

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> CUDA source file under csrc/
SOURCES = {"segagg": "segagg.cu", "compact": "compact.cu",
           "hashjoin": "hashjoin.cu"}

#: device launches per kernel (raised by the wrappers where they launch,
#: and only there)
LAUNCHES: Dict[str, int] = {"seg_sums": 0, "seg_reduce": 0,
                            "compaction_order": 0, "build_table": 0,
                            "probe_first": 0, "probe_counts": 0,
                            "expand_pairs": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Scratch shared by the kernels of one stream
# ---------------------------------------------------------------------------

#: segagg's flush tickets a stream: a launch takes one more than its fold
#: groups, at most ceil(sqrt(grid)) + 1 (18 for a 264-block grid); the
#: kernel refuses a launch they do not cover
TICKETS = 64
#: the status words tag their launch with an epoch of 30 bits
EPOCHS = 1 << 30


class StreamScratch:
    """Scratch of the kernels launched on one stream of one device.

    `tickets` int32[TICKETS + 1]: segagg's flush takes the first TICKETS,
    the look-back scan's tile counter is the last.  Each launch leaves
    them zero (its last arrivals reset what they took), so launches
    ordered on the stream share them.  `status` int64: one look-back
    word a tile (and after them build_layout's word a slot chunk),
    tagged with the epoch of the launch that wrote it;
    every look-back launch takes a new epoch, so what earlier launches
    left reads as "not yet" and needs no fill."""

    def __init__(self, device: torch.device):
        self.tickets = torch.zeros(TICKETS + 1, dtype=torch.int32,
                                   device=device)
        self.counter = self.tickets.data_ptr() + 4 * TICKETS
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.epoch = 0

    def lookback(self, tiles: int):
        """(status address, counter address, epoch) for one look-back
        launch over `tiles` tiles: at least `tiles` status words, the tile
        counter (the last ticket) and the launch's epoch in [1, EPOCHS)."""
        if self.status.numel() < tiles:
            # a new array is zero; the caching allocator hands the old
            # one only to later work on this stream, after its launches
            self.status = torch.zeros(max(tiles, 2 * self.status.numel()),
                                      dtype=torch.int64,
                                      device=self.status.device)
        self.epoch += 1
        if self.epoch == EPOCHS:
            # an epoch 2^30 launches old could match again: clear, once
            self.status.zero_()
            self.epoch = 1
        return self.status.data_ptr(), self.counter, self.epoch


_SCRATCH: Dict[tuple, StreamScratch] = {}
#: the scratch of the CUDA graph this thread captures (capture_scratch)
_TLS_CAPTURE = threading.local()


def stream_scratch(device: torch.device, stream: int) -> StreamScratch:
    """The one StreamScratch of (device, raw stream); while this thread
    captures a graph on `stream`, that graph's own (`capture_scratch`)."""
    cap = getattr(_TLS_CAPTURE, "scratch", None)
    if cap is not None and torch.cuda.is_current_stream_capturing():
        if cap[0] is None:
            cap[0] = StreamScratch(device)
        return cap[0]
    key = (device.type, device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = StreamScratch(device)
    return scratch


@contextlib.contextmanager
def capture_scratch(device: torch.device):
    """Give the graph captured on this thread its own StreamScratch, made
    inside the capture at its first look-back launch: the zero fills of
    its tickets and status words are then captured nodes that each
    replay repeats before the launches that read them, and the epochs
    count from 1 within the graph.  A replay therefore never reads the
    status words of the replay before it as "ready", which the eager
    scheme (a new epoch each launch, baked into the launch's arguments)
    would.  Yields a one-element list holding the scratch (None if the
    graph launched no look-back kernel); keep it as long as the graph."""
    prev = getattr(_TLS_CAPTURE, "scratch", None)
    holder = [None]
    _TLS_CAPTURE.scratch = holder
    try:
        yield holder
    finally:
        _TLS_CAPTURE.scratch = prev


def mask_tiles(ptr: int, cap: int, tile_rows: int):
    """(mis, tiles) of a look-back scan over a `cap`-row bool mask at
    address `ptr`: its offset from 16-byte alignment, so that each
    16-row chunk of a thread starts at an aligned address (rows before
    the first aligned address and past the last full 16 load one by
    one), and the number of `tile_rows`-row tiles that cover rows -mis ..
    cap - 1."""
    mis = ptr % 16
    return mis, -(-(cap + mis) // tile_rows)


# ---------------------------------------------------------------------------
# Election
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelTier:
    """Resolved per-conf kernel-tier decisions (static for a query)."""
    segagg: bool
    segagg_max_domain: int
    join: bool = False
    compact: bool = False
    join_max_build: int = 0
    join_dense_replace: str = "ON"      # AUTO | ON | OFF


NO_TIER = KernelTier(False, 0)


def _mode(conf: TpuConf, entry) -> bool:
    """AUTO and ON elect a family on either device; OFF disables it."""
    return str(conf.get(entry)).upper() in ("AUTO", "ON")


def kernel_tier(conf: TpuConf) -> KernelTier:
    """The resolved tier for this conf, cached on the conf instance."""
    tier = conf._cache.get("__hopper_tier")
    if tier is None:
        if not conf.get(PALLAS_ENABLED):
            tier = NO_TIER
        else:
            tier = KernelTier(
                segagg=_mode(conf, PALLAS_SEGAGG),
                segagg_max_domain=int(conf.get(PALLAS_SEGAGG_MAX_DOMAIN)),
                join=_mode(conf, PALLAS_JOIN),
                compact=_mode(conf, PALLAS_COMPACT),
                join_max_build=int(conf.get(PALLAS_JOIN_MAX_BUILD)),
                join_dense_replace=str(conf.get(PALLAS_JOIN_DENSE_REPLACE))
                .upper())
        conf._cache["__hopper_tier"] = tier
    return tier


def count_fallback(kernel: str, reason: str) -> None:
    """Count one operator that did not take `kernel`, and why, as
    `kernel_fallback.<kernel>.<reason>` in the active query's metrics
    (the reference's KERNEL_FALLBACK counter)."""
    from ...exec.plan import active_context
    ctx = active_context()
    if ctx is not None:
        ctx.bump(f"kernel_fallback.{kernel}.{reason}")


def elect(conf: TpuConf, kernel: str) -> bool:
    """The last step of every family's election: fires the `kernel`
    chaos site with the kernel in the injected-fault record.  An OOM
    there is the shed signal: the operator runs its portable tier,
    bit-identically, and `kernel_fallback.<kernel>.oom` counts it in
    the query's metrics; False.  Every other kind propagates to its own
    ladder.  Only the injected signal sheds: a kernel that fails to
    build or launch raises from its wrapper and is classified."""
    from ...runtime.faults import get_active_injector, get_injector
    from ...runtime.memory import TpuRetryOOM
    inj = get_injector(conf)
    if not inj.enabled:
        inj = get_active_injector()
    try:
        inj.fire("kernel", kernel=kernel)
    except TpuRetryOOM:
        count_fallback(kernel, "oom")
        return False
    return True


def elect_segagg(conf: TpuConf, total_domain: int,
                 has_float_sum: bool) -> Optional[KernelTier]:
    """Segmented-aggregation election: tier on, segagg family on, the
    packed key domain fits the block accumulator, and float sums may
    re-associate (variableFloatAgg: atomics add in run-dependent order)."""
    tier = kernel_tier(conf)
    if not tier.segagg or total_domain > tier.segagg_max_domain:
        return None
    if has_float_sum and not conf.get(IMPROVED_FLOAT_OPS):
        return None
    return tier if elect(conf, "segagg") else None


def elect_join(conf: TpuConf, build_capacity: int,
               dense_span: Optional[int] = None) -> Optional[KernelTier]:
    """Hash-table join election: tier on, join family on, the build side
    small enough to table (`join.maxBuildRows`, else a `build_too_large`
    fallback), and, when the join also qualifies for a dense
    direct-address table over `dense_span` keys, the `denseReplace`
    policy: ON always replaces it (the port's default), AUTO only past 4x
    the build capacity, where the dense tier's span-sized tables
    dominate, OFF never (a `dense_domain` fallback).  Lane-count
    legality finishes in ops/join.BuildTable.  None: the dense or the
    sorted tier takes the join (ops/join.py)."""
    tier = kernel_tier(conf)
    if not tier.join:
        return None
    if build_capacity > tier.join_max_build:
        count_fallback("hash_probe_join", "build_too_large")
        return None
    if dense_span is not None:
        mode = tier.join_dense_replace
        if not (mode == "ON" or
                (mode == "AUTO" and dense_span > 4 * build_capacity)):
            count_fallback("hash_probe_join", "dense_domain")
            return None
    return tier if elect(conf, "hash_probe_join") else None


#: below this capacity the argsort compaction's fixed cost wins (the
#: reference's floor)
COMPACT_MIN_CAPACITY = 1024


def elect_compact(conf: TpuConf, capacity: int) -> Optional[KernelTier]:
    """Compaction election: tier on, compact family on, and a capacity of
    at least COMPACT_MIN_CAPACITY rows; otherwise (or after a shed) the
    argsort tier compacts (ops/filter.py)."""
    tier = kernel_tier(conf)
    if not tier.compact or capacity < COMPACT_MIN_CAPACITY:
        return None
    return tier if elect(conf, "compact") else None


# ---------------------------------------------------------------------------
# Building and loading the CUDA sources
# ---------------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_libraries(names=None) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library yet, one
    nvcc process per source, all started together.  Returns name -> .so
    path.  Raises with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[name]} failed:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _target(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source (built on demand)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_libraries([name])[name])
        _LIBS[name] = lib
    return lib


class CudaLaunchError(RuntimeError):
    """A C entry point's CUDA error: `cuda_code` is the cudaError_t,
    which runtime/failure.classify reads (a sticky code is fatal, 2 is an
    OOM)."""

    def __init__(self, kernel: str, code: int):
        super().__init__(f"{kernel}: CUDA error {code} at launch")
        self.kernel = kernel
        self.cuda_code = code


def check_launch(err: int, kernel: str) -> None:
    """Raise CudaLaunchError when a C entry point reports a CUDA error."""
    if err != 0:
        raise CudaLaunchError(kernel, err)


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the raw cudaStream_t."""
    return torch.cuda.current_stream(device).cuda_stream
