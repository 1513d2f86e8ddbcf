"""OOM retry ladder and host-IO retry (the RmmRapidsRetryIterator role).

Counterpart of spark_rapids_tpu/runtime/retry.py.  An operator's inner
loop runs inside `with_retry` / `with_split_retry`; on an OOM (the
budget's `TpuRetryOOM`, or the CUDA allocator's
`torch.cuda.OutOfMemoryError`) the ladder is the reference's:

  1. spill everything registered with the budget, replay;
  2. halve the input batch and run the halves on their own (at most
     `sql.retry.maxSplits` times);
  3. rethrow, as `TpuSplitAndRetryOOM` once the splits are spent.

Attempts must be idempotent: they are PyTorch ops over their inputs, so
a replay is safe by construction.  With `sql.retry.enabled` false both
ladders run their attempt once and rethrow at once.  `retry_io` is the
bounded backoff ladder the disk tier's reads and writes and the
host<->device transfers run under; each attempt first fires its chaos
site (runtime/faults.py), so an injected IO fault lands inside the
retried unit.
"""
from __future__ import annotations

import gc
import itertools
import os
import time
import zlib
from typing import Callable, Iterator, List, Optional, TypeVar

import torch

from ..columnar.device import DeviceBatch, DeviceColumn, bucket_capacity
from ..config import (RETRY_ENABLED, RETRY_IO_ATTEMPTS,
                      RETRY_IO_BACKOFF_MS, RETRY_IO_BACKOFF_MULT,
                      RETRY_IO_JITTER, RETRY_MAX_ATTEMPTS,
                      RETRY_MAX_SPLITS, TpuConf)
from .faults import _splitmix_uniform, get_injector
from .memory import (MemoryBudget, TpuRetryOOM, TpuSplitAndRetryOOM,
                     is_oom_error)

T = TypeVar("T")

#: per-process backoff draw counter: one process's jitter sequence is
#: reproducible while processes with distinct pids desynchronize
_JITTER_SEQ = itertools.count(1)


def _jittered_backoff_s(backoff_s: float, fraction: float, seed: int,
                        draw: int) -> float:
    """`backoff_s` scaled by a factor in [1 - fraction, 1 + fraction]."""
    if fraction <= 0.0:
        return backoff_s
    u = _splitmix_uniform(seed, draw)
    return backoff_s * (1.0 + fraction * (2.0 * u - 1.0))


def retry_io(conf: TpuConf, site: str, attempt: Callable[[], T],
             budget: Optional[MemoryBudget] = None,
             info: Optional[dict] = None) -> T:
    """Bounded retry with backoff for transient host IO (the
    `spark.rapids.tpu.retry.io.*` ladder): each attempt fires the chaos
    site `site` (with `info` in its record), then runs `attempt`; an
    OSError retries up to maxAttempts with exponential, jittered
    backoff; anything else (CorruptBlockError included: a failed check
    is data loss, not a transient fault) escapes at once."""
    inj = get_injector(conf)
    attempts = max(int(conf.get(RETRY_IO_ATTEMPTS)), 1)
    backoff = float(conf.get(RETRY_IO_BACKOFF_MS)) / 1000.0
    mult = float(conf.get(RETRY_IO_BACKOFF_MULT))
    kw = info or {}
    for i in range(attempts):
        try:
            inj.fire(site, **kw)
            return attempt()
        except OSError:
            if i + 1 >= attempts:
                raise
            if budget is not None:
                budget.metrics["io_retries"] += 1
            if backoff > 0:
                time.sleep(_jittered_backoff_s(
                    backoff, float(conf.get(RETRY_IO_JITTER)),
                    os.getpid() ^ zlib.crc32(site.encode()),
                    next(_JITTER_SEQ)))
            backoff *= mult
    raise AssertionError("unreachable")


def split_batch(db: DeviceBatch, conf: TpuConf) -> List[DeviceBatch]:
    """Halve a batch by row (the splitSpillableInHalfByRows policy)."""
    n = int(db.num_rows)
    if n <= 1:
        raise TpuRetryOOM(f"cannot split a {n}-row batch further")
    cut = n // 2
    return [slice_batch(db, 0, cut, conf), slice_batch(db, cut, n, conf)]


def slice_batch(db: DeviceBatch, start: int, stop: int,
                conf: TpuConf) -> DeviceBatch:
    """Rows [start, stop) as a new batch of the bucket fitting them."""
    rows = stop - start
    cap = bucket_capacity(max(rows, 1), conf)
    pos = torch.arange(cap, dtype=torch.int64, device=db.device)
    idx = torch.clamp(pos + start, 0, max(db.capacity - 1, 0))
    live = pos < rows
    cols = [c.take(idx, live) for c in db.columns]
    return DeviceBatch(cols, rows, list(db.names))


def with_retry(budget: MemoryBudget, conf: TpuConf,
               attempt: Callable[[], T]) -> T:
    """Replay `attempt` after a spill of everything on an OOM, up to
    `sql.retry.maxAttempts` runs; a failed attempt's naked reservations
    are released before the replay or the rethrow."""
    if not conf.get(RETRY_ENABLED):
        return attempt()
    max_attempts = max(int(conf.get(RETRY_MAX_ATTEMPTS)), 1)
    for i in range(max_attempts):
        with budget.track_attempt() as scope:
            try:
                return attempt()
            except Exception as e:               # noqa: BLE001
                err, oom = e, is_oom_error(e)
        budget.rollback_attempt(scope)
        if not oom or i + 1 >= max_attempts:
            raise err
        # the failed attempt's frames (and the device tensors they hold)
        # must not outlive it into the replay
        err = None
        gc.collect()
        budget.metrics["oom_retries"] += 1
        budget.spill_all()
    raise AssertionError("unreachable")


def with_split_retry(budget: MemoryBudget, conf: TpuConf,
                     batch: DeviceBatch,
                     attempt: Callable[[DeviceBatch], T]) -> Iterator[T]:
    """Run `attempt(batch)`; on an OOM spill and replay, then halve the
    batch recursively (withSplitAndRetry).  Yields one result per final
    sub-batch, in row order."""
    if not conf.get(RETRY_ENABLED):
        yield attempt(batch)
        return
    max_splits = conf.get(RETRY_MAX_SPLITS)
    max_attempts = max(int(conf.get(RETRY_MAX_ATTEMPTS)), 1)
    pending: List[tuple] = [(batch, 0)]          # (batch, splits so far)
    while pending:
        b, depth = pending.pop(0)
        done = False
        last_oom = None
        for i in range(max_attempts):
            with budget.track_attempt() as scope:
                try:
                    result = attempt(b)
                    done = True
                except Exception as e:           # noqa: BLE001
                    err, oom = e, is_oom_error(e)
            if done:
                yield result
                break
            budget.rollback_attempt(scope)
            if not oom:
                raise err
            # keep the error for the chain, not its frames' device tensors
            last_oom, err = err.with_traceback(None), None
            gc.collect()
            if i + 1 < max_attempts:
                budget.metrics["oom_retries"] += 1
                budget.spill_all()
        if done:
            continue
        if depth >= max_splits:
            raise TpuSplitAndRetryOOM(
                f"OOM persists after {depth} splits") from last_oom
        budget.metrics["batch_splits"] += 1
        pending[:0] = [(h, depth + 1) for h in split_batch(b, conf)]
