"""Concurrency throttle (the GpuSemaphore role).

Counterpart of spark_rapids_tpu/runtime/semaphore.py: one process-wide
semaphore a configured `sql.concurrentTpuTasks` size, and each running
query holds a permit for the whole of its device work
(plan/overrides.py PhysicalQuery.collect).  The memory budget bounds
bytes; the semaphore bounds how many queries share the card at once.
The reference's wait histogram and tracer instant port with the
observability slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..config import CONCURRENT_TPU_TASKS, TpuConf

_LOCK = threading.Lock()
_SEMS: dict = {}        # size -> semaphore: stable per configured size


def _semaphore(conf: TpuConf) -> threading.BoundedSemaphore:
    """One stable semaphore per configured size: rebuilding one on a size
    change would hand fresh permits to holders in flight."""
    n = conf.get(CONCURRENT_TPU_TASKS)
    with _LOCK:
        sem = _SEMS.get(n)
        if sem is None:
            sem = _SEMS[n] = threading.BoundedSemaphore(n)
        return sem


@contextmanager
def device_permit(conf: TpuConf, metrics: Optional[dict] = None):
    """Hold one device permit, blocking while `concurrentTpuTasks`
    holders run; the milliseconds blocked add to
    `metrics["semaphore_wait_ms"]`."""
    sem = _semaphore(conf)
    t0 = time.perf_counter()
    sem.acquire()
    waited_ms = (time.perf_counter() - t0) * 1e3
    if metrics is not None:
        metrics["semaphore_wait_ms"] = metrics.get(
            "semaphore_wait_ms", 0.0) + waited_ms
    try:
        yield
    finally:
        sem.release()
