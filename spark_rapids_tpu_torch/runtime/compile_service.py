"""Background capture service: whole-plan captures off the query thread.

Counterpart of spark_rapids_tpu/runtime/compile_service.py.  A split
plan (exec/compiled.py SplitCompiledPlan) captures its segments in
sequence: segment i+1's input bucket is known only after segment i's
seam read.  The service captures the next segment at its predicted
buckets while the query thread reads the seam, so the seam usually
finds the next graph ready.  On the card a background capture runs on
its own stream with `capture_error_mode="thread_local"` (the query
thread's host reads do not invalidate it), over zero-filled placeholder
batches with no live row; on the CPU it is the detector's dry run.

Contract (the reference's):

  * `submit(key, fn)` runs `fn` on the pool exactly once per live key
    (a duplicate submission returns the task in flight).  Any exception
    `fn` raises, an injected `compile` chaos fault included (it fires on
    the service thread through the submitting query's injector), is kept
    and re-raised on the CONSUMING thread by `task.wait()`, so the
    recovery ladders see a background failure where they would see an
    inline one.
  * `take(key)` pops the task for its consumer; mispredicted tasks that
    nobody takes age out of the bounded task map.
  * Each task's wall lands in `task.ms`.

The pool is process-wide, sized by the first conf that reaches it
(`spark.rapids.tpu.compile.background.threads`).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..config import COMPILE_BG_ENABLED, COMPILE_BG_THREADS, TpuConf

#: dropped-oldest bound on the task map: speculative keys nobody consumes
#: must not pile up over a long session
_MAX_TASKS = 128


class CompileTask:
    """One background capture: an Event-guarded (result | exception)."""

    __slots__ = ("key", "done", "result", "exc", "ms")

    def __init__(self, key):
        self.key = key
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None
        self.ms = 0.0

    def wait(self, timeout: Optional[float] = 600.0):
        """Block for the capture; re-raise its exception on THIS thread."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"background capture {self.key!r} did not "
                               f"finish within {timeout}s")
        if self.exc is not None:
            raise self.exc
        return self.result


class CompileService:
    def __init__(self, threads: int):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="capture")
        self._tasks: Dict[object, CompileTask] = {}
        self._lock = threading.Lock()

    def submit(self, key, fn: Callable[[], object]) -> CompileTask:
        """Schedule `fn` under `key` (idempotent per live key)."""
        with self._lock:
            task = self._tasks.get(key)
            if task is not None:
                return task
            task = self._tasks[key] = CompileTask(key)
            while len(self._tasks) > _MAX_TASKS:
                self._tasks.pop(next(iter(self._tasks)))

        def run():
            t0 = time.perf_counter()
            try:
                task.result = fn()
            except BaseException as e:            # noqa: BLE001 - kept
                task.exc = e                      # for the consumer
            finally:
                task.ms = (time.perf_counter() - t0) * 1e3
                task.done.set()

        self._pool.submit(run)
        return task

    def take(self, key) -> Optional[CompileTask]:
        """Pop the task for `key`: the consumer owns its result and its
        exception.  None when never submitted or aged out."""
        with self._lock:
            return self._tasks.pop(key, None)

    def pending(self) -> int:
        with self._lock:
            return sum(1 for t in self._tasks.values()
                       if not t.done.is_set())


_SERVICE: Optional[CompileService] = None
_SERVICE_LOCK = threading.Lock()


def get_service(conf: TpuConf) -> CompileService:
    """The process-wide service (its pool sized by the first conf)."""
    global _SERVICE
    if _SERVICE is None:
        with _SERVICE_LOCK:
            if _SERVICE is None:
                _SERVICE = CompileService(int(conf.get(COMPILE_BG_THREADS)))
    return _SERVICE


def background_enabled(conf: TpuConf) -> bool:
    return bool(conf.get(COMPILE_BG_ENABLED))
