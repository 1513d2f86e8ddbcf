"""Out-of-core sort: spillable sorted runs and a capstone-bounded merge.

Counterpart of spark_rapids_tpu/exec/ooc_sort.py (GpuOutOfCoreSortIterator,
GpuSortExec.scala:281): sort each window of input into a run, split the
run into chunks held as spillable batches, then merge.  A merge pass
concatenates the next chunk of every run (and the rows the previous
pass held back) and re-sorts them; only rows up to the smallest
**capstone** (the last row of a run's loaded chunk) may leave, because
every unloaded row of that run sorts at or after it.  The capstone's
position comes from its concat index through the sort permutation: one
scalar fetch per capstone, no key comparisons.

Held state (the runs' chunks, the held-back rows) lives in
budget-registered Spillables that may wait on the host or on disk; a
merge pass holds at most one chunk per run plus the held-back rows.
With no budget (no window) the input is one run, sorted in one piece.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar.device import DeviceBatch
from ..config import OOC_SORT_WINDOW_ROWS
from ..ops.batch_ops import concat_batches
from ..ops.sort import SortKey, permute_batch, sort_batch, sort_permutation
from ..runtime.memory import Spillable
from ..runtime.retry import slice_batch, with_split_retry
from . import ooc as O


def _row_bytes(db: DeviceBatch) -> int:
    """Approximate bytes per row at full occupancy."""
    return max(1, db.nbytes() // max(db.capacity, 1))


class OutOfCoreSorter:
    """Accumulates input batches into sorted runs, then streams the
    merged order in bounded chunks."""

    def __init__(self, keys: Sequence[SortKey], ctx):
        self.keys = list(keys)
        self.ctx = ctx
        self.conf = ctx.conf
        self.budget = ctx.budget
        self._pending: List[DeviceBatch] = []
        self._pending_rows = 0
        self._runs: List[deque] = []      # deques of Spillable chunks
        self._window_rows: Optional[int] = None
        self._merge_pending: Optional[Spillable] = None

    # -- phase 1: sorted runs ----------------------------------------------
    def _resolve_window(self, db: DeviceBatch) -> int:
        if self._window_rows is None:
            forced = self.conf.get(OOC_SORT_WINDOW_ROWS)
            policy = O.ooc_policy(self.ctx)
            if forced:
                self._window_rows = forced
            elif policy.window is not None:
                # the shared resident window, in rows of the batch's width
                self._window_rows = max(self.conf.batch_size_rows // 8,
                                        policy.window // _row_bytes(db))
            else:
                self._window_rows = 1 << 62      # unlimited: one run
        return self._window_rows

    def add(self, db: DeviceBatch):
        from ..ops.batch_ops import ensure_prefix
        # runs slice and spill the lanes: a row prefix first
        db = ensure_prefix(db, self.conf)
        db.assert_prefix()
        n = int(db.num_rows)
        if n == 0:
            return
        window = self._resolve_window(db)
        self._pending.append(db)
        self._pending_rows += n
        if self._pending_rows >= window:
            self._close_run()

    def _close_run(self):
        if not self._pending:
            return
        batches, self._pending = self._pending, []
        self._pending_rows = 0
        merged = concat_batches(batches, self.conf)
        chunk_rows = self.conf.batch_size_rows
        # each with_split_retry output sorts on its own (OOM halves are
        # not ordered against each other), so each opens its own run
        for s in with_split_retry(
                self.budget, self.conf, merged,
                lambda b: sort_batch(b, self.keys, self.conf)):
            run = deque()
            rows = int(s.num_rows)
            for off in range(0, rows, chunk_rows):
                hi = min(off + chunk_rows, rows)
                chunk = slice_batch(s, off, hi, self.conf) \
                    if (off, hi) != (0, rows) else s
                run.append(Spillable(chunk, self.budget))
            if run:
                self._runs.append(run)
                self.ctx.bump("sort_runs")

    # -- phase 2: merge ----------------------------------------------------
    def results(self) -> Iterator[DeviceBatch]:
        self._close_run()
        try:
            if len(self._runs) == 1:
                for sp in self._runs[0]:
                    db = sp.get()
                    sp.close()
                    yield db
            elif self._runs:
                yield from self._merge()
        finally:
            # an abandoned generator (a LIMIT above the sort) releases
            # every chunk still registered and the held-back rows
            for run in self._runs:
                for sp in run:
                    sp.close()
            self._runs = []
            if self._merge_pending is not None:
                self._merge_pending.close()
                self._merge_pending = None

    def _merge(self) -> Iterator[DeviceBatch]:
        runs = self._runs
        O.record_election(self.ctx, "sort", "bytes")
        passno = 0
        while True:
            O.fire(self.ctx, "sort", merge_pass=passno,
                   runs=sum(1 for r in runs if r),
                   chunks=sum(len(r) for r in runs))
            passno += 1
            window: List[DeviceBatch] = []
            if self._merge_pending is not None:
                window.append(self._merge_pending.get())
                self._merge_pending.close()
                self._merge_pending = None
            # the next chunk of every non-empty run, with its last row's
            # concat index (the capstone)
            offset = sum(int(b.num_rows) for b in window)
            capstones = []                     # (concat index, run index)
            for ri, run in enumerate(runs):
                if not run:
                    continue
                sp = run.popleft()
                b = sp.get()
                sp.close()
                window.append(b)
                rows = int(b.num_rows)
                capstones.append((offset + rows - 1, ri))
                offset += rows
            if not window:
                return
            merged = concat_batches(window, self.conf)
            total = int(merged.num_rows)
            perm = sort_permutation(merged, self.keys, self.conf)
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                     device=perm.device)
            # emit up to the smallest capstone of the runs that still
            # have unloaded chunks; exhausted runs constrain nothing
            active = [ci for ci, ri in capstones if runs[ri]]
            cut = min(int(inv[ci]) for ci in active) + 1 if active \
                else total
            s = permute_batch(merged, perm)
            yield slice_batch(s, 0, cut, self.conf) if cut < total else \
                DeviceBatch(s.columns, total, list(s.names))
            self.ctx.bump("sort_merge_passes")
            if cut < total:
                self._merge_pending = Spillable(
                    slice_batch(s, cut, total, self.conf), self.budget)
            elif not any(runs):
                return
