"""Mergeable quantile sketch: device build, host merge.

Counterpart of spark_rapids_tpu/ops/quantile_sketch.py (the role of the
reference's t-digest approx_percentile, GpuApproximatePercentile): per
group a fixed-size summary, the non-null count and K order statistics at
evenly spaced ranks, which a partial builds on the device from the
value-sorted runs and a final merges on the host.  Merging resamples the
weighted union at K even ranks; the rank error is at most 1/(2(K - 1))
a level, and levels add.  NaN orders greatest; nulls never enter a
sketch.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

#: stored order statistics a group (`sql.agg.approxPercentile.sketchSize`)
DEFAULT_K = 129


def sketch_gather(s_val: torch.Tensor, start_idx: torch.Tensor,
                  cnt: torch.Tensor, k: int, capacity: int
                  ) -> torch.Tensor:
    """(groups, k) equi-rank samples of value-sorted runs: group g's
    point j at rank round(j * (cnt - 1) / (k - 1)) of its run (an empty
    group's points are junk, masked by cnt == 0)."""
    j = torch.arange(k, dtype=torch.float64, device=s_val.device)
    n1 = torch.clamp(cnt.to(torch.float64) - 1.0, min=0.0)
    ranks = torch.round(j[None, :] * (n1[:, None] / (k - 1))) \
        .to(torch.int64)
    pos = torch.clamp(start_idx.to(torch.int64)[:, None] + ranks, 0,
                      capacity - 1)
    return s_val[pos]


def merge_sketches(parts: Sequence[Tuple[int, np.ndarray]],
                   k: int = DEFAULT_K) -> Tuple[int, np.ndarray]:
    """(count, points[k]) summaries merged into one, on the host.  Each
    point stands for count / (k - 1) rows (the end points half), and the
    weighted union is resampled at k even ranks."""
    parts = [(int(n), np.asarray(p, np.float64)) for n, p in parts
             if int(n) > 0]
    if not parts:
        return 0, np.zeros(k, np.float64)
    if len(parts) == 1:
        return parts[0]
    vals, wts = [], []
    for n, pts in parts:
        w = np.full(len(pts), n / max(len(pts) - 1, 1), np.float64)
        w[0] *= 0.5
        w[-1] *= 0.5
        vals.append(pts)
        wts.append(w)
    v = np.concatenate(vals)
    w = np.concatenate(wts)
    # NaN sorts greatest (Spark's double order)
    order = np.argsort(np.where(np.isnan(v), np.inf, v), kind="stable")
    order = order[np.argsort(np.isnan(v[order]), kind="stable")]
    v = v[order]
    cw = np.cumsum(w[order])
    target = np.linspace(0.0, cw[-1], k)
    idx = np.clip(np.searchsorted(cw, target, side="left"), 0, len(v) - 1)
    return sum(n for n, _ in parts), v[idx]


def query_sketch(n: int, pts: np.ndarray, q: float):
    """The q-quantile of a summary: Spark's linear interpolation between
    the stored ranks; None for an empty summary."""
    if n <= 0:
        return None
    pos = q * (len(pts) - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, len(pts) - 1)
    frac = pos - lo
    if frac == 0.0:
        return float(pts[lo])
    return float(pts[lo] * (1 - frac) + pts[hi] * frac)
