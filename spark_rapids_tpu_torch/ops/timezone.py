"""Session-timezone conversion through precomputed transition tables.

Counterpart of spark_rapids_tpu/ops/timezone.py (the role of the
reference's GpuTimeZoneDB, which loads the IANA database into a
device-resident transition table).  A zone is two int64 lanes, the UTC
instants of its transitions and the offset from each, built once per
zone from the host's tzdata (`zoneinfo`), moved to a device once per
(zone, device), and searched with one 1-D `searchsorted`.

Wall-clock to UTC follows Spark and java.time: an ambiguous wall time
(a fall-back overlap) takes the earlier offset, a skipped one (a
spring-forward gap) shifts forward by the gap.

The same two functions convert numpy arrays (the CPU engine) and
tensors (the device path).  Instants before 1900 and after 2100 keep the
offset of the table's first and last rows.
"""
from __future__ import annotations

import datetime as _dt
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..runtime.capture import host_constant, recording

_US = 1_000_000


@functools.lru_cache(maxsize=64)
def transition_table(tz_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (UTC transition instants in us, ascending; the offset in us
    from each), the first row a sentinel at 1900-01-01 so that the row
    before any later instant exists.

    zoneinfo is probed every 4 days from 1900 to 2100 and each change of
    offset bisected down to the microsecond it happens: exact for every
    zone the tzdata knows, without reading tzfile internals.  Four days
    is finer than any real zone's pair of transitions (Morocco's Ramadan
    pauses are weeks apart).  The reference stops its bisection within a
    second, so its table may switch up to a second late, and an instant
    on a transition's first second reads the old offset there (README
    "Deviations")."""
    from zoneinfo import ZoneInfo
    tz = ZoneInfo(tz_name)

    def off_us(utc_us: int) -> int:
        ts = _dt.datetime.fromtimestamp(utc_us / _US, _dt.timezone.utc)
        return int(ts.astimezone(tz).utcoffset().total_seconds() * _US)

    start = int(_dt.datetime(1900, 1, 1,
                             tzinfo=_dt.timezone.utc).timestamp()) * _US
    end = int(_dt.datetime(2100, 1, 1,
                           tzinfo=_dt.timezone.utc).timestamp()) * _US
    instants, offsets = [start], [off_us(start)]
    step = 4 * 86400 * _US
    probe, cur = start, offsets[0]
    while probe < end:
        nxt = probe + step
        o = off_us(nxt)
        if o != cur:
            lo, hi = probe, nxt
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if off_us(mid) == cur:
                    lo = mid
                else:
                    hi = mid
            instants.append(hi)
            offsets.append(o)
            cur = o
        probe = nxt
    return np.asarray(instants, np.int64), np.asarray(offsets, np.int64)


@functools.lru_cache(maxsize=64)
def wall_table(tz_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """The table keyed by local wall instants, for wall -> UTC: (wall
    points in us, ascending; the offset from each).  Each transition at
    UTC t switches at the wall time t + max(previous, new offset): below
    it a spring-forward gap's walls keep the previous offset (so they
    shift forward by the gap), and a fall-back overlap's walls keep the
    earlier offset until the overlap ends."""
    utc_pts, offs = transition_table(tz_name)
    wall_pts = [int(utc_pts[0]) + int(offs[0])]
    w_offs = [int(offs[0])]
    for i in range(1, len(utc_pts)):
        prev_off, new_off = int(offs[i - 1]), int(offs[i])
        wall_pts.append(int(utc_pts[i]) + max(prev_off, new_off))
        w_offs.append(new_off)
    return np.asarray(wall_pts, np.int64), np.asarray(w_offs, np.int64)


_DEVICE_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def device_table(tz_name: str, device, wall: bool = False):
    """(points, offsets) of a zone's table as int64 tensors on `device`,
    moved there once per (zone, table, device)."""
    key = (tz_name, wall, str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        pts, offs = (wall_table if wall else transition_table)(tz_name)
        hit = (host_constant(pts, device), host_constant(offs, device))
        if not recording():       # a recorded tensor fills at replay only
            _DEVICE_TABLES[key] = hit
    return hit


def _lookup(points, offsets, values):
    """offsets[the last point <= each value] (the first row for a value
    before every point)."""
    if isinstance(values, torch.Tensor):
        idx = torch.searchsorted(points, values.contiguous(), right=True) - 1
        return offsets[torch.clamp(idx, 0, points.shape[0] - 1)]
    idx = np.searchsorted(points, values, side="right") - 1
    return offsets[np.clip(idx, 0, len(points) - 1)]


def utc_to_local(ts_us, points, offsets):
    """Local wall-clock us of UTC instants (int64 lanes)."""
    return ts_us + _lookup(points, offsets, ts_us)


def local_to_utc(wall_us, wall_points, offsets):
    """UTC instants of local wall-clock us (the earlier offset for an
    ambiguous wall; a skipped wall shifts forward by the gap)."""
    return wall_us - _lookup(wall_points, offsets, wall_us)

