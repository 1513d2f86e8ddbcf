"""numpy kernels of the CPU engine (exec/host_exec.py).

The CPU engine runs on numpy alone, so it runs on the card's machine,
which has no pyarrow.  Its columns are `columnar/host.HostColumn`s: a
data lane in the device storage form, a validity lane (None = all
valid), and for strings int32 codes into a sorted, duplicate-free
dictionary, whose code order is therefore the strings' order.

  * validity algebra (`and_valid`, `valid_of`);
  * Spark's total order of floating values (`float_order`: NaN the
    greatest, -0.0 equal to 0.0), the lanes that order, group and join
    (`order_lane`, `factorize`), and reductions over group ids
    (`Groups`);
  * gathers with -1 as a null row (`take`);
  * the decimal arithmetic of ops/decimal.py over int64 unscaled lanes,
    with the same overflow-to-null rules, in numpy, and exact arithmetic
    in Python ints where a value or a result passes int64 (a DECIMAL
    wider than 18 digits: `HostColumn.hi`, `wide_column`);
  * STRING results from per-entry values (`strings_from_entries`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from ..columnar.host import HostColumn, dictionary_column, wide_decimal_column

_I64_MAX = 2 ** 63 - 1


# ---------------------------------------------------------------------------
# validity
# ---------------------------------------------------------------------------

def and_valid(*vs: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """AND of validity lanes; None means all valid."""
    out = None
    for v in vs:
        if v is None:
            continue
        out = v.copy() if out is None else out & v
    return out


def valid_of(v: Optional[np.ndarray], n: int) -> np.ndarray:
    return np.ones(n, bool) if v is None else v


def column(data: np.ndarray, validity: Optional[np.ndarray],
           dtype: t.DataType, dictionary=None) -> HostColumn:
    """A HostColumn whose data lane is in `dtype`'s storage form, with
    null rows zeroed (so equal rows have equal lanes) and an all-true
    validity dropped."""
    data = np.asarray(data)
    want = t.physical_np_dtype(dtype)
    if data.dtype != want:
        data = data.astype(want)
    if validity is not None:
        validity = np.asarray(validity, bool)
        if validity.all():
            validity = None
        else:
            data = np.where(validity, data, np.zeros((), data.dtype))
    return HostColumn(data, validity, dtype, dictionary)


def strings(col: HostColumn) -> np.ndarray:
    """The column's values as a numpy str array ('' for null rows)."""
    d = col.dictionary
    if d is None or len(d) == 0:
        return np.full(len(col), "", dtype="<U1")
    out = d[np.clip(col.data, 0, len(d) - 1)]
    if col.validity is not None:
        out = np.where(col.validity, out, "")
    return out


def strings_from_entries(codes: np.ndarray, values: Sequence[Optional[str]],
                         validity: Optional[np.ndarray]) -> HostColumn:
    """STRING column of rows that take `values[codes]` (a None value is a
    null row), re-encoded into a sorted, duplicate-free dictionary."""
    codes = np.asarray(codes, np.int64)
    n_opts = len(values)
    ok = np.array([v is not None for v in values], bool)
    if n_opts == 0:
        return column(np.zeros(len(codes), np.int32),
                      np.zeros(len(codes), bool), t.STRING,
                      np.array([], str))
    safe = np.clip(codes, 0, n_opts - 1)
    valid = and_valid(validity, None if ok.all() else ok[safe])
    # equal values of different entries share one dictionary entry
    uniq, inv = np.unique(np.array([v if v is not None else ""
                                    for v in values], str),
                          return_inverse=True)
    out = dictionary_column(inv.reshape(-1)[safe], uniq, valid)
    return column(out.data, out.validity, t.STRING, out.dictionary)


def string_literal_column(value: Optional[str], n: int) -> HostColumn:
    if value is None:
        return HostColumn(np.zeros(n, np.int32), np.zeros(n, bool),
                          t.STRING, np.array([], str))
    return HostColumn(np.zeros(n, np.int32), None, t.STRING,
                      np.array([value], str))


# ---------------------------------------------------------------------------
# order and equality
# ---------------------------------------------------------------------------

def float_order(x: np.ndarray, signed_zero: bool = False) -> np.ndarray:
    """float values -> int64 lane in Spark's order: -inf < ... < -0.0 =
    0.0 < ... < +inf < NaN, every NaN equal (with `signed_zero`, -0.0
    below 0.0: MIN and MAX, Java's Double order)."""
    x = np.asarray(x, np.float64)
    if not signed_zero:
        x = x + 0.0                                # -0.0 -> 0.0
    bits = x.view(np.int64).copy()
    bits[np.isnan(x)] = 0x7FF8000000000000
    # negative doubles order reversed: flip their magnitude bits
    return np.where(bits < 0, bits ^ np.int64(_I64_MAX), bits)


def float_from_order(o: np.ndarray) -> np.ndarray:
    """The inverse of `float_order` (NaN comes back canonical)."""
    bits = np.where(o < 0, o ^ np.int64(_I64_MAX), o)
    return bits.astype(np.int64).view(np.float64)


def order_lane(col: HostColumn) -> np.ndarray:
    """An integer lane whose order is the column's value order (strings:
    their codes; floats: `float_order`; null rows: 0), and which is equal
    exactly where the values are equal by Spark's key equality (-0.0 =
    0.0, NaN = NaN): the grouping, join and sort lane."""
    data = col.data
    if data.dtype.kind == "f":
        lane = float_order(data)
    elif data.dtype.kind == "b":
        lane = data.astype(np.int64)
    else:
        lane = data.astype(np.int64, copy=False)
    if col.validity is not None:
        lane = np.where(col.validity, lane, 0)
    return lane


def order_lanes(col: HostColumn) -> List[np.ndarray]:
    """`order_lane` as a list of lanes, most significant first: a DECIMAL
    with a high word orders by it, then by its low word unsigned; a
    STRUCT by each field in turn, a null field first (Spark's
    interpreted struct ordering), with a null struct's fields all null
    (its own null lane is the caller's, as any key's)."""
    if col.is_struct:
        from ..columnar.host import struct_field
        lanes = []
        for f in col.dtype.fields:
            sub = struct_field(col, f.name)
            lanes.append(valid_of(sub.validity, len(sub)).astype(np.int64))
            lanes += order_lanes(sub)
        return lanes or [np.zeros(len(col), np.int64)]
    if col.hi is None:
        return [order_lane(col)]
    hi, lo = col.hi, col.data.astype(np.int64) ^ np.int64(-2 ** 63)
    if col.validity is not None:
        hi, lo = np.where(col.validity, hi, 0), np.where(col.validity, lo, 0)
    return [hi, lo]


def _dense(ids: np.ndarray, span: int) -> Tuple[np.ndarray, int]:
    """`ids` (in [0, span)) renumbered densely, order kept: a bincount
    over a small span, else one sort."""
    if span <= max(4 * len(ids), 1 << 16):
        present = np.bincount(ids, minlength=span) > 0
        remap = np.cumsum(present) - 1
        return remap[ids], int(present.sum())
    uniq, inv = np.unique(ids, return_inverse=True)
    return inv.reshape(-1).astype(np.int64), len(uniq)


def factorize(lanes: Sequence[np.ndarray]) -> Tuple[np.ndarray, int]:
    """(dense int64 id per row, number of ids) of the row tuples over
    `lanes`: equal tuples share an id, ids ascend in tuple order.  A lane
    of integers over a small range (dictionary codes, flags) takes its
    offsets as they are; any other lane is densified by one sort."""
    n = len(lanes[0]) if lanes else 0
    ids = np.zeros(n, np.int64)
    if not n:
        return ids, 0
    span = 1
    for lane in lanes:
        lo, hi = int(lane.min()), int(lane.max())
        width = hi - lo + 1
        if width <= max(4 * n, 1 << 16):
            inv = lane.astype(np.int64) - lo
        else:
            uniq, inv = np.unique(lane, return_inverse=True)
            inv, width = inv.reshape(-1), len(uniq)
        if span * width >= 1 << 62:
            ids, span = _dense(ids, span)
        ids = ids * width + inv
        span *= width
    return _dense(ids, span)


def first_of_ids(ids: np.ndarray, count: int) -> np.ndarray:
    """The first row holding each of the dense ids 0 .. count - 1."""
    first = np.empty(count, np.int64)
    # a fancy assignment keeps the last write: write the rows backwards
    first[ids[::-1]] = np.arange(len(ids) - 1, -1, -1, dtype=np.int64)
    return first


def group_ids(keys: Sequence[HostColumn], n: int
              ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(group id per row, group count, first row of each group) with the
    groups numbered in order of first appearance; a null key is a value
    of its own."""
    if not keys:
        return np.zeros(n, np.int64), 1, np.zeros(1, np.int64)
    lanes = []
    for k in keys:
        if k.validity is not None:
            lanes.append((~k.validity).astype(np.int64))
        lanes += order_lanes(k)
    ids, count = factorize(lanes)
    first = first_of_ids(ids, count)
    order = np.argsort(first, kind="stable")
    rank = np.empty(count, np.int64)
    rank[order] = np.arange(count, dtype=np.int64)
    return rank[ids], count, first[order]


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def ragged_value_index(offsets: np.ndarray, rows: np.ndarray):
    """(the values lane positions of rows `rows` of a ragged column, in
    row order, and the new offsets over them)."""
    starts = offsets[:-1][rows].astype(np.int64)
    lens = (offsets[1:][rows] - offsets[:-1][rows]).astype(np.int64)
    new_off = np.zeros(len(rows) + 1, np.int64)
    new_off[1:] = np.cumsum(lens)
    pos = np.arange(int(new_off[-1]), dtype=np.int64) - \
        np.repeat(new_off[:-1], lens) + np.repeat(starts, lens)
    return pos, new_off


def _take_ragged(col: HostColumn, idx: np.ndarray) -> HostColumn:
    miss = idx < 0
    valid = valid_of(col.validity, len(col))[np.where(miss, 0, idx)] & ~miss \
        if len(col) else np.zeros(len(idx), bool)
    rows = np.where(valid, idx, 0) if len(col) else np.zeros(0, np.int64)
    if not len(col):
        off = np.zeros(len(idx) + 1, np.int64)
        return HostColumn(col.data.slice(0, 0) if isinstance(
            col.data, HostColumn) else col.data[:0],
            valid if len(idx) else None,
                          col.dtype, col.dictionary, None,
                          off.astype(np.int32), None)
    pos, off = ragged_value_index(col.offsets, rows)
    lens = np.diff(off)
    if (~valid).any():       # a null row (or a miss) holds no value
        keep = np.repeat(valid, lens)
        pos = pos[keep]
        off = np.zeros(len(idx) + 1, np.int64)
        off[1:] = np.cumsum(np.where(valid, lens, 0))
    ev = None if col.elem_valid is None else col.elem_valid[pos]
    data = take(col.data, pos) if isinstance(col.data, HostColumn) \
        else col.data[pos]
    return HostColumn(data, None if valid.all() else valid,
                      col.dtype, col.dictionary, None, off.astype(np.int32),
                      ev)


def _take_struct(col: HostColumn, idx: np.ndarray) -> HostColumn:
    miss = idx < 0
    if len(col):
        valid = valid_of(col.validity, len(col))[np.where(miss, 0, idx)] \
            & ~miss
    else:
        valid = np.zeros(len(idx), bool)
    return HostColumn(tuple(take(c, idx) for c in col.data),
                      None if valid.all() and len(col.data) else valid,
                      col.dtype)


def with_validity(col: HostColumn, valid: Optional[np.ndarray]
                  ) -> HostColumn:
    """`col` with `valid` ANDed into its validity, of any type: a STRUCT
    keeps its children, a ragged row made null loses its span, a flat
    null row is zeroed (`column`)."""
    v = and_valid(col.validity, valid)
    if v is None or v is col.validity:
        return col
    if col.is_struct:
        return HostColumn(col.data, v, col.dtype)
    if col.offsets is not None:
        from ..columnar.host import list_column
        out = list_column(col.elements(), col.offsets, v)
        out.dtype = col.dtype
        return out
    out = column(col.data, v, col.dtype, col.dictionary)
    if col.hi is not None:
        out.hi = col.hi if out.validity is None else \
            np.where(out.validity, col.hi, 0)
    return out


def take(col: HostColumn, idx: np.ndarray) -> HostColumn:
    """Rows `idx` of `col`; an index of -1 gives a null row."""
    idx = np.asarray(idx, np.int64)
    if col.is_struct:
        return _take_struct(col, idx)
    if col.offsets is not None:
        return _take_ragged(col, idx)
    miss = idx < 0
    safe = np.where(miss, 0, idx) if miss.any() else idx
    if len(col) == 0:
        data = np.zeros(len(idx), col.data.dtype)
        valid = np.zeros(len(idx), bool)
    else:
        data = col.data[safe]
        valid = None if col.validity is None else col.validity[safe]
        if miss.any():
            valid = valid_of(valid, len(idx)) & ~miss
    out = column(data, valid, col.dtype, col.dictionary)
    if col.hi is not None and len(col):
        hi = col.hi[safe]
        out.hi = hi if out.validity is None else \
            np.where(out.validity, hi, 0)
    return out


# ---------------------------------------------------------------------------
# decimal arithmetic over int64 unscaled lanes (ops/decimal.py in numpy)
# ---------------------------------------------------------------------------

def upscale(u: np.ndarray, ds: int):
    if ds == 0:
        return u, np.ones(len(u), bool)
    f = 10 ** ds
    if f > _I64_MAX:
        return np.zeros_like(u), u == 0
    lim = _I64_MAX // f
    with np.errstate(over="ignore"):
        return u * np.int64(f), (u <= lim) & (u >= -lim)


def downscale_half_up(u: np.ndarray, ds: int) -> np.ndarray:
    """HALF_UP from the floor quotient and its remainder (ops/decimal.py)."""
    if ds == 0:
        return u
    if ds >= 19:
        half = 5 * 10 ** 18 if ds == 19 else _I64_MAX
        return (u >= half).astype(np.int64) - (u <= -half).astype(np.int64)
    f = np.int64(10 ** ds)
    q = u // f
    r2 = (u - q * f) * 2
    return q + np.where(u < 0, r2 > f, r2 >= f)


def rescale(u: np.ndarray, from_scale: int, to_scale: int):
    if to_scale >= from_scale:
        return upscale(u, to_scale - from_scale)
    return downscale_half_up(u, from_scale - to_scale), np.ones(len(u), bool)


def fits_precision(u: np.ndarray, p: int) -> np.ndarray:
    if p >= 19:
        return np.ones(len(u), bool)
    m = 10 ** p - 1
    return (u <= m) & (u >= -m)


def decimal_add(ua, sa, ub, sb, out: t.DecimalType):
    va, ok_a = rescale(ua, sa, out.scale)
    vb, ok_b = rescale(ub, sb, out.scale)
    with np.errstate(over="ignore"):
        r = va + vb
    ovf = ((va >= 0) == (vb >= 0)) & ((r >= 0) != (va >= 0))
    return r, ok_a & ok_b & ~ovf & fits_precision(r, out.precision)


def decimal_mul(ua, sa, ub, sb, out: t.DecimalType):
    with np.errstate(over="ignore"):
        prod = ua * ub
    est = np.abs(ua.astype(np.float64)) * np.abs(ub.astype(np.float64))
    ok = est < float(2 ** 62)
    r, ok2 = rescale(prod, sa + sb, out.scale)
    return r, ok & ok2 & fits_precision(r, out.precision)


def decimal_to_double(u: np.ndarray, scale: int) -> np.ndarray:
    return u.astype(np.float64) / float(10 ** scale)


def decimal_from_double(x: np.ndarray, out: t.DecimalType):
    with np.errstate(all="ignore"):
        scaled = x.astype(np.float64) * float(10 ** out.scale)
    finite = np.isfinite(scaled)
    bounded = np.abs(np.where(finite, scaled, 0.0)) < float(2 ** 62)
    safe = np.where(finite & bounded, scaled, 0.0)
    mag = np.floor(np.abs(safe) + 0.5)
    u = np.where(safe < 0, -mag, mag).astype(np.int64)
    return u, finite & bounded & fits_precision(u, out.precision)


def decimal_to_integral(u: np.ndarray, scale: int) -> np.ndarray:
    if scale == 0:
        return u
    mag = np.abs(u) // np.int64(10 ** scale)
    return np.where(u < 0, -mag, mag)


# ---------------------------------------------------------------------------
# exact decimals past int64: Python ints over object arrays
# ---------------------------------------------------------------------------

def wide_column(ints: np.ndarray, validity: Optional[np.ndarray],
                dtype: t.DecimalType) -> HostColumn:
    """A DECIMAL column of exact unscaled values, an int64 lane or Python
    ints (object array); rows past the type's precision are null.  Where
    every value fits int64 the column is built in numpy alone."""
    if ints.dtype == object:
        try:
            ints = ints.astype(np.int64)
        except OverflowError:
            pass                    # some row leaves int64: Python ints
    ok = fits_ints(ints, dtype.precision)
    valid = and_valid(validity, None if ok.all() else ok)
    if valid is not None:
        ints = np.where(valid, ints, 0)
        if valid.all():
            valid = None
    if not dtype.is_wide:
        return column(ints.astype(np.int64), valid, dtype)
    return wide_decimal_column(ints, valid, dtype)


def fits_ints(ints: np.ndarray, p: int) -> np.ndarray:
    """|v| <= 10^p - 1 per row, of an int64 lane or of Python ints."""
    if ints.dtype != object:
        return fits_precision(ints, p)
    m = 10 ** p - 1
    return ((ints >= -m) & (ints <= m)).astype(bool)


def words_int64(h: np.ndarray, a_lo: np.ndarray):
    """(value, fits): the 128-bit h * 2^32 + a_lo (0 <= a_lo < 2^32) as
    one int64 lane where it fits there (h a signed 32-bit value), 0
    elsewhere.  The operators serve numpy arrays and torch tensors."""
    fits = (h >= -(1 << 31)) & (h < (1 << 31))
    return (h * fits) * (1 << 32) + a_lo * fits, fits


def words_ints(h: np.ndarray, a_lo: np.ndarray) -> np.ndarray:
    """h * 2^32 + a_lo as exact Python ints (object array)."""
    return np.array([(x << 32) + y for x, y in
                     zip(h.tolist(), a_lo.tolist())] + [0], object)[:-1]


def words_column(h: np.ndarray, a_lo: np.ndarray,
                 validity: Optional[np.ndarray],
                 dtype: t.DecimalType) -> HostColumn:
    """The DECIMAL column h * 2^32 + a_lo, null past the precision: an
    int64 lane in numpy, Python ints only for the rows that leave it."""
    v, fits = words_int64(h, a_lo)
    base = wide_column(v, validity, dtype)
    redo = np.flatnonzero(valid_of(validity, len(v)) & ~fits)
    if not len(redo):
        return base
    return patch_rows(base, redo, wide_column(words_ints(h[redo], a_lo[redo]),
                                              None, dtype))


def half_up_ints(v: np.ndarray, ds: int) -> np.ndarray:
    """v / 10^ds rounded half away from zero, or v * 10^-ds (Python
    ints)."""
    if ds <= 0:
        return v * 10 ** (-ds)
    f = 10 ** ds
    return np.array([_div_half_up(x, f) for x in v.tolist()] + [0],
                    dtype=object)[:-1]


def _div_half_up(num: int, den: int) -> int:
    """num / den rounded half away from zero (den != 0)."""
    mag = (2 * abs(num) + abs(den)) // (2 * abs(den))
    return -mag if (num < 0) != (den < 0) else mag


def wide_decimal_op(op: str, a: HostColumn, sa: int, b: HostColumn,
                    sb: int, out: t.DecimalType) -> HostColumn:
    """a OP b (op in + - * / %) exactly at Spark's result type `out`:
    Python ints at the exact scale, then HALF_UP to `out.scale`, null
    past its precision and for / or % by zero."""
    ua, ub = a.unscaled(), b.unscaled()
    valid = and_valid(a.validity, b.validity)
    rows = range(len(ua))
    vals = [0] * len(ua)
    ok = np.ones(len(ua), bool)
    la, lb = ua.tolist(), ub.tolist()
    if op in "+-":
        s = max(sa, sb)
        fa, fb = 10 ** (s - sa), 10 ** (s - sb)
        sign = 1 if op == "+" else -1
        vals = [la[i] * fa + sign * lb[i] * fb for i in rows]
        res = half_up_ints(np.array(vals + [0], object)[:-1], s - out.scale)
    elif op == "*":
        vals = [la[i] * lb[i] for i in rows]
        res = half_up_ints(np.array(vals + [0], object)[:-1],
                           sa + sb - out.scale)
    elif op == "/":
        k = out.scale - sa + sb
        num_f, den_f = (10 ** k, 1) if k >= 0 else (1, 10 ** -k)
        for i in rows:
            if lb[i] == 0:
                ok[i] = False
            else:
                vals[i] = _div_half_up(la[i] * num_f, lb[i] * den_f)
        res = np.array(vals + [0], object)[:-1]
    else:                                   # Java's %: the dividend's sign
        s = out.scale
        fa, fb = 10 ** (s - sa), 10 ** (s - sb)
        for i in rows:
            x, y = la[i] * fa, lb[i] * fb
            if y == 0:
                ok[i] = False
            else:
                r = abs(x) % abs(y)
                vals[i] = -r if x < 0 else r
        res = np.array(vals + [0], object)[:-1]
    return wide_column(res, and_valid(valid, None if ok.all() else ok), out)


def exact_where_int64_fails(base: HostColumn, valid: Optional[np.ndarray],
                            ok: np.ndarray, exact) -> HostColumn:
    """`base` (an int64-lane result wider than 18 digits) with the valid
    rows whose int64 step overflowed (`ok` false) replaced by
    `exact(rows)`, their values in Python ints."""
    if not base.dtype.is_wide:
        return base
    redo = np.flatnonzero(valid_of(valid, len(base)) & ~ok)
    if not len(redo):
        return base
    return patch_rows(base, redo, exact(redo))


def patch_rows(base: HostColumn, idx: np.ndarray,
               part: HostColumn) -> HostColumn:
    """`base` with rows `idx` replaced by `part`'s (a DECIMAL: the high
    word comes along)."""
    data = base.data.copy()
    data[idx] = part.data
    valid = valid_of(base.validity, len(base)).copy()
    valid[idx] = valid_of(part.validity, len(part))
    out = column(data, valid, base.dtype)
    if part.hi is not None:
        hi = base.hi_lane().copy()
        hi[idx] = part.hi
        out.hi = hi
    return out


def wide_rescale(col: HostColumn, from_scale: int,
                 out: t.DecimalType) -> HostColumn:
    """A DECIMAL (or integral, at scale 0) column at `out`'s scale and
    precision, exact: HALF_UP down, null past the precision."""
    return wide_column(half_up_ints(col.unscaled(), from_scale - out.scale),
                       col.validity, out)


# ---------------------------------------------------------------------------
# segmented reductions over group ids
# ---------------------------------------------------------------------------

class Groups:
    """The rows' group ids (0 .. count - 1) and, computed once and shared
    by every aggregate over them, the rows' stable order by group."""

    def __init__(self, gid: np.ndarray, count: int):
        self.gid = gid
        self.count = count
        self._bounds = None

    def subset(self, keep: Optional[np.ndarray]) -> "Groups":
        """The groups of the rows `keep` selects (None: every row)."""
        return self if keep is None else Groups(self.gid[keep], self.count)

    def bounds(self):
        """(stable order of the rows by group, start of each group's run
        in that order, rows per group)."""
        if self._bounds is None:
            order = np.argsort(self.gid, kind="stable")
            counts = np.bincount(self.gid, minlength=self.count) \
                .astype(np.int64)
            starts = np.cumsum(counts) - counts
            self._bounds = (order, starts, counts)
        return self._bounds

    def reduce(self, ufunc, values: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(per-group ufunc reduction in row order, rows per group) of
        `values` (one per row); an empty group's value is 0."""
        out = np.zeros(self.count, values.dtype)
        if not len(values):
            return out, np.zeros(self.count, np.int64)
        order, starts, counts = self.bounds()
        have = counts > 0
        out[have] = ufunc.reduceat(values[order], starts[have])
        return out, counts


def first_rows(gid: np.ndarray, ngroups: int, last: bool = False
               ) -> np.ndarray:
    """Row index of the first (or last) row of each group, -1 if none."""
    out = np.full(ngroups, -1, np.int64)
    rows = np.arange(len(gid), dtype=np.int64)
    if last:
        out[gid] = rows                  # later rows overwrite earlier
    else:
        out[gid[::-1]] = rows[::-1]
    return out


def lexsort_rows(lanes: List[np.ndarray]) -> np.ndarray:
    """Stable row order by `lanes`, the first lane the primary key."""
    if not lanes:
        return np.zeros(0, np.int64)
    return np.lexsort(tuple(reversed(lanes))).astype(np.int64)
