"""Host-side columnar batches backed by numpy.

Counterpart of spark_rapids_tpu/columnar/host.py, whose host format is
Arrow.  The port keeps its host format in numpy so that the machine
with the card needs no pyarrow:

  * every column is a numpy data lane plus an optional bool validity
    lane (None = all valid);
  * STRING columns are int32 codes into a numpy dictionary of str that
    is sorted and duplicate-free (the JAX package's
    `encoded.dict.sortOnScan` form, built once on the host);
  * DECIMAL(p, s) is the int64 unscaled value; a DECIMAL with p > 18
    may carry a second int64 lane `hi`, the value being
    hi * 2^64 + (data as unsigned) (the reference's decimal128 word
    order); without `hi` the value is `data` itself;
  * DATE is int32 days since the epoch, TIMESTAMP int64 microseconds;
  * an ARRAY column is ragged (the reference's values+offsets layout):
    `data` is the flat values lane in the element's storage form (with
    the element's dictionary), `elem_valid` a bool per value (None = all
    valid), `offsets` int32 of rows + 1, row i's elements
    data[offsets[i]:offsets[i + 1]], and `validity` per row; a null row
    is an empty span (`list_column` builds one).  An ARRAY of a nested
    type (an ARRAY of ARRAYs, Flatten's input, or of STRUCTs) holds its
    elements as a HostColumn in `data`, whose validity is the elements';
  * a STRUCT column's `data` is a tuple of child HostColumns, one per
    field, all of the struct's length, beside the struct's own
    `validity` (`struct_column`).  As in Arrow, a child keeps its own
    validity: a null struct may sit over a valid child value, so a
    field's value is null where the child's or the struct's validity is
    false (`struct_field`);
  * a MAP column is ragged, as an ARRAY is, over a two-field STRUCT
    column of `key` and `value` (Arrow's own layout, `map_column`); a
    null map is an empty span.

`from_numpy` builds a batch from plain arrays; `from_arrow`/`to_arrow`
interchange with pyarrow, which they import inside the function, so
tests can hand the JAX package's tables to the port.
"""
from __future__ import annotations

import dataclasses
import datetime as pydt
import decimal as pydec
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .. import types as t


#: a decimal context wide enough for any DECIMAL(38) value and its
#: products: the default context's 28 digits would round past them
EXACT = pydec.Context(prec=100)


def decimal_value(unscaled: int, scale: int) -> pydec.Decimal:
    """An unscaled DECIMAL as its exact value."""
    return pydec.Decimal(int(unscaled)).scaleb(-scale, EXACT)


@dataclasses.dataclass
class HostColumn:
    """One host column: data lane, validity (None = all valid), logical
    type, for strings the sorted duplicate-free dictionary, and for a
    DECIMAL wider than 18 digits an optional high word `hi`.  A ragged
    ARRAY column also carries `offsets` and `elem_valid` (module
    docstring)."""
    data: np.ndarray
    validity: Optional[np.ndarray]
    dtype: t.DataType
    dictionary: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    elem_valid: Optional[np.ndarray] = None

    def __len__(self) -> int:
        if self.offsets is not None:
            return len(self.offsets) - 1
        if isinstance(self.data, tuple):             # a STRUCT
            return len(self.data[0]) if self.data else len(self.validity)
        return len(self.data)

    @property
    def is_struct(self) -> bool:
        return isinstance(self.data, tuple)

    def field(self, name: str) -> "HostColumn":
        """A STRUCT column's child of field `name`, as stored (its own
        validity; `struct_field` merges the struct's)."""
        return self.data[self.dtype.field_index(name)]

    def elements(self) -> "HostColumn":
        """A ragged column's values as a column of the element type."""
        if isinstance(self.data, HostColumn):
            return self.data
        return HostColumn(self.data, self.elem_valid,
                          self.dtype.element_type, self.dictionary)

    def slice(self, offset: int, length: int) -> "HostColumn":
        v = None if self.validity is None \
            else self.validity[offset:offset + length]
        if self.is_struct:
            return HostColumn(tuple(c.slice(offset, length)
                                    for c in self.data), v, self.dtype)
        if self.offsets is not None:
            off = self.offsets[offset:offset + length + 1]
            lo, hi = int(off[0]), int(off[-1])
            ev = None if self.elem_valid is None else self.elem_valid[lo:hi]
            data = self.data.slice(lo, hi - lo) \
                if isinstance(self.data, HostColumn) else self.data[lo:hi]
            return HostColumn(data, v, self.dtype,
                              self.dictionary, None,
                              (off - lo).astype(np.int32), ev)
        hi = None if self.hi is None else self.hi[offset:offset + length]
        return HostColumn(self.data[offset:offset + length], v, self.dtype,
                          self.dictionary, hi)

    def hi_lane(self) -> np.ndarray:
        """The high word, the sign extension of `data` where not kept."""
        return self.data.astype(np.int64) >> 63 if self.hi is None \
            else self.hi

    def unscaled(self) -> np.ndarray:
        """A DECIMAL column's unscaled values as Python ints (object
        array; null rows hold whatever their lanes hold)."""
        lo = self.data.astype(np.int64)
        if self.hi is None:
            return lo.astype(object)
        return self.hi.astype(object) * _U64 + lo.view(np.uint64) \
            .astype(object)

    def valid_mask(self) -> np.ndarray:
        return np.ones(len(self), bool) if self.validity is None \
            else self.validity

    def to_pylist(self) -> list:
        """Python values with the types pyarrow's to_pylist gives."""
        dt = self.dtype
        data = self.data
        if self.is_struct:
            names = dt.names
            kids = [c.to_pylist() for c in data]
            vals = [dict(zip(names, row)) for row in zip(*kids)] \
                if kids else [{} for _ in range(len(self))]
        elif self.offsets is not None:
            flat = self.elements().to_pylist()
            if isinstance(dt, t.MapType):      # pyarrow's (key, value) pairs
                flat = [None if e is None else (e["key"], e["value"])
                        for e in flat]
            off = self.offsets.tolist()
            vals = [flat[a:b] for a, b in zip(off[:-1], off[1:])]
        elif isinstance(dt, t.StringType):
            # an empty dictionary means every row is null
            vals = self.dictionary[data].tolist() if len(self.dictionary) \
                else [None] * len(data)
        elif isinstance(dt, t.DecimalType):
            vals = [decimal_value(u, dt.scale)
                    for u in self.unscaled().tolist()]
        elif isinstance(dt, t.DateType):
            epoch = pydt.date(1970, 1, 1)
            vals = [epoch + pydt.timedelta(days=int(d)) for d in data.tolist()]
        elif isinstance(dt, t.TimestampType):
            epoch = pydt.datetime(1970, 1, 1, tzinfo=pydt.timezone.utc)
            vals = [epoch + pydt.timedelta(microseconds=int(u))
                    for u in data.tolist()]
        elif isinstance(dt, t.NullType):
            vals = [None] * len(data)
        else:
            vals = data.tolist()
        if self.validity is not None:
            vals = [v if ok else None
                    for v, ok in zip(vals, self.validity.tolist())]
        return vals


def host_nbytes(col: HostColumn) -> int:
    """The bytes of a column's data and validity lanes, a nested column's
    children included (the transitions' byte counters)."""
    n = 0 if col.validity is None else col.validity.nbytes
    if col.is_struct:
        return n + sum(host_nbytes(c) for c in col.data)
    return n + (host_nbytes(col.data) if isinstance(col.data, HostColumn)
                else col.data.nbytes)


def _holds_elements(col: HostColumn) -> bool:
    """`col`, as the elements of an ARRAY or a MAP, is kept whole in the
    ragged column's `data` (a nested element type)."""
    return col.offsets is not None or col.is_struct


def _min_max(col: HostColumn):
    """Exact (min, max) of the column's integer lane over valid rows, or
    None (plan statistics: HostScanExec.column_range)."""
    dt = col.dtype
    if not isinstance(dt, (t.IntegralType, t.DateType, t.TimestampType,
                           t.BooleanType, t.DecimalType)):
        return None
    if col.hi is not None or col.offsets is not None:
        return None
    data = col.data if col.validity is None else col.data[col.validity]
    if not len(data):
        return None
    return int(data.min()), int(data.max())


def _keys_unique(cols: Sequence[HostColumn]) -> bool:
    """No two rows share equal values in `cols`, rows with a null in any
    of them excluded (null join keys never match).  Integer columns whose
    value spans multiply below 2^62 pack into one lane, which settles by
    pigeonhole (more rows than the span: not unique), a bincount over a
    small span or one sort; anything else by one sort of a 64-bit row
    hash, the rows of a repeated hash then compared exactly (np.unique
    over all rows takes minutes at 60M rows)."""
    live = np.ones(len(cols[0]), bool)
    for c in cols:
        if c.validity is not None:
            live &= c.validity
    n = int(live.sum())
    if n <= 1:
        return True
    packed, span = _packed_int_lane([c.data[live] for c in cols])
    if packed is not None:
        if span < n:
            return False
        if span <= 8 * n:
            return int(np.bincount(packed).max()) <= 1
        ordered = np.sort(packed)
        return not bool(np.any(ordered[1:] == ordered[:-1]))
    lanes = [_equality_lane(c.data[live]) for c in cols]
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for lane in lanes:
            h = _mix64_np(h ^ _mix64_np(lane.view(np.uint64) +
                                        np.uint64(0x9E3779B97F4A7C15)))
    hs = np.sort(h)
    tie = hs[1:] == hs[:-1]
    if not tie.any():
        return True
    cand = np.isin(h, hs[1:][tie])
    rows = np.stack([lane[cand] for lane in lanes], axis=1)
    return len(np.unique(rows, axis=0)) == len(rows)


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over uint64 lanes."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _packed_int_lane(lanes: Sequence[np.ndarray]):
    """(lane, span): integer lanes folded into one non-negative int64
    lane below `span` (injective on the rows), or (None, None) when a
    lane is not integral or the spans multiply past 2^62."""
    packed, span = None, 1
    for data in lanes:
        if data.dtype.kind not in "iub":
            return None, None
        data = data.astype(np.int64)
        lo, hi = int(data.min()), int(data.max())
        width = hi - lo + 1
        if span * width >= 1 << 62:
            return None, None
        part = data - lo
        packed = part if packed is None else packed * width + part
        span *= width
    return packed, span


def _equality_lane(data: np.ndarray) -> np.ndarray:
    """int64 lane whose equality is Spark's key equality (floats: -0.0
    equals 0.0, every NaN equals every NaN)."""
    if data.dtype.kind in "iub":
        return data.astype(np.int64)
    x = data.astype(np.float64) + 0.0
    x[np.isnan(x)] = np.nan
    return x.view(np.int64)


class HostBatch:
    """A set of equal-length host columns with names."""

    def __init__(self, columns: Sequence[HostColumn], names: Sequence[str]):
        self.columns = list(columns)
        self.names = list(names)
        if len(self.columns) != len(self.names):
            raise ValueError("one name per column")
        lens = {len(c) for c in self.columns}
        if len(lens) > 1:
            raise ValueError(f"columns of unequal length {sorted(lens)}")
        # plan statistics, keyed by column name(s); `select` shares them,
        # since a selected column is the same column
        self._stats: Dict[object, object] = {}
        # the batch a `select` was taken from (None: this one)
        self._root: Optional["HostBatch"] = None

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def schema(self) -> t.StructType:
        return t.StructType([t.StructField(n, c.dtype)
                             for n, c in zip(self.names, self.columns)])

    def column_by_name(self, name: str) -> HostColumn:
        return self.columns[self.names.index(name)]

    def select(self, names: Sequence[str]) -> "HostBatch":
        out = HostBatch([self.column_by_name(n) for n in names], names)
        out._stats = self._stats
        out._root = self.source
        return out

    @property
    def source(self) -> "HostBatch":
        """The batch this one was selected from (itself if none): the
        source table's identity, which the scan-upload cache and the
        whole-plan cache key on (exec/compiled.py)."""
        return self._root if self._root is not None else self

    def slice(self, offset: int, length: int) -> "HostBatch":
        return HostBatch([c.slice(offset, length) for c in self.columns],
                         self.names)

    def column_range(self, name: str):
        """Exact (min, max) of an integer-lane column, cached."""
        key = ("range", name)
        if key not in self._stats:
            self._stats[key] = _min_max(self.column_by_name(name))
        return self._stats[key]

    def keys_unique(self, names: Sequence[str]) -> bool:
        """Exact distinctness of the named column tuple over its
        fully non-null rows (the reference's scan statistic), cached."""
        key = ("unique", tuple(names))
        if key not in self._stats:
            self._stats[key] = _keys_unique(
                [self.column_by_name(n) for n in names])
        return self._stats[key]

    def to_pydict(self) -> Dict[str, list]:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    def __repr__(self):
        return f"HostBatch({self.num_rows} rows, {self.schema.simple_string})"


def concat_columns(parts: Sequence[HostColumn]) -> HostColumn:
    """Row-wise concatenation of same-type columns; string codes are
    remapped into the sorted union of the parts' dictionaries (no
    per-row string work)."""
    dt = parts[0].dtype
    valid = None
    if any(p.validity is not None for p in parts):
        valid = np.concatenate([p.valid_mask() for p in parts])
    if isinstance(dt, t.StructType):
        return HostColumn(tuple(concat_columns([p.data[i] for p in parts])
                                for i in range(len(dt.fields))),
                          valid, dt)
    if isinstance(dt, (t.ArrayType, t.MapType)):
        values = concat_columns([p.elements() for p in parts])
        base = np.cumsum([0] + [int(p.offsets[-1]) for p in parts[:-1]])
        offsets = np.concatenate(
            [p.offsets[:-1] + b for p, b in zip(parts, base)] +
            [np.array([int(base[-1]) + int(parts[-1].offsets[-1])])])
        if _holds_elements(values):          # nested elements
            return HostColumn(values, valid, dt, None, None,
                              offsets.astype(np.int32))
        return HostColumn(values.data, valid, dt, values.dictionary, None,
                          offsets.astype(np.int32), values.validity)
    if not isinstance(dt, t.StringType):
        lane = t.physical_np_dtype(dt)
        hi = None
        if any(p.hi is not None for p in parts):
            hi = np.concatenate([p.hi_lane() for p in parts])
        return HostColumn(np.concatenate([p.data.astype(lane, copy=False)
                                          for p in parts]), valid, dt,
                          None, hi)
    dicts = [np.array([], str) if p.dictionary is None else p.dictionary
             for p in parts]
    unified = np.unique(np.concatenate(dicts)).astype(str)
    codes = []
    for p, d in zip(parts, dicts):
        if len(d) and len(p):
            codes.append(np.searchsorted(unified, d)[
                np.clip(p.data, 0, len(d) - 1)])
        else:
            codes.append(np.zeros(len(p), np.int64))
    data = np.concatenate(codes).astype(np.int32)
    if valid is not None:
        data = np.where(valid, data, 0).astype(np.int32)
    return HostColumn(data, valid, t.STRING, unified)


def concat_host(batches: Sequence[HostBatch]) -> HostBatch:
    """Row-wise concatenation of same-schema batches (`concat_columns`)."""
    if not batches:
        raise ValueError("concat of zero batches")
    if len(batches) == 1:
        return batches[0]
    cols = [concat_columns([b.columns[i] for b in batches])
            for i in range(len(batches[0].columns))]
    return HostBatch(cols, batches[0].names)


# ---------------------------------------------------------------------------
# Building columns
# ---------------------------------------------------------------------------

def dictionary_column(codes: np.ndarray, options: Sequence[str],
                      validity: Optional[np.ndarray] = None) -> HostColumn:
    """STRING column from integer codes into an arbitrary `options` list:
    the dictionary is the sorted set of the options the codes use, and
    the codes are remapped into it (no per-row string work)."""
    codes = np.asarray(codes)
    opts = np.asarray(list(options), dtype=str)
    live = codes if validity is None else codes[validity]
    used = np.bincount(live, minlength=len(opts)) > 0
    order = np.argsort(opts, kind="stable")
    order = order[used[order]]
    remap = np.zeros(len(opts), np.int32)
    remap[order] = np.arange(len(order), dtype=np.int32)
    data = remap[codes]
    if validity is not None:
        data = np.where(validity, data, 0).astype(np.int32)
    return HostColumn(data.astype(np.int32, copy=False), validity, t.STRING,
                      opts[order])


def string_column(values, validity: Optional[np.ndarray] = None
                  ) -> HostColumn:
    """STRING column from per-row values (str or None)."""
    vals = np.asarray(values, dtype=object)
    isnull = np.array([v is None for v in vals.tolist()], bool) \
        if vals.size else np.zeros(0, bool)
    if validity is None and isnull.any():
        validity = ~isnull
    elif validity is not None:
        validity = np.asarray(validity, bool) & ~isnull
    filled = np.where(isnull, "", vals).astype(str) if vals.size \
        else np.array([], str)
    live = filled if validity is None else filled[validity]
    dictionary = np.unique(live)
    if not len(filled):
        data = np.zeros(0, np.int32)
    else:
        data = np.searchsorted(dictionary, filled).astype(np.int32)
        if validity is not None:
            data = np.where(validity, data, 0).astype(np.int32)
    return HostColumn(data, validity, t.STRING, dictionary.astype(str))


def list_column(elements: HostColumn, offsets,
                validity: Optional[np.ndarray] = None) -> HostColumn:
    """An ARRAY column from its elements (a column of the element type)
    and int offsets of rows + 1 (row i's elements are
    elements[offsets[i]:offsets[i + 1]]): the offsets rebase to 0 and a
    null row's span is emptied, so a null row holds no value, the
    layout every ARRAY column keeps (with numpy alone: the card's machine
    has no pyarrow)."""
    off = np.asarray(offsets, np.int64)
    if off[0]:
        elements = elements.slice(int(off[0]), int(off[-1] - off[0]))
        off = off - off[0]
    n = len(off) - 1
    lens = np.diff(off)
    if validity is not None:
        validity = np.asarray(validity, bool)
        if validity.all():
            validity = None
    if validity is not None and lens[~validity].any():
        from ..ops.host import take
        keep = np.repeat(validity, lens)
        lens = np.where(validity, lens, 0)
        elements = take(elements.slice(0, len(keep)), np.flatnonzero(keep))
    total = int(lens.sum())
    if _holds_elements(elements):            # nested elements
        new_off = np.zeros(n + 1, np.int32)
        new_off[1:] = np.cumsum(lens)
        return HostColumn(elements.slice(0, total), validity,
                          t.ArrayType(elements.dtype), None, None, new_off)
    data = elements.data[:total]
    ev = None if elements.validity is None else elements.validity[:total]
    if ev is not None and ev.all():
        ev = None
    new_off = np.zeros(n + 1, np.int32)
    new_off[1:] = np.cumsum(lens)
    return HostColumn(np.ascontiguousarray(data), validity,
                      t.ArrayType(elements.dtype), elements.dictionary,
                      None, new_off, ev)


def struct_column(fields: Sequence[HostColumn], names: Sequence[str],
                  validity: Optional[np.ndarray] = None,
                  num_rows: Optional[int] = None) -> HostColumn:
    """A STRUCT column from its field columns (all of one length) and the
    struct's own validity (None = no null struct; a struct of no field
    needs `num_rows`)."""
    fields = tuple(fields)
    if validity is not None:
        validity = np.asarray(validity, bool)
        if validity.all():
            validity = None
    if not fields and validity is None:
        validity = np.ones(num_rows or 0, bool)
    dtype = t.StructType([t.StructField(n, c.dtype)
                          for n, c in zip(names, fields)])
    return HostColumn(fields, validity, dtype)


def struct_field(col: HostColumn, name: str) -> HostColumn:
    """Field `name` of a STRUCT column with the struct's nulls merged
    into it (a null struct's field is null, as `pc.struct_field` gives
    and Spark's GetStructField reads)."""
    c = col.field(name)
    if col.validity is None:
        return c
    from ..ops.host import with_validity
    return with_validity(c, col.validity)


def map_column(keys: HostColumn, values: HostColumn, offsets,
               validity: Optional[np.ndarray] = None) -> HostColumn:
    """A MAP column from its flat keys and values and int offsets of rows
    + 1 (`list_column`'s layout over a `key`/`value` STRUCT; a null
    map's span is emptied)."""
    entries = struct_column([keys, values], ["key", "value"])
    col = list_column(entries, offsets, validity)
    col.dtype = t.MapType(keys.dtype, values.dtype)
    return col


def list_from_pylists(values, element_type: t.DataType) -> HostColumn:
    """An ARRAY column from per-row Python lists (None = a null row, an
    element None = a null element)."""
    values = list(values)
    validity = np.array([v is not None for v in values], bool)
    lens = [0 if v is None else len(v) for v in values]
    flat = [x for v in values if v is not None for x in v]
    elems = from_pydict({"e": flat}, t.StructType(
        [t.StructField("e", element_type)])).columns[0]
    off = np.zeros(len(values) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    return list_column(elems, off, None if validity.all() else validity)


def struct_from_pyvalues(values, dt: t.StructType) -> HostColumn:
    """A STRUCT column from per-row dicts (None = a null struct; a
    missing key or None = a null field)."""
    values = list(values)
    validity = np.array([v is not None for v in values], bool)
    rows = [v or {} for v in values]
    kids = from_pydict({f.name: [r.get(f.name) for r in rows]
                        for f in dt.fields}, dt).columns \
        if dt.fields else []
    col = struct_column(kids, dt.names, validity, len(values))
    col.dtype = dt
    return col


def map_from_pyvalues(values, dt: t.MapType) -> HostColumn:
    """A MAP column from per-row lists of (key, value) pairs or dicts
    (None = a null map)."""
    values = [None if v is None else
              list(v.items()) if isinstance(v, dict) else list(v)
              for v in values]
    validity = np.array([v is not None for v in values], bool)
    lens = [0 if v is None else len(v) for v in values]
    flat = [kv for v in values if v is not None for kv in v]
    kv = from_pydict({"key": [k for k, _ in flat],
                      "value": [x for _, x in flat]},
                     t.StructType([t.StructField("key", dt.key_type),
                                   t.StructField("value", dt.value_type)]))
    off = np.zeros(len(values) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    return map_column(kv.columns[0], kv.columns[1], off,
                      None if validity.all() else validity)


def _as_lane(values, dt: t.DataType) -> np.ndarray:
    if isinstance(dt, t.NullType):
        return np.zeros(len(values), np.int32)
    return np.asarray(values).astype(t.physical_np_dtype(dt), copy=False)


_U64 = 1 << 64
_MASK64 = _U64 - 1


def wide_decimal_column(data, validity: Optional[np.ndarray],
                        dt: t.DecimalType) -> HostColumn:
    """A DECIMAL(p > 18) column from its unscaled values: an int64 lane
    (the values themselves), an (n, 2) int64 array of [lo, hi] words, or
    Python ints (any sequence, object array).  The high word is kept
    only where some row needs it."""
    arr = np.asarray(data)
    if arr.dtype.kind in "iu" and arr.ndim == 1:
        return HostColumn(arr.astype(np.int64, copy=False), validity, dt)
    if arr.dtype.kind in "iu" and arr.ndim == 2:
        lo, hi = arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64)
    else:
        ints = np.array([int(v) for v in arr.tolist()] + [0],
                        dtype=object)[:-1]
        lo = (ints & _MASK64).astype(np.uint64).view(np.int64) \
            if len(ints) else np.zeros(0, np.int64)
        hi = (ints >> 64).astype(np.int64) if len(ints) \
            else np.zeros(0, np.int64)
    if validity is not None:
        lo = np.where(validity, lo, 0)
        hi = np.where(validity, hi, 0)
    keep = not np.array_equal(hi, lo >> 63)
    return HostColumn(lo, validity, dt, None, hi if keep else None)


def from_numpy(columns: Mapping[str, object], schema: t.StructType
               ) -> HostBatch:
    """HostBatch from numpy columns.  Each value is the data lane or a
    (data, validity) pair; `schema` gives the logical types.  Lanes are
    in the device storage form (decimal = int64 unscaled at the type's
    scale, date = int32 days); a DECIMAL wider than 18 digits may also
    come as Python ints or [lo, hi] word pairs (`wide_decimal_column`);
    strings are arrays of str (None = null) and are dictionary-encoded
    here."""
    cols = []
    for f in schema.fields:
        v = columns[f.name]
        if isinstance(v, HostColumn):
            cols.append(v)
            continue
        if isinstance(f.data_type, t.ArrayType):
            cols.append(list_from_pylists(v, f.data_type.element_type))
            continue
        if isinstance(f.data_type, t.StructType):
            cols.append(struct_from_pyvalues(v, f.data_type))
            continue
        if isinstance(f.data_type, t.MapType):
            cols.append(map_from_pyvalues(v, f.data_type))
            continue
        data, validity = v if isinstance(v, tuple) else (v, None)
        if validity is not None:
            validity = np.asarray(validity, bool)
        if isinstance(f.data_type, t.StringType):
            cols.append(string_column(data, validity))
        elif isinstance(f.data_type, t.DecimalType) and \
                f.data_type.is_wide:
            cols.append(wide_decimal_column(data, validity, f.data_type))
        else:
            cols.append(HostColumn(_as_lane(data, f.data_type), validity,
                                   f.data_type))
    return HostBatch(cols, schema.names)


_NP_TYPES = {np.dtype(np.bool_): t.BOOLEAN, np.dtype(np.int8): t.BYTE,
             np.dtype(np.int16): t.SHORT, np.dtype(np.int32): t.INT,
             np.dtype(np.int64): t.LONG, np.dtype(np.float32): t.FLOAT,
             np.dtype(np.float64): t.DOUBLE}


def _infer_type(values) -> t.DataType:
    """The type pyarrow infers for a numpy array or a list of Python
    values: bool, int64, float64 (ints and floats mixed), string, date,
    timestamp, decimal(p, s) spanning every value, null when all are."""
    if isinstance(values, np.ndarray):
        if values.dtype in _NP_TYPES:
            return _NP_TYPES[values.dtype]
        if values.dtype.kind == "U":
            return t.STRING
        values = values.tolist()
    kinds = {type(v) for v in values if v is not None}
    if not kinds:
        return t.NULL
    if kinds == {dict}:
        # pyarrow's struct: the fields in order of first appearance
        names: Dict[str, None] = {}
        for v in values:
            for k in v or {}:
                names.setdefault(k, None)
        return t.StructType([t.StructField(n, _infer_type(
            [v.get(n) if v is not None else None for v in values]))
            for n in names])
    if kinds == {list} and any(v for v in values) and all(
            isinstance(x, tuple) and len(x) == 2
            for v in values if v is not None for x in v):
        # lists of (key, value) pairs: a MAP
        flat = [x for v in values if v is not None for x in v]
        return t.MapType(_infer_type([k for k, _ in flat]),
                         _infer_type([x for _, x in flat]))
    if kinds == {list}:
        return t.ArrayType(_infer_type(
            [x for v in values if v is not None for x in v]))
    if kinds == {bool}:
        return t.BOOLEAN
    if kinds <= {int, float}:
        return t.LONG if kinds == {int} else t.DOUBLE
    if kinds == {str}:
        return t.STRING
    if kinds == {pydt.datetime}:
        return t.TIMESTAMP
    if kinds == {pydt.date}:
        return t.DATE
    if kinds == {pydec.Decimal}:
        scale, integral = 0, 1
        for v in values:
            if v is not None:
                _sign, digits, exp = v.as_tuple()
                scale = max(scale, -exp)
                integral = max(integral, len(digits) + exp)
        return t.DecimalType(integral + scale, scale)
    raise TypeError(f"cannot infer one column type from {sorted(map(str, kinds))}")


def _host_lane(values, dt: t.DataType):
    """(data lane, validity or None) of Python values (None = null) in
    the host storage form of `dt`."""
    if isinstance(values, np.ndarray) and values.dtype.kind != "O":
        return values, None
    if isinstance(dt, t.ArrayType):
        return list_from_pylists(values, dt.element_type)
    if isinstance(dt, t.StructType):
        return struct_from_pyvalues(values, dt)
    if isinstance(dt, t.MapType):
        return map_from_pyvalues(values, dt)
    values = list(values)
    validity = np.array([v is not None for v in values], bool)
    zero = {t.DateType: pydt.date(1970, 1, 1),
            t.TimestampType: pydt.datetime(1970, 1, 1,
                                           tzinfo=pydt.timezone.utc)}
    if isinstance(dt, t.StringType):
        return np.array(values, dtype=object), None
    if isinstance(dt, t.DecimalType):
        lane = [0 if v is None else int(
            pydec.Decimal(v).scaleb(dt.scale, EXACT)
            .to_integral_value(pydec.ROUND_HALF_UP)) for v in values]
        if dt.is_wide:
            return (np.array(lane + [0], dtype=object)[:-1],
                    None if validity.all() else validity)
    elif isinstance(dt, t.DateType):
        lane = [0 if v is None else (v - zero[t.DateType]).days
                for v in values]
    elif isinstance(dt, t.TimestampType):
        epoch = zero[t.TimestampType]
        lane = [0 if v is None else
                (v if v.tzinfo else v.replace(tzinfo=pydt.timezone.utc))
                - epoch for v in values]
        lane = [x if isinstance(x, int) else
                (x.days * 86400 + x.seconds) * 10 ** 6 + x.microseconds
                for x in lane]
    else:
        lane = [0 if v is None else v for v in values]
    return (np.asarray(lane).astype(t.physical_np_dtype(dt), copy=False),
            None if validity.all() else validity)


def from_pydict(data: Mapping[str, object],
                schema: Optional[t.StructType] = None) -> HostBatch:
    """HostBatch from Python lists or numpy arrays by column name (None =
    null), each typed by `schema` when given, else as pyarrow infers it
    (`_infer_type`)."""
    names = list(data)
    types = [schema[n].data_type for n in names] if schema is not None \
        else [_infer_type(data[n]) for n in names]
    lanes = {n: _host_lane(data[n], dt) for n, dt in zip(names, types)}
    return from_numpy(lanes, t.StructType([t.StructField(n, dt)
                                           for n, dt in zip(names, types)]))


#: the width of each integral type
INT_BITS = {t.ByteType: 8, t.ShortType: 16, t.IntegerType: 32,
             t.LongType: 64}


def _strict_value(v, dt: t.DataType):
    """One non-null Python value as `dt`'s lane value, by the rules of
    pyarrow's `pa.array(values, type)`: a bool is no integer, a float
    truncates to an integral type, a Decimal must keep its digits, an
    integer must fit; anything else raises."""
    if isinstance(dt, t.BooleanType):
        if isinstance(v, (bool, np.bool_)):
            return bool(v)
        raise ValueError(f"Could not convert {v!r} with type "
                         f"{type(v).__name__}: tried to convert to boolean")
    if isinstance(dt, t.IntegralType):
        if isinstance(v, (bool, np.bool_)):
            raise TypeError("Expected integer, got bool")
        if isinstance(v, (int, np.integer, float, np.floating, pydec.Decimal)):
            i = int(v)
        else:
            raise ValueError(f"Could not convert {v!r} with type "
                             f"{type(v).__name__}: tried to convert to "
                             f"{dt.simple_string}")
        bits = INT_BITS[type(dt)]
        if not -(1 << (bits - 1)) <= i < 1 << (bits - 1):
            raise OverflowError(f"Value {i} too large to fit in "
                                f"{dt.simple_string}")
        return i
    if isinstance(dt, (t.FloatType, t.DoubleType)):
        if isinstance(v, (bool, int, float, np.bool_, np.integer,
                          np.floating)):
            return float(v)
        raise ValueError(f"Could not convert {v!r} with type "
                         f"{type(v).__name__}: tried to convert to "
                         f"{dt.simple_string}")
    if isinstance(dt, t.StringType):
        if isinstance(v, bytes):
            return v.decode()
        if isinstance(v, str):
            return str(v)
        raise TypeError(f"Expected bytes, got a '{type(v).__name__}' object")
    if isinstance(dt, t.DecimalType):
        if isinstance(v, (bool, np.bool_)) or not isinstance(
                v, (int, np.integer, pydec.Decimal)):
            raise TypeError("int or Decimal object expected, got "
                            f"{type(v).__name__}")
        d = pydec.Decimal(int(v)) if not isinstance(v, pydec.Decimal) else v
        if not d.is_finite():
            raise ValueError(f"{d} is not a valid decimal")
        u = d.scaleb(dt.scale, EXACT)
        if u != u.to_integral_value():
            raise ValueError("Rescaling Decimal value would cause data loss")
        u = int(u)
        if abs(u) >= 10 ** dt.precision:
            raise ValueError(f"{d} does not fit into DECIMAL"
                             f"({dt.precision},{dt.scale})")
        return u
    if isinstance(dt, t.DateType):
        if isinstance(v, pydt.datetime):
            v = v.date()
        if isinstance(v, pydt.date):
            return (v - pydt.date(1970, 1, 1)).days
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return int(v)
        raise TypeError(f"object of type {type(v).__name__} cannot be "
                        "converted to a date")
    if isinstance(dt, t.TimestampType):
        if isinstance(v, pydt.datetime):
            if v.tzinfo is None:
                v = v.replace(tzinfo=pydt.timezone.utc)
            x = v - pydt.datetime(1970, 1, 1, tzinfo=pydt.timezone.utc)
            return (x.days * 86400 + x.seconds) * 10 ** 6 + x.microseconds
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return int(v)
        raise TypeError(f"object of type {type(v).__name__} cannot be "
                        "converted to a timestamp")
    raise TypeError(f"{v!r} cannot be a value of {dt.simple_string}")


#: the Python types whose values `_fast_lane` takes as they are
_FAST_KINDS = ((t.BooleanType, {bool}), (t.IntegralType, {int}),
               (t.FloatType, {int, float}), (t.DoubleType, {int, float}))


def _fast_lane(values: list, dt: t.DataType) -> Optional[np.ndarray]:
    """The lane of `values` in one numpy pass where every non-null value
    is a plain bool, int or float that `dt` takes as it is (the common
    result of a row UDF); None where `_strict_value` must look at each."""
    kinds = set(map(type, values)) - {type(None)}
    ok = next((k for c, k in _FAST_KINDS if isinstance(dt, c)), None)
    if ok is None or not kinds <= ok:
        return None
    zero = False if isinstance(dt, t.BooleanType) else 0
    work = np.float64 if isinstance(dt, (t.FloatType, t.DoubleType)) \
        else np.bool_ if isinstance(dt, t.BooleanType) else np.int64
    lane = np.fromiter((zero if v is None else v for v in values), work,
                       len(values))            # an int past int64 raises
    if isinstance(dt, t.IntegralType) and len(lane):
        bits = INT_BITS[type(dt)]
        lo, hi = int(lane.min()), int(lane.max())
        if lo < -(1 << (bits - 1)) or hi >= 1 << (bits - 1):
            raise OverflowError(f"Value {hi if hi >= 1 << (bits - 1) else lo}"
                                f" too large to fit in {dt.simple_string}")
    with np.errstate(over="ignore"):
        return lane.astype(t.physical_np_dtype(dt), copy=False)


def column_from_values(values, dt: t.DataType) -> HostColumn:
    """A column of `dt` from Python values (None = null), raising where
    pyarrow's `pa.array(values, type)` raises (`_strict_value`): the
    results of row-at-a-time UDFs.  Nested types take the lenient
    builders (`list_from_pylists`, ...)."""
    values = list(values)
    if isinstance(dt, (t.ArrayType, t.StructType, t.MapType)):
        return from_pydict({"v": values}, t.StructType(
            [t.StructField("v", dt)])).columns[0]
    valid = np.array([v is not None for v in values], bool)
    validity = None if valid.all() else valid
    if isinstance(dt, t.NullType):
        if validity is None and values:
            raise TypeError("a NULL column holds only None")
        return HostColumn(np.zeros(len(values), np.int32),
                          np.zeros(len(values), bool), dt)
    fast = _fast_lane(values, dt)
    if fast is not None:
        return HostColumn(fast, validity, dt)
    lane = [None if v is None else _strict_value(v, dt) for v in values]
    if isinstance(dt, t.StringType):
        return string_column(np.array(lane + [None], dtype=object)[:-1])
    if isinstance(dt, t.DecimalType) and dt.is_wide:
        return wide_decimal_column(
            np.array([0 if u is None else u for u in lane] + [0],
                     dtype=object)[:-1], validity, dt)
    zero = False if isinstance(dt, t.BooleanType) else 0
    np_dt = t.physical_np_dtype(dt)
    with np.errstate(over="ignore"):
        data = np.array([zero if u is None else u for u in lane],
                        dtype=np.float64 if np_dt == np.float32 else np_dt)
    return HostColumn(data.astype(np_dt, copy=False), validity, dt)


# ---------------------------------------------------------------------------
# Arrow interchange (pyarrow imported lazily: the card's machine has none)
# ---------------------------------------------------------------------------

def arrow_to_dtype(at) -> t.DataType:
    import pyarrow as pa
    for check, dt in ((pa.types.is_boolean, t.BOOLEAN),
                      (pa.types.is_int8, t.BYTE), (pa.types.is_int16, t.SHORT),
                      (pa.types.is_int32, t.INT), (pa.types.is_int64, t.LONG),
                      (pa.types.is_float32, t.FLOAT),
                      (pa.types.is_float64, t.DOUBLE),
                      (pa.types.is_string, t.STRING),
                      (pa.types.is_large_string, t.STRING),
                      (pa.types.is_date32, t.DATE),
                      (pa.types.is_timestamp, t.TIMESTAMP),
                      (pa.types.is_null, t.NULL)):
        if check(at):
            return dt
    if pa.types.is_decimal(at):
        return t.DecimalType(at.precision, at.scale)
    if pa.types.is_dictionary(at):
        return arrow_to_dtype(at.value_type)
    if pa.types.is_map(at):
        return t.MapType(arrow_to_dtype(at.key_type),
                         arrow_to_dtype(at.item_type))
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return t.ArrayType(arrow_to_dtype(at.value_type))
    if pa.types.is_struct(at):
        return t.StructType([t.StructField(f.name, arrow_to_dtype(f.type),
                                           f.nullable) for f in at])
    raise TypeError(f"unsupported arrow type {at} in the port")


def result_struct(schema) -> t.StructType:
    """A result schema as a StructType: a StructType as it is, a pyarrow
    Schema converted (pyarrow imported only for one)."""
    if isinstance(schema, t.StructType):
        return schema
    if type(schema).__module__.startswith("pyarrow"):
        return t.StructType([t.StructField(f.name, arrow_to_dtype(f.type),
                                           f.nullable) for f in schema])
    raise TypeError(f"a result schema is a StructType or a pyarrow "
                    f"Schema, not {type(schema).__name__}")


def dtype_to_arrow(dt: t.DataType):
    import pyarrow as pa
    simple = {t.BooleanType: pa.bool_(), t.ByteType: pa.int8(),
              t.ShortType: pa.int16(), t.IntegerType: pa.int32(),
              t.LongType: pa.int64(), t.FloatType: pa.float32(),
              t.DoubleType: pa.float64(), t.StringType: pa.string(),
              t.DateType: pa.date32(),
              t.TimestampType: pa.timestamp("us", tz="UTC"),
              t.NullType: pa.null()}
    if type(dt) in simple:
        return simple[type(dt)]
    if isinstance(dt, t.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, t.ArrayType):
        return pa.list_(dtype_to_arrow(dt.element_type))
    if isinstance(dt, t.StructType):
        return pa.struct([pa.field(f.name, dtype_to_arrow(f.data_type))
                          for f in dt.fields])
    if isinstance(dt, t.MapType):
        return pa.map_(dtype_to_arrow(dt.key_type),
                       dtype_to_arrow(dt.value_type))
    raise TypeError(f"unsupported logical type {dt} in the port")


def _arrow_column(arr, dt: t.DataType) -> HostColumn:
    import pyarrow as pa
    import pyarrow.compute as pc
    n = len(arr)
    validity = None
    if arr.null_count:
        validity = pc.is_valid(arr).to_numpy(zero_copy_only=False)
    if isinstance(dt, t.StructType):
        # children as Arrow stores them (`field` keeps a child's own
        # validity; the struct's nulls merge where a field is read)
        col = struct_column([_arrow_column(arr.field(i), f.data_type)
                             for i, f in enumerate(dt.fields)],
                            dt.names, validity, n)
        col.dtype = dt
        return col
    if isinstance(dt, t.MapType):
        # a null map may hold a span: map_column empties it, so no
        # phantom entry leaks into the keys or the values
        off = arr.offsets.to_numpy(zero_copy_only=False).astype(np.int64)
        lo, hi = int(off[0]), int(off[-1])
        return map_column(_arrow_column(arr.keys.slice(lo, hi - lo),
                                        dt.key_type),
                          _arrow_column(arr.items.slice(lo, hi - lo),
                                        dt.value_type), off - lo, validity)
    if isinstance(dt, t.ArrayType):
        # a null row's span is emptied (list_column), as the reference's
        # _arrow_list_to_device rebuilds it
        arr = arr.cast(pa.list_(arr.type.value_type))
        off = arr.offsets.to_numpy(zero_copy_only=False).astype(np.int64)
        values = arr.values.slice(int(off[0]), int(off[-1] - off[0]))
        return list_column(_arrow_column(values, dt.element_type), off,
                           validity)
    if isinstance(dt, t.StringType):
        if pa.types.is_dictionary(arr.type):
            arr = arr.cast(pa.string())
        values = arr.to_numpy(zero_copy_only=False)
        return string_column(values, validity)
    if isinstance(dt, t.DecimalType):
        buf = arr.buffers()[1]
        words = np.frombuffer(buf, dtype=np.int64)
        words = words[arr.offset * 2:(arr.offset + n) * 2].reshape(-1, 2)
        if dt.is_wide:
            return wide_decimal_column(words, validity, dt)
        data = words[:, 0].copy()
    elif isinstance(dt, t.DateType):
        data = arr.cast(pa.int32()).fill_null(0).to_numpy(
            zero_copy_only=False)
    elif isinstance(dt, t.TimestampType):
        data = arr.cast(pa.timestamp("us", tz="UTC")).cast(pa.int64()) \
            .fill_null(0).to_numpy(zero_copy_only=False)
    elif isinstance(dt, t.NullType):
        data = np.zeros(n, np.int32)
        validity = np.zeros(n, bool)
    else:
        np_dt = t.physical_np_dtype(dt)
        filled = arr.fill_null(False if np_dt == np.bool_ else 0) \
            if arr.null_count else arr
        data = filled.to_numpy(zero_copy_only=False)
    data = np.ascontiguousarray(data).astype(t.physical_np_dtype(dt),
                                             copy=False)
    if validity is not None and data.flags.writeable:
        data = np.where(validity, data, np.zeros((), data.dtype))
    return HostColumn(data, validity, dt)


def from_arrow(table) -> HostBatch:
    """HostBatch from a pyarrow Table (pyarrow imported by the caller)."""
    table = table.combine_chunks()
    cols = []
    for name in table.schema.names:
        col = table.column(name)
        arr = col.chunk(0) if col.num_chunks == 1 else col.combine_chunks()
        if col.num_chunks == 0:
            import pyarrow as pa
            arr = pa.array([], col.type)
        cols.append(_arrow_column(arr, arrow_to_dtype(col.type)))
    return HostBatch(cols, table.schema.names)


def _to_arrow_array(c: HostColumn):
    import pyarrow as pa
    mask = None if c.validity is None else ~c.validity
    dt = c.dtype
    if isinstance(dt, t.StructType):
        return pa.StructArray.from_arrays(
            [_to_arrow_array(k) for k in c.data], fields=[
                pa.field(f.name, dtype_to_arrow(f.data_type))
                for f in dt.fields],
            mask=None if mask is None else pa.array(mask))
    if isinstance(dt, t.MapType):
        kv = c.elements()
        return pa.MapArray.from_arrays(
            pa.array(c.offsets, pa.int32()), _to_arrow_array(kv.data[0]),
            _to_arrow_array(kv.data[1]), type=dtype_to_arrow(dt),
            mask=None if mask is None else pa.array(mask))
    if isinstance(dt, t.ArrayType):
        return pa.ListArray.from_arrays(
            pa.array(c.offsets, pa.int32()), _to_arrow_array(c.elements()),
            mask=None if mask is None else pa.array(mask))
    if isinstance(dt, t.StringType):
        return pa.DictionaryArray.from_arrays(
            pa.array(c.data, pa.int32(), mask=mask),
            pa.array(c.dictionary.tolist(), pa.string())).cast(pa.string())
    if isinstance(dt, t.DecimalType):
        return pa.array(c.to_pylist(), dtype_to_arrow(dt))
    if isinstance(dt, t.DateType):
        return pa.array(c.data.astype(np.int32), pa.int32(),
                        mask=mask).cast(pa.date32())
    if isinstance(dt, t.TimestampType):
        return pa.array(c.data.astype(np.int64), pa.int64(),
                        mask=mask).cast(dtype_to_arrow(dt))
    if isinstance(dt, t.NullType):
        return pa.nulls(len(c.data))
    return pa.array(c.data, dtype_to_arrow(dt), mask=mask)


def to_arrow(hb: HostBatch):
    """pyarrow Table from a HostBatch."""
    import pyarrow as pa
    return pa.Table.from_arrays([_to_arrow_array(c) for c in hb.columns],
                                names=list(hb.names))
