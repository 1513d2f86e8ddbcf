"""Parquet scan and write, decoded and encoded by the port itself.

Counterpart of spark_rapids_tpu/io/parquet.py, which reads and writes
through pyarrow (`pq.ParquetFile`, `pq.ParquetWriter`).  The card's
machine has no pyarrow, so the port parses the footer (io/thrift.py),
decompresses pages (native/codecs.cpp: Snappy, Zstandard; GZIP through
zlib) and decodes the values onto the numpy lanes of columnar/host.py.
Decoding stays on the host, as in the reference (its module docstring:
the win is overlapping decode with the upload, keeping compute on the
device).

Reader: data pages v1 and v2 and dictionary pages; the codecs
UNCOMPRESSED, SNAPPY, GZIP and ZSTD; the encodings PLAIN,
PLAIN_DICTIONARY / RLE_DICTIONARY, RLE (levels, v2 booleans),
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY and
BYTE_STREAM_SPLIT; every flat type `columnar/host.from_arrow` builds from
pyarrow's table of the same file.  A STRING column whose pages are
dictionary-encoded becomes the port's codes and sorted dictionary
directly (the page dictionary sorted once, the indices remapped).  The
strategies PERFILE / MULTITHREADED / COALESCING / AUTO and row-group
pruning from footer statistics behave as the reference's.  Nested columns
(ROADMAP Queue 1 item 8b) and the LZ4, LZ4_RAW, BROTLI and LZO codecs
raise NotImplementedError.

Writer: data page v1, PLAIN values, STRING columns dictionary-encoded
from the batch's own codes and dictionary (PLAIN once the dictionary
passes 1 MiB, as pyarrow's writer), min/max statistics (NaN excluded),
the physical and logical types pyarrow's writer picks for the
reference's Arrow schema.  Files are not byte-identical to pyarrow's.
"""
from __future__ import annotations

import concurrent.futures as cf
import datetime as pydt
import decimal as pydec
import os
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from .. import types as t
from ..columnar.device import DeviceBatch, merge_origin, to_device
from ..columnar.host import (EXACT, HostBatch, HostColumn, concat_host,
                             dictionary_column, wide_decimal_column)
from ..config import PARQUET_MT_THREADS, PARQUET_READER_TYPE, TpuConf
from ..exec.host_exec import HostNode
from ..exec.plan import ExecContext, PlanNode
from ..plan import expressions as E
from ..plan import logical as L
from ..plan.misc import set_current_input_file
from .thrift import TStruct, read_struct, write_struct

MAGIC = b"PAR1"

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
# encodings
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED, DELTA_BINARY_PACKED, \
    DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY, RLE_DICTIONARY, \
    BYTE_STREAM_SPLIT = 0, 2, 3, 4, 5, 6, 7, 8, 9
# page types
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# repetition
REQUIRED, OPTIONAL, REPEATED = range(3)
# converted types
UTF8, C_MAP, C_MAP_KV, C_LIST, ENUM, C_DECIMAL, C_DATE, TIME_MILLIS, \
    TIME_MICROS, TS_MILLIS, TS_MICROS, UINT_8, UINT_16, UINT_32, UINT_64, \
    INT_8, INT_16, INT_32, INT_64, C_JSON = range(20)

#: codec name -> Parquet's CompressionCodec number (the port's four)
CODECS = {"uncompressed": 0, "none": 0, "snappy": 1, "gzip": 2, "zstd": 6}
_UNPORTED_CODECS = {3: "LZO", 4: "BROTLI", 5: "LZ4", 7: "LZ4_RAW"}

NESTED_SLICE = ("nested Parquet columns (LIST, STRUCT, MAP): ROADMAP "
                "Queue 1 item 8b")

_JULIAN_EPOCH = 2440588          # the Julian day of 1970-01-01
_US_PER_DAY = 86_400_000_000
_DICT_LIMIT = 1 << 20            # pyarrow's dictionary page size limit
_PAGE_ROWS = 1 << 20             # rows a data page, at most


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA port yet")


# ---------------------------------------------------------------------------
# Footer, schema and statistics
# ---------------------------------------------------------------------------

class Leaf:
    """One top-level column of a file: its schema element, the port type
    it reads as, and its max definition level."""

    def __init__(self, el: TStruct, index: int):
        self.el = el
        self.name = el.name
        self.index = index
        self.physical = el.type
        self.nullable = el.repetition_type != REQUIRED
        self.max_def = 1 if self.nullable else 0
        self.nested = bool(el.num_children) or el.repetition_type == REPEATED
        self._dtype = None

    @property
    def dtype(self) -> t.DataType:
        """The port type (raises TypeError for a type the port has no
        host column for; a nested column is refused by its reader)."""
        if self._dtype is None and not self.nested:
            self._dtype = _leaf_dtype(self.el)
        return self._dtype

    @property
    def logical(self) -> TStruct:
        return self.el.logicalType or TStruct()


def _leaf_dtype(el: TStruct) -> t.DataType:
    """The port type of a flat column: what `columnar/host.arrow_to_dtype`
    gives for the Arrow type pyarrow reads the column as."""
    lt = el.logicalType or TStruct()
    ct = el.converted_type
    ph = el.type
    if lt.DECIMAL is not None or ct == C_DECIMAL:
        prec = lt.DECIMAL.precision if lt.DECIMAL is not None \
            else el.precision
        scale = lt.DECIMAL.scale if lt.DECIMAL is not None else el.scale
        if prec > 38:
            raise TypeError(f"unsupported parquet type decimal({prec}) "
                            f"of {el.name} in the port")
        return t.DecimalType(prec, scale or 0)
    if ph == BOOLEAN:
        return t.BOOLEAN
    if ph == INT32:
        if lt.DATE is not None or ct == C_DATE:
            return t.DATE
        if lt.INTEGER is not None or ct in (INT_8, INT_16, INT_32, UINT_8,
                                            UINT_16, UINT_32):
            bits, signed = (lt.INTEGER.bitWidth, lt.INTEGER.isSigned) \
                if lt.INTEGER is not None else \
                ({INT_8: 8, INT_16: 16, INT_32: 32, UINT_8: 8, UINT_16: 16,
                  UINT_32: 32}[ct], ct in (INT_8, INT_16, INT_32))
            if not signed:
                raise TypeError(f"unsupported parquet type uint{bits} of "
                                f"{el.name} in the port")
            return {8: t.BYTE, 16: t.SHORT, 32: t.INT}[bits]
        if lt.UNKNOWN is not None:
            return t.NULL
        if lt.TIME is not None or ct == TIME_MILLIS:
            raise TypeError(f"unsupported parquet type time of {el.name} "
                            "in the port")
        return t.INT
    if ph == INT64:
        if lt.TIMESTAMP is not None or ct in (TS_MILLIS, TS_MICROS):
            return t.TIMESTAMP
        if lt.INTEGER is not None and not lt.INTEGER.isSigned or \
                ct == UINT_64:
            raise TypeError(f"unsupported parquet type uint64 of "
                            f"{el.name} in the port")
        if lt.TIME is not None or ct == TIME_MICROS:
            raise TypeError(f"unsupported parquet type time of {el.name} "
                            "in the port")
        return t.LONG
    if ph == INT96:
        return t.TIMESTAMP
    if ph == FLOAT:
        return t.FLOAT
    if ph == DOUBLE:
        return t.DOUBLE
    if ph == BYTE_ARRAY and (lt.STRING is not None or lt.ENUM is not None
                            or lt.JSON is not None
                            or ct in (UTF8, ENUM, C_JSON)):
        return t.STRING
    raise TypeError(f"unsupported parquet type (physical {ph}) of "
                    f"{el.name} in the port: it has no BINARY host column")


class Footer:
    """A file's decoded FileMetaData and its top-level columns."""

    def __init__(self, path: str, meta: TStruct):
        self.path = path
        self.meta = meta
        schema = meta.schema or []
        if not schema:
            raise ValueError(f"{path}: parquet footer without a schema")
        self.leaves: List[Leaf] = []
        i = 1
        while i < len(schema):
            self.leaves.append(Leaf(schema[i], len(self.leaves)))
            i += 1 + _subtree(schema, i)    # a nested field's subtree
        self._leaf_col = self._column_indices(schema)
        self.names = [lf.name for lf in self.leaves]

    @staticmethod
    def _column_indices(schema) -> List[int]:
        """Index of each top-level field's first column chunk."""
        out, col, i = [], 0, 1
        while i < len(schema):
            out.append(col)
            n = _subtree(schema, i)
            col += max(1, sum(1 for el in schema[i:i + 1 + n]
                              if not el.num_children))
            i += 1 + n
        return out

    @property
    def row_groups(self) -> list:
        return self.meta.row_groups or []

    def leaf(self, name: str) -> Leaf:
        return self.leaves[self.names.index(name)]

    def chunk(self, rg: int, name: str) -> TStruct:
        leaf = self.leaf(name)
        return self.row_groups[rg].columns[self._leaf_col[leaf.index]]

    def schema(self, columns=None) -> t.StructType:
        names = list(columns) if columns else self.names
        fields = []
        for n in names:
            lf = self.leaf(n)
            if lf.nested:
                raise _unported(f"column {n}: {NESTED_SLICE}")
            fields.append(t.StructField(n, lf.dtype, lf.nullable))
        return t.StructType(fields)


def _subtree(schema, i: int) -> int:
    """Number of schema elements below element i."""
    n = schema[i].num_children or 0
    total, j = 0, i + 1
    for _ in range(n):
        sub = _subtree(schema, j)
        total += 1 + sub
        j += 1 + sub
    return total


#: what the reader decoded since `reset_decode_counts`: row groups,
#: rows, compressed column-chunk bytes read, and the host ns of each
#: `read_row_group` call summed (row groups that decode concurrently
#: overlap, so the sum exceeds the wall)
DECODE_COUNTS = {"units": 0, "rows": 0, "file_bytes": 0, "decode_ns": 0}
_counts_lock = threading.Lock()


def reset_decode_counts() -> None:
    with _counts_lock:
        for k in DECODE_COUNTS:
            DECODE_COUNTS[k] = 0


_footers: Dict[tuple, Footer] = {}
_footers_lock = threading.Lock()


def read_footer(path: str) -> Footer:
    """The file's footer, cached by (path, size, mtime)."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    with _footers_lock:
        hit = _footers.get(key)
    if hit is not None:
        return hit
    with open(path, "rb") as f:
        if st.st_size < 12:
            raise ValueError(f"{path}: not a parquet file")
        f.seek(st.st_size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a parquet file (no PAR1 tail)")
        n = struct.unpack("<I", tail[:4])[0]
        f.seek(st.st_size - 8 - n)
        raw = f.read(n)
    meta, _ = read_struct(raw, 0, "FileMetaData")
    footer = Footer(path, meta)
    with _footers_lock:
        if len(_footers) > 4096:
            _footers.clear()
        _footers[key] = footer
    return footer


def _stat_value(raw: bytes, leaf: Leaf):
    """A min/max statistic as the Python value pyarrow's Statistics
    gives (date, datetime, Decimal, str, int, float, bool)."""
    ph, dt = leaf.physical, leaf.dtype
    if ph == BOOLEAN:
        return bool(raw[0])
    if ph in (INT32, INT64):
        v = int.from_bytes(raw, "little", signed=True)
        if isinstance(dt, t.DateType):
            return pydt.date(1970, 1, 1) + pydt.timedelta(days=v)
        if isinstance(dt, t.DecimalType):
            return pydec.Decimal(v).scaleb(-dt.scale, EXACT)
        if isinstance(dt, t.TimestampType):
            unit = _ts_unit(leaf)
            us = v * 1000 if unit == "ms" else v // 1000 if unit == "ns" \
                else v
            tz = pydt.timezone.utc if _ts_adjusted(leaf) else None
            return pydt.datetime(1970, 1, 1, tzinfo=tz) + \
                pydt.timedelta(microseconds=us)
        return v
    if ph == FLOAT:
        return struct.unpack("<f", raw)[0]
    if ph == DOUBLE:
        return struct.unpack("<d", raw)[0]
    if ph in (BYTE_ARRAY, FLBA):
        if isinstance(dt, t.DecimalType):
            return pydec.Decimal(int.from_bytes(raw, "big", signed=True)) \
                .scaleb(-dt.scale, EXACT)
        if isinstance(dt, t.StringType):
            return raw.decode("utf-8", "replace")
        return raw
    return None


def _raw_stats(footer: Footer, rg: int, name: str):
    """(leaf, min bytes, max bytes) of a column in a row group, or None
    where the footer proves nothing (no statistics, INT96)."""
    leaf = footer.leaf(name)
    if leaf.nested or leaf.physical == INT96:
        return None
    st = footer.chunk(rg, name).meta_data.statistics
    if st is None:
        return None
    lo, hi = st.min_value, st.max_value
    if lo is None or hi is None:
        if leaf.physical in (BYTE_ARRAY, FLBA):
            return None           # the legacy fields' order is signed
        lo, hi = st.min, st.max
    if lo is None or hi is None:
        return None
    return leaf, lo, hi


def column_stats(footer: Footer, rg: int, name: str):
    """(min, max) of a column in a row group from its footer statistics,
    as pyarrow's Statistics give them, or None (`_raw_stats`)."""
    raw = _raw_stats(footer, rg, name)
    if raw is None:
        return None
    leaf, lo, hi = raw
    return _stat_value(lo, leaf), _stat_value(hi, leaf)


# ---------------------------------------------------------------------------
# Predicate pushdown: expression tree -> conjunctive (col, op, value) terms
# ---------------------------------------------------------------------------

_CMP = {E.EqualTo: "=", E.LessThan: "<", E.LessThanOrEqual: "<=",
        E.GreaterThan: ">", E.GreaterThanOrEqual: ">="}


def conjunctive_terms(expr: Optional[E.Expression]
                      ) -> List[Tuple[str, str, object]]:
    """Best-effort extraction of ANDed `col <op> literal` terms.  Terms that
    don't fit the shape are skipped (pruning stays conservative)."""
    if expr is None:
        return []
    if isinstance(expr, E.And):
        return conjunctive_terms(expr.children[0]) + \
            conjunctive_terms(expr.children[1])
    op = _CMP.get(type(expr))
    if op is None:
        return []
    l, r = expr.children
    if isinstance(l, E.ColumnRef) and isinstance(r, E.Literal) \
            and r.value is not None:
        return [(l.name, op, r.value)]
    if isinstance(r, E.ColumnRef) and isinstance(l, E.Literal) \
            and l.value is not None:
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
        return [(r.name, flip[op], l.value)]
    return []


def _term_stats(footer: Footer, rg: int, name: str, val):
    """`column_stats` in the domain of a term's literal.  A DATE or
    TIMESTAMP literal is its lane's integer (days, microseconds), so the
    footer's bounds are read as those integers too, a nanosecond maximum
    rounded up; pyarrow's date and datetime statistics against an integer
    raise TypeError, and the reference keeps every row group (ROADMAP
    Queue 3 item 22)."""
    raw = _raw_stats(footer, rg, name)
    if raw is None:
        return None
    leaf, lo, hi = raw
    if not isinstance(val, int) or isinstance(val, bool) or \
            leaf.physical not in (INT32, INT64) or \
            not isinstance(leaf.dtype, (t.DateType, t.TimestampType)):
        return _stat_value(lo, leaf), _stat_value(hi, leaf)
    lo = int.from_bytes(lo, "little", signed=True)
    hi = int.from_bytes(hi, "little", signed=True)
    if isinstance(leaf.dtype, t.TimestampType):
        unit = _ts_unit(leaf)
        if unit == "ms":
            lo, hi = lo * 1000, hi * 1000
        elif unit == "ns":
            lo, hi = lo // 1000, -(-hi // 1000)
    return lo, hi


def _rg_maybe_matches(footer: Footer, rg: int, terms) -> bool:
    """False only when stats PROVE no row in the group can match."""
    for col, op, val in terms:
        if col not in footer.names:
            continue
        mm = _term_stats(footer, rg, col, val)
        if mm is None:
            continue
        lo, hi = mm
        try:
            if op == "=" and (val < lo or val > hi):
                return False
            if op in ("<", "<=") and not (lo < val or (op == "<=" and lo <= val)):
                return False
            if op in (">", ">=") and not (hi > val or (op == ">=" and hi >= val)):
                return False
        except TypeError:
            continue      # incomparable stat types: keep the group
    return True


def _scan_units(paths: Sequence[str], terms) -> List[Tuple[str, int]]:
    """(path, row_group) work units after row-group stat pruning."""
    units = []
    for p in paths:
        footer = read_footer(p)
        for rg in range(len(footer.row_groups)):
            if _rg_maybe_matches(footer, rg, terms):
                units.append((p, rg))
    return units


# ---------------------------------------------------------------------------
# Page decoding
# ---------------------------------------------------------------------------

def decompress(codec: int, data: np.ndarray, size: int) -> np.ndarray:
    if codec == 0:
        return data
    if codec == 1:
        return native.snappy_decompress(data, size)
    if codec == 6:
        return native.zstd_decompress(data, size)
    if codec == 2:
        return native.gzip_decompress(data, size)
    raise _unported(f"the {_UNPORTED_CODECS.get(codec, codec)} parquet "
                    "codec (codec)")


def compress(codec: int, data: bytes) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        return native.snappy_compress(data)
    if codec == 6:
        return native.zstd_compress(data)
    if codec == 2:
        return native.gzip_compress(data)
    raise _unported(f"the parquet codec {codec} (codec)")


def _u32(buf: np.ndarray, pos: int) -> int:
    return int(buf[pos:pos + 4].view("<u4")[0])


class _Spans:
    """BYTE_ARRAY values: spans of a byte buffer."""

    def __init__(self, buf: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray):
        self.buf, self.starts, self.lens = buf, starts, lens

    def __len__(self):
        return len(self.starts)

    def fixed(self) -> np.ndarray:
        return native.gather_fixed(self.buf, self.starts, self.lens)


def _byte_width(leaf: Leaf) -> int:
    return {INT32: 4, INT64: 8, FLOAT: 4, DOUBLE: 8, INT96: 12}.get(
        leaf.physical, leaf.el.type_length or 0)


def _fixed_rows(raw: np.ndarray, n: int, width: int) -> np.ndarray:
    return raw[:n * width].reshape(n, width) if width else \
        np.zeros((n, 0), np.uint8)


def _plain(raw: np.ndarray, leaf: Leaf, n: int):
    """n PLAIN values -> (values, bytes consumed)."""
    ph = leaf.physical
    if ph == BOOLEAN:
        nbytes = (n + 7) // 8
        bits = np.unpackbits(raw[:nbytes], bitorder="little")[:n]
        return bits.astype(bool), nbytes
    if ph == BYTE_ARRAY:
        starts, lens, used = native.plain_byte_array_index(raw, n)
        return _Spans(raw, starts, lens), used
    width = _byte_width(leaf)
    if len(raw) < n * width:
        raise ValueError("truncated PLAIN values")
    if ph in (INT96, FLBA):
        return _fixed_rows(raw, n, width), n * width
    dtype = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ph]
    return raw[:n * width].view(dtype), n * width


def _delta_lengths(raw: np.ndarray, n: int):
    lens, used = native.delta_binary_decode(raw, max(n, 1))
    return lens[:n], used


def _values(raw: np.ndarray, enc: int, leaf: Leaf, n: int, dictionary):
    """n non-null values of a data page's value section."""
    ph = leaf.physical
    if enc == PLAIN:
        return _plain(raw, leaf, n)[0]
    if enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
        if dictionary is None:
            raise ValueError("dictionary-encoded page without a dictionary")
        if n == 0:
            idx = np.zeros(0, np.int32)
        else:
            idx, _ = native.rle_hybrid_decode(raw[1:], int(raw[0]), n)
        return ("dict", idx)
    if enc == RLE and ph == BOOLEAN:
        size = _u32(raw, 0)
        vals, _ = native.rle_hybrid_decode(raw[4:4 + size], 1, n)
        return vals.astype(bool)
    if enc == DELTA_BINARY_PACKED and ph in (INT32, INT64):
        vals, _ = native.delta_binary_decode(raw, max(n, 1))
        vals = vals[:n]
        return vals.astype(np.int32) if ph == INT32 else vals
    if enc == DELTA_LENGTH_BYTE_ARRAY and ph == BYTE_ARRAY:
        lens, used = _delta_lengths(raw, n)
        starts = used + np.concatenate([[0], np.cumsum(lens)[:-1]]) \
            if n else np.zeros(0, np.int64)
        return _Spans(raw, starts.astype(np.int64), lens.astype(np.int32))
    if enc == DELTA_BYTE_ARRAY and ph in (BYTE_ARRAY, FLBA):
        prefix, used = _delta_lengths(raw, n)
        suf_lens, used2 = _delta_lengths(raw[used:], n)
        body = used + used2
        suf_starts = body + np.concatenate([[0], np.cumsum(suf_lens)[:-1]]) \
            if n else np.zeros(0, np.int64)
        out, offs = native.delta_byte_array(raw, prefix, suf_starts,
                                            suf_lens)
        spans = _Spans(out, offs[:-1], np.diff(offs).astype(np.int32))
        if ph == FLBA:
            return spans.fixed().view(np.uint8).reshape(
                n, leaf.el.type_length)
        return spans
    if enc == BYTE_STREAM_SPLIT and ph in (FLOAT, DOUBLE, INT32, INT64,
                                           FLBA):
        width = _byte_width(leaf)
        planes = raw[:n * width].reshape(width, n)
        rows = np.ascontiguousarray(planes.T)
        if ph == FLBA:
            return rows
        dtype = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ph]
        return rows.reshape(-1).view(dtype)
    raise _unported(f"parquet encoding {enc} of a {leaf.physical} column "
                    "(codec)")


def _read_levels(raw: np.ndarray, n: int):
    """v1 definition levels (4-byte length, RLE hybrid, bit width 1)."""
    size = _u32(raw, 0)
    defs, _ = native.rle_hybrid_decode(raw[4:4 + size], 1, n)
    return defs, 4 + size


def _decode_chunk(buf: np.ndarray, leaf: Leaf, cm: TStruct) -> HostColumn:
    """One column chunk (its bytes in `buf`) as a HostColumn."""
    codec = cm.codec
    if codec not in (0, 1, 2, 6):
        decompress(codec, buf, 0)          # raises naming the codec
    pos = 0
    dictionary = None
    pieces = []
    seen = 0
    view = memoryview(buf)          # Python ints for the header decoder
    while seen < cm.num_values:
        ph, pos = read_struct(view, pos, "PageHeader")
        size = ph.compressed_page_size
        payload = buf[pos:pos + size]
        pos += size
        if ph.type == DICTIONARY_PAGE:
            raw = decompress(codec, payload, ph.uncompressed_page_size)
            dictionary = _plain(raw, leaf,
                                ph.dictionary_page_header.num_values)[0]
            continue
        if ph.type == DATA_PAGE:
            dh = ph.data_page_header
            n = dh.num_values
            raw = decompress(codec, payload, ph.uncompressed_page_size)
            p = 0
            valid = None
            if leaf.max_def:
                if dh.definition_level_encoding == BIT_PACKED:
                    raise _unported("legacy BIT_PACKED definition levels "
                                    "(codec)")
                defs, p = _read_levels(raw, n)
                valid = defs == leaf.max_def
            nv = n if valid is None else int(valid.sum())
            vals = _values(raw[p:], dh.encoding, leaf, nv, dictionary)
        elif ph.type == DATA_PAGE_V2:
            dh = ph.data_page_header_v2
            n = dh.num_values
            rl = dh.repetition_levels_byte_length or 0
            dl = dh.definition_levels_byte_length or 0
            valid = None
            if leaf.max_def:
                defs, _ = native.rle_hybrid_decode(payload[rl:rl + dl], 1, n)
                valid = defs == leaf.max_def
            body = payload[rl + dl:]
            if dh.is_compressed is not False:
                body = decompress(codec, body,
                                  ph.uncompressed_page_size - rl - dl)
            nv = n if valid is None else int(valid.sum())
            vals = _values(body, dh.encoding, leaf, nv, dictionary)
        else:
            continue                      # index pages
        pieces.append((n, valid, vals))
        seen += n
    return _assemble(leaf, pieces, dictionary)


def _assemble(leaf: Leaf, pieces, dictionary) -> HostColumn:
    """The pages' values and validity as one HostColumn in the port's
    host layout."""
    n = sum(p[0] for p in pieces)
    validity = None
    if any(p[1] is not None and not p[1].all() for p in pieces):
        validity = np.concatenate([np.ones(p[0], bool) if p[1] is None
                                   else p[1] for p in pieces])
    dt = leaf.dtype
    if isinstance(dt, t.NullType):
        return HostColumn(np.zeros(n, np.int32), np.zeros(n, bool), dt)
    if isinstance(dt, t.StringType):
        return _assemble_strings(pieces, dictionary, n, validity)
    vals = [dictionary[v[1]] if isinstance(v, tuple) else v
            for _n, _v, v in pieces]
    if vals and isinstance(vals[0], _Spans):          # BYTE_ARRAY decimal
        vals = [_spans_to_fixed16(v) for v in vals]
    phys = np.concatenate(vals) if vals else \
        np.zeros((0,) + (() if leaf.physical not in (INT96, FLBA)
                         else (_byte_width(leaf),)), np.uint8)
    if validity is not None:
        full = np.zeros((n,) + phys.shape[1:], phys.dtype)
        full[validity] = phys
        phys = full
    return _lane(leaf, phys, validity)


def _spans_to_fixed16(sp: _Spans) -> np.ndarray:
    """Variable-length big-endian decimals as 16-byte rows."""
    return native.spans_to_be16(sp.buf, sp.starts, sp.lens)


def _ts_unit(leaf: Leaf) -> str:
    lt = leaf.logical
    if lt.TIMESTAMP is not None:
        u = lt.TIMESTAMP.unit or TStruct()
        return "ms" if u.MILLIS is not None else "ns" \
            if u.NANOS is not None else "us"
    return "ms" if leaf.el.converted_type == TS_MILLIS else "us"


def _ts_adjusted(leaf: Leaf) -> bool:
    lt = leaf.logical
    if lt.TIMESTAMP is not None:
        return bool(lt.TIMESTAMP.isAdjustedToUTC)
    return True


def _lane(leaf: Leaf, phys: np.ndarray, validity) -> HostColumn:
    """Physical values (nulls zero-filled) -> the port's storage lane."""
    dt = leaf.dtype
    ph = leaf.physical
    if isinstance(dt, t.DecimalType):
        if ph in (INT32, INT64):
            data = phys.astype(np.int64)
        elif phys.shape[1] <= 8 and not dt.is_wide:
            data = native.be_int64(phys)
        else:
            rows = phys if phys.shape[1] == 16 else _sign_pad16(phys)
            hi = rows[:, :8].copy().view(">i8").reshape(-1).astype(np.int64)
            lo = rows[:, 8:].copy().view(">u8").reshape(-1) \
                .astype(np.uint64).view(np.int64)
            if dt.is_wide:
                return wide_decimal_column(np.stack([lo, hi], 1), validity,
                                           dt)
            data = lo
        return HostColumn(_zero_nulls(data, validity), validity, dt)
    if isinstance(dt, t.TimestampType):
        if ph == INT96:
            nanos = phys[:, :8].copy().view("<i8").reshape(-1)
            days = phys[:, 8:12].copy().view("<i4").reshape(-1) \
                .astype(np.int64)
            data = (days - _JULIAN_EPOCH) * _US_PER_DAY + nanos // 1000
        else:
            unit = _ts_unit(leaf)
            v = phys.astype(np.int64)
            data = v * 1000 if unit == "ms" else v // 1000 \
                if unit == "ns" else v
        return HostColumn(_zero_nulls(data, validity), validity, dt)
    lane = t.physical_np_dtype(dt)
    data = np.ascontiguousarray(phys).astype(lane, copy=False)
    return HostColumn(_zero_nulls(data, validity), validity, dt)


def _sign_pad16(rows: np.ndarray) -> np.ndarray:
    """Big-endian two's complement rows narrower than 16 bytes,
    sign-extended to 16."""
    n, w = rows.shape
    out = np.empty((n, 16), np.uint8)
    neg = (rows[:, 0] >= 128) if w else np.zeros(n, bool)
    out[:, :16 - w] = np.where(neg, 0xFF, 0).astype(np.uint8)[:, None]
    out[:, 16 - w:] = rows
    return out


def _zero_nulls(data: np.ndarray, validity) -> np.ndarray:
    if validity is None:
        return data
    return np.where(validity, data, np.zeros((), data.dtype))


def _decode_strings(fixed: np.ndarray) -> np.ndarray:
    """A numpy 'S' array of UTF-8 values as numpy str."""
    if not len(fixed):
        return np.array([], str)
    return np.char.decode(fixed, "utf-8")


def _assemble_strings(pieces, dictionary, n: int, validity) -> HostColumn:
    if pieces and all(isinstance(v, tuple) for _n, _v, v in pieces):
        # dictionary pages throughout: sort the page dictionary once and
        # remap the indices through it
        opts = _decode_strings(dictionary.fixed())
        uniq, inv = np.unique(opts, return_inverse=True)
        idx = np.concatenate([v[1] for _n, _v, v in pieces]) \
            .astype(np.int64)
        codes = inv.reshape(-1)[idx] if len(idx) else idx
        if validity is not None:
            full = np.zeros(n, np.int64)
            full[validity] = codes
            codes = full
        return dictionary_column(codes.astype(np.int32), uniq, validity)
    parts = []
    for _n, _v, v in pieces:
        if isinstance(v, tuple):
            parts.append(dictionary.fixed()[v[1]])
        else:
            parts.append(v.fixed())
    allv = np.concatenate(parts) if parts else np.array([], "S1")
    uniq, inv = np.unique(allv, return_inverse=True)
    codes = inv.reshape(-1).astype(np.int64)
    if validity is not None:
        full = np.zeros(n, np.int64)
        full[validity] = codes
        codes = full
    return dictionary_column(codes.astype(np.int32), _decode_strings(uniq),
                             validity)


def _chunk_start(cm: TStruct) -> int:
    """A column chunk's first byte: its dictionary page where one leads."""
    start = cm.data_page_offset
    dpo = cm.dictionary_page_offset
    if dpo is not None and 0 < dpo < start:
        start = dpo
    return start


def _read_chunk_bytes(fd: int, cm: TStruct) -> np.ndarray:
    raw = os.pread(fd, cm.total_compressed_size, _chunk_start(cm))
    return np.frombuffer(raw, np.uint8)


_column_pool_box: list = []
_column_pool_lock = threading.Lock()


def _column_pool() -> cf.ThreadPoolExecutor:
    """The pool a row group's column chunks decode in (ctypes and most
    numpy work release the GIL); the reader strategies' unit pools wait
    on it.  Made at first use, one a process."""
    with _column_pool_lock:
        if not _column_pool_box:
            _column_pool_box.append(cf.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="parquet-column"))
        return _column_pool_box[0]


def read_row_group(path: str, rg: int, columns=None) -> HostBatch:
    """One row group's columns as a HostBatch, the columns decoded in
    parallel."""
    footer = read_footer(path)
    names = list(columns) if columns else footer.names
    for name in names:
        if footer.leaf(name).nested:
            raise _unported(f"column {name}: {NESTED_SLICE}")
    t0 = time.perf_counter_ns()
    fd = os.open(path, os.O_RDONLY)
    try:
        def one(name):
            leaf = footer.leaf(name)
            cm = footer.chunk(rg, name).meta_data
            buf = _read_chunk_bytes(fd, cm)
            return _decode_chunk(buf, leaf, cm), len(buf)
        done = list(_column_pool().map(one, names)) if len(names) > 1 \
            else [one(n) for n in names]
    finally:
        os.close(fd)
    with _counts_lock:
        DECODE_COUNTS["units"] += 1
        DECODE_COUNTS["file_bytes"] += sum(n for _c, n in done)
        DECODE_COUNTS["rows"] += int(footer.row_groups[rg].num_rows)
        DECODE_COUNTS["decode_ns"] += time.perf_counter_ns() - t0
    return HostBatch([c for c, _n in done], names)


def read_buffer_row_groups(data: bytes) -> Iterator[HostBatch]:
    """Each row group of an in-memory Parquet file (exec/cache.py's
    buffer) as a HostBatch, decoded one at a time."""
    buf = np.frombuffer(data, np.uint8)
    if len(buf) < 12 or bytes(buf[-4:]) != MAGIC:
        raise ValueError("not a parquet buffer")
    n = int(buf[-8:-4].view("<u4")[0])
    meta, _ = read_struct(memoryview(buf[-8 - n:-8]), 0, "FileMetaData")
    footer = Footer("<buffer>", meta)
    for rg in range(len(footer.row_groups)):
        cols = []
        for name in footer.names:
            leaf = footer.leaf(name)
            cm = footer.chunk(rg, name).meta_data
            start = _chunk_start(cm)
            cols.append(_decode_chunk(
                buf[start:start + cm.total_compressed_size], leaf, cm))
        yield HostBatch(cols, footer.names)


def read_table(path: str, columns=None) -> HostBatch:
    """Every row group of one file as one HostBatch."""
    footer = read_footer(path)
    parts = [read_row_group(path, rg, columns)
             for rg in range(len(footer.row_groups))]
    if not parts:
        return empty_batch(footer.schema(columns))
    return concat_host(parts)


def empty_batch(schema: t.StructType) -> HostBatch:
    cols = []
    for f in schema.fields:
        if isinstance(f.data_type, t.StringType):
            cols.append(HostColumn(np.zeros(0, np.int32), None, f.data_type,
                                   np.array([], str)))
        else:
            cols.append(HostColumn(
                np.zeros(0, t.physical_np_dtype(f.data_type)
                         if not isinstance(f.data_type, t.NullType)
                         else np.int32), None, f.data_type))
    return HostBatch(cols, schema.names)


# ---------------------------------------------------------------------------
# Host-side batch production (shared by device scan and CPU fallback scan)
# ---------------------------------------------------------------------------

def _read_unit(unit: Tuple[str, int], columns) -> HostBatch:
    path, rg = unit
    return read_row_group(path, rg, columns)


def _split(hb: HostBatch, target: int, origin: str):
    n = hb.num_rows
    if n <= target:
        yield hb, origin
        return
    for off in range(0, n, target):
        yield hb.slice(off, min(target, n - off)), origin


def host_batch_stream_with_origin(
        paths: Sequence[str], columns, conf: TpuConf,
        filter_expr: Optional[E.Expression] = None,
        ) -> Iterator[Tuple[HostBatch, str]]:
    """(batch, source file) pairs — scan provenance for
    input_file_name.  COALESCING batches that stitched multiple files
    report "" (mixed provenance)."""
    strategy = str(conf.get(PARQUET_READER_TYPE)).upper()
    # AUTO is MULTITHREADED with the row groups of one file merged up to
    # the batch target (the reference's AUTO yields each row group: a
    # writer's default row group is a quarter of the scan's batch, and
    # four times the batches launch four times the kernels); a batch
    # keeps its one file's provenance
    per_file = strategy == "AUTO"
    if per_file:
        strategy = "MULTITHREADED"
    terms = conjunctive_terms(filter_expr)
    units = _scan_units(paths, terms)
    target = conf.batch_size_rows

    if strategy == "PERFILE" or not units:
        for u in units:
            yield from _split(_read_unit(u, columns), target, u[0])
        return

    threads = conf.get(PARQUET_MT_THREADS)
    lookahead = max(2, threads)
    merge = per_file or strategy == "COALESCING"
    pending: List[HostBatch] = []
    pending_files: set = set()
    pending_rows = 0
    with cf.ThreadPoolExecutor(max_workers=threads) as pool:
        futures = [pool.submit(_read_unit, u, columns) for u in
                   units[:lookahead]]
        nxt = lookahead
        for i in range(len(units)):
            hb = futures[i].result()
            futures[i] = None
            if nxt < len(units):
                futures.append(pool.submit(_read_unit, units[nxt], columns))
                nxt += 1
            if not merge:
                yield from _split(hb, target, units[i][0])
                continue
            if per_file and pending and units[i][0] not in pending_files:
                yield from _split(concat_host(pending), target,
                                  merge_origin(pending_files))
                pending, pending_rows = [], 0
                pending_files = set()
            pending.append(hb)
            pending_files.add(units[i][0])
            pending_rows += hb.num_rows
            if pending_rows >= target:
                yield from _split(concat_host(pending), target,
                                  merge_origin(pending_files))
                pending, pending_rows = [], 0
                pending_files = set()
        if pending:
            yield from _split(concat_host(pending), target,
                              merge_origin(pending_files))


def parquet_schema(paths: Sequence[str], columns=None) -> t.StructType:
    return read_footer(paths[0]).schema(columns)


# ---------------------------------------------------------------------------
# Plan statistics: what an in-memory scan's HostBatch gives the planner
# (exact integer bounds, key uniqueness), for a set of files
# ---------------------------------------------------------------------------

_plan_stats: Dict[tuple, object] = {}
_plan_stats_lock = threading.Lock()


def _files_key(paths: Sequence[str]) -> tuple:
    out = []
    for p in paths:
        st = os.stat(p)
        out.append((os.path.abspath(p), st.st_size, st.st_mtime_ns))
    return tuple(out)


def _stat_int(raw: bytes, leaf: Leaf) -> Optional[int]:
    """A min/max statistic as the integer of the column's storage lane
    (DATE days, TIMESTAMP microseconds, DECIMAL unscaled), or None."""
    dt = leaf.dtype
    if not isinstance(dt, (t.IntegralType, t.DateType, t.TimestampType,
                           t.BooleanType, t.DecimalType)):
        return None
    if isinstance(dt, t.DecimalType) and dt.is_wide:
        return None
    if leaf.physical in (INT32, INT64, BOOLEAN):
        v = int.from_bytes(raw, "little", signed=leaf.physical != BOOLEAN)
        if isinstance(dt, t.TimestampType):
            unit = _ts_unit(leaf)
            v = v * 1000 if unit == "ms" else v // 1000 if unit == "ns" \
                else v
        return v
    if leaf.physical == FLBA:
        return int.from_bytes(raw, "big", signed=True)
    return None


def scan_column_range(paths: Sequence[str], name: str):
    """Exact (min, max) of an integer-lane column over every row group of
    the files, from their footer statistics (None when a row group with
    values has none): the bounds `HostBatch.column_range` computes for an
    in-memory table."""
    lo = hi = None
    for p in paths:
        footer = read_footer(p)
        if name not in footer.names:
            return None
        leaf = footer.leaf(name)
        if leaf.nested or leaf.physical == INT96:
            return None
        for rg in range(len(footer.row_groups)):
            cm = footer.chunk(rg, name).meta_data
            st = cm.statistics
            nulls = st.null_count if st is not None else None
            if nulls is not None and nulls >= cm.num_values:
                continue                      # no value to bound
            if st is None or st.min_value is None or st.max_value is None:
                return None
            a, b = _stat_int(st.min_value, leaf), _stat_int(st.max_value,
                                                            leaf)
            if a is None or b is None:
                return None
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
    return None if lo is None else (lo, hi)


def scan_keys_unique(paths: Sequence[str], names: Sequence[str]) -> bool:
    """Exact distinctness of the named column tuple over every row of the
    files, nulls excluded (`HostBatch.keys_unique`): the key columns are
    decoded once, and the answer is cached by the files' identity."""
    if not names:
        return False
    key = ("unique", _files_key(paths), tuple(names))
    with _plan_stats_lock:
        if key in _plan_stats:
            return _plan_stats[key]
    footers = [read_footer(p) for p in paths]
    if any(n not in f.names or f.leaf(n).nested for f in footers
           for n in names):
        return False
    parts = [read_row_group(p, rg, names) for p, f in zip(paths, footers)
             for rg in range(len(f.row_groups))]
    out = bool(parts) and concat_host(parts).keys_unique(list(names))
    with _plan_stats_lock:
        if len(_plan_stats) > 1024:
            _plan_stats.clear()
        _plan_stats[key] = out
    return out


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------

class LogicalParquetScan(L.LogicalPlan):
    def __init__(self, paths: Sequence[str], columns=None):
        super().__init__()
        self.paths = list(paths)
        self.columns = list(columns) if columns else None
        self.pushed_filter: Optional[E.Expression] = None

    def _resolve_schema(self):
        return parquet_schema(self.paths, self.columns)

    def describe(self):
        extra = f", pushed={self.pushed_filter!r}" if self.pushed_filter else ""
        return f"ParquetScan[{len(self.paths)} files{extra}]"


class ParquetScanExec(PlanNode):
    """Device scan: threaded host decode overlapped with the upload."""

    def __init__(self, paths, columns, schema: t.StructType,
                 filter_expr: Optional[E.Expression] = None):
        super().__init__()
        self.paths = list(paths)
        self.columns = columns
        self._schema = schema
        self.filter_expr = filter_expr

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    def column_range(self, name):
        return scan_column_range(self.paths, name) \
            if name in self._schema.names else None

    def keys_unique(self, names):
        return all(n in self._schema.names for n in names) and \
            scan_keys_unique(self.paths, names)

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for hb, origin in host_batch_stream_with_origin(
                self.paths, self.columns, ctx.conf, self.filter_expr):
            ctx.bump("scanned_rows", hb.num_rows)
            db = to_device(hb, ctx.conf, device=ctx.device)
            db.origin_file = origin      # input_file_name provenance
            set_current_input_file(origin)
            yield db

    def describe(self):
        return f"ParquetScanExec[{len(self.paths)} files]"


class CpuParquetScanExec(HostNode):
    def __init__(self, paths, columns, schema: t.StructType,
                 filter_expr: Optional[E.Expression] = None):
        super().__init__()
        self.paths = list(paths)
        self.columns = columns
        self._schema = schema
        self.filter_expr = filter_expr

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    def column_range(self, name):
        return scan_column_range(self.paths, name) \
            if name in self._schema.names else None

    def keys_unique(self, names):
        return all(n in self._schema.names for n in names) and \
            scan_keys_unique(self.paths, names)

    def _execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        for hb, origin in host_batch_stream_with_origin(
                self.paths, self.columns, ctx.conf, self.filter_expr):
            set_current_input_file(origin)
            yield hb

    def describe(self):
        return f"CpuParquetScanExec[{len(self.paths)} files]"


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _decimal_bytes(precision: int) -> int:
    """pyarrow's FIXED_LEN_BYTE_ARRAY width for a decimal precision."""
    n = 1
    while 10 ** precision > 2 ** (8 * n - 1):
        n += 1
    return n


def _schema_element(f: t.StructField) -> TStruct:
    """The leaf pyarrow's writer emits for the reference's Arrow type."""
    dt = f.data_type
    el = TStruct(name=f.name,
                 repetition_type=OPTIONAL if f.nullable else REQUIRED)
    if isinstance(dt, t.BooleanType):
        el.type = BOOLEAN
    elif isinstance(dt, (t.ByteType, t.ShortType)):
        bits = 8 if isinstance(dt, t.ByteType) else 16
        el.type = INT32
        el.converted_type = INT_8 if bits == 8 else INT_16
        el.logicalType = TStruct(INTEGER=TStruct(bitWidth=bits,
                                                 isSigned=True))
    elif isinstance(dt, t.IntegerType):
        el.type = INT32
    elif isinstance(dt, t.LongType):
        el.type = INT64
    elif isinstance(dt, t.FloatType):
        el.type = FLOAT
    elif isinstance(dt, t.DoubleType):
        el.type = DOUBLE
    elif isinstance(dt, t.StringType):
        el.type = BYTE_ARRAY
        el.converted_type = UTF8
        el.logicalType = TStruct(STRING=TStruct())
    elif isinstance(dt, t.DateType):
        el.type = INT32
        el.converted_type = C_DATE
        el.logicalType = TStruct(DATE=TStruct())
    elif isinstance(dt, t.TimestampType):
        el.type = INT64
        el.converted_type = TS_MICROS
        el.logicalType = TStruct(TIMESTAMP=TStruct(
            isAdjustedToUTC=True, unit=TStruct(MICROS=TStruct())))
    elif isinstance(dt, t.DecimalType):
        el.type = FLBA
        el.type_length = _decimal_bytes(dt.precision)
        el.converted_type = C_DECIMAL
        el.scale, el.precision = dt.scale, dt.precision
        el.logicalType = TStruct(DECIMAL=TStruct(scale=dt.scale,
                                                 precision=dt.precision))
    elif isinstance(dt, t.NullType):
        el.type = INT32
        el.logicalType = TStruct(UNKNOWN=TStruct())
    else:
        raise _unported(f"writing a {dt.simple_string} column to parquet "
                        f"({NESTED_SLICE})")
    return el


def _uleb(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _bitpack(values: np.ndarray, width: int) -> bytes:
    """One bit-packed run of the RLE / bit-packed hybrid."""
    n = len(values)
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, np.uint32)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(width, dtype=np.uint32)) & 1) \
        .astype(np.uint8)
    return _uleb(groups << 1 | 1) + np.packbits(
        bits.reshape(-1), bitorder="little").tobytes()


def _levels(valid: np.ndarray) -> bytes:
    """v1 definition levels: 4-byte length, then one RLE run (all valid)
    or one bit-packed run."""
    n = len(valid)
    if valid.all():
        body = _uleb(n << 1) + b"\x01"
    else:
        body = _bitpack(valid.astype(np.uint32), 1)
    return struct.pack("<I", len(body)) + body


def _flba_decimal(col: HostColumn, width: int, idx: np.ndarray
                  ) -> np.ndarray:
    """The rows `idx` of a DECIMAL column as big-endian two's complement
    of `width` bytes (pyarrow's FIXED_LEN_BYTE_ARRAY decimals)."""
    lo = col.data[idx].astype(np.int64)
    if col.hi is None and width <= 8:
        return np.ascontiguousarray(
            lo.astype(">i8").view(np.uint8).reshape(-1, 8)[:, 8 - width:])
    hi = col.hi_lane()[idx]
    rows = np.empty((len(lo), 16), np.uint8)
    rows[:, :8] = hi.astype(">i8").view(np.uint8).reshape(-1, 8)
    rows[:, 8:] = lo.view(np.uint64).astype(">u8").view(np.uint8) \
        .reshape(-1, 8)
    return np.ascontiguousarray(rows[:, 16 - width:])


def _plain_bytes(col: HostColumn, el: TStruct, idx: np.ndarray) -> bytes:
    """PLAIN values of the rows `idx` (the valid ones)."""
    dt = col.dtype
    if isinstance(dt, t.BooleanType):
        return np.packbits(col.data[idx].astype(np.uint8),
                           bitorder="little").tobytes()
    if isinstance(dt, t.StringType):
        return _plain_strings(col.dictionary, col.data[idx])
    if isinstance(dt, t.DecimalType):
        return _flba_decimal(col, el.type_length, idx).tobytes()
    lane = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[el.type]
    return col.data[idx].astype(lane).tobytes()


def _encoded_entries(dictionary: np.ndarray):
    """(bytes of every entry with its 4-byte length, entry offsets)."""
    enc = [s.encode("utf-8") for s in dictionary.tolist()]
    lens = np.array([len(b) for b in enc], np.int64)
    body = b"".join(struct.pack("<I", len(b)) + b for b in enc)
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum(lens + 4, out=offs[1:])
    return np.frombuffer(body, np.uint8), offs


def _plain_strings(dictionary: np.ndarray, codes: np.ndarray) -> bytes:
    """PLAIN BYTE_ARRAY values of dictionary codes, gathered without a
    per-row Python loop."""
    entries, eoff = _encoded_entries(dictionary)
    if not len(codes):
        return b""
    sizes = (eoff[1:] - eoff[:-1])[codes]
    out_off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(sizes, out=out_off[1:])
    total = int(out_off[-1])
    src = np.arange(total, dtype=np.int64) - np.repeat(out_off[:-1], sizes) \
        + np.repeat(eoff[codes], sizes)
    return entries[src].tobytes()


def _stats(col: HostColumn, el: TStruct, idx: np.ndarray, nulls: int
           ) -> TStruct:
    st = TStruct(null_count=nulls)
    dt = col.dtype
    if not len(idx) or isinstance(dt, t.NullType):
        return st
    if isinstance(dt, t.StringType):
        codes = col.data[idx]
        lo, hi = col.dictionary[codes.min()], col.dictionary[codes.max()]
        st.min_value, st.max_value = lo.encode("utf-8"), hi.encode("utf-8")
        return st
    if isinstance(dt, t.DecimalType):
        u = col.unscaled()[idx] if col.hi is not None else \
            col.data[idx].astype(np.int64)
        w = el.type_length
        st.min_value = int(u.min()).to_bytes(w, "big", signed=True)
        st.max_value = int(u.max()).to_bytes(w, "big", signed=True)
        return st
    v = col.data[idx]
    if isinstance(dt, (t.FloatType, t.DoubleType)):
        v = v[~np.isnan(v)]
        if not len(v):
            return st
        # a zero bound is written as -0.0 (min) and +0.0 (max), as the
        # format asks
        lo = v.dtype.type(-0.0) if v.min() == 0 else v.min()
        hi = v.dtype.type(0.0) if v.max() == 0 else v.max()
    else:
        lo, hi = v.min(), v.max()
    if isinstance(dt, t.BooleanType):
        st.min_value, st.max_value = bytes([bool(lo)]), bytes([bool(hi)])
        return st
    lane = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[el.type]
    st.min_value = np.asarray(lo).astype(lane).tobytes()
    st.max_value = np.asarray(hi).astype(lane).tobytes()
    return st


def _page(ptype: int, body: bytes, codec: int, header: dict) -> bytes:
    comp = compress(codec, body)
    ph = TStruct(type=ptype, uncompressed_page_size=len(body),
                 compressed_page_size=len(comp), **header)
    return write_struct("PageHeader", ph) + comp


def _encode_chunk(col: HostColumn, el: TStruct, codec: int):
    """-> (chunk bytes, ColumnMetaData without offsets, uncompressed
    bytes, offset of the first data page within the chunk, whether a
    dictionary page leads)."""
    n = len(col)
    valid = col.valid_mask()
    nulls = int(n - valid.sum())
    idx = np.flatnonzero(valid)
    dt = col.dtype
    out = bytearray()
    uncompressed = 0
    encodings = [PLAIN, RLE]
    use_dict = False
    if isinstance(dt, t.StringType) and len(idx):
        codes = col.data[idx]
        used = np.bincount(codes, minlength=len(col.dictionary)) > 0
        remap = np.cumsum(used) - 1
        entries = col.dictionary[used]
        dict_body = _plain_strings(entries, np.arange(len(entries)))
        if len(dict_body) <= _DICT_LIMIT:
            use_dict = True
            page = _page(DICTIONARY_PAGE, dict_body, codec, {
                "dictionary_page_header": TStruct(
                    num_values=len(entries), encoding=PLAIN)})
            out += page
            uncompressed += len(dict_body)
            width = max(1, int(len(entries) - 1).bit_length())
            dict_codes = remap[col.data].astype(np.uint32)
            encodings = [PLAIN, RLE, RLE_DICTIONARY]
    data_start = len(out)
    for off in range(0, max(n, 1), _PAGE_ROWS):
        rows = min(_PAGE_ROWS, n - off)
        sl = slice(off, off + rows)
        pv = valid[sl]
        body = _levels(pv) if el.repetition_type == OPTIONAL else b""
        page_idx = idx[(idx >= off) & (idx < off + rows)]
        if isinstance(dt, t.NullType):
            pass
        elif use_dict:
            body += bytes([width]) + (_bitpack(dict_codes[page_idx], width)
                                      if len(page_idx) else b"")
        else:
            body += _plain_bytes(col, el, page_idx)
        uncompressed += len(body)
        out += _page(DATA_PAGE, body, codec, {
            "data_page_header": TStruct(
                num_values=rows,
                encoding=RLE_DICTIONARY if use_dict else PLAIN,
                definition_level_encoding=RLE,
                repetition_level_encoding=RLE)})
    cm = TStruct(type=el.type, encodings=encodings,
                 path_in_schema=[el.name], codec=codec, num_values=n,
                 total_uncompressed_size=uncompressed,
                 total_compressed_size=len(out),
                 statistics=_stats(col, el, idx, nulls))
    return bytes(out), cm, data_start, use_dict


class ParquetFileWriter:
    """Streams HostBatches into one Parquet file: each batch becomes row
    groups of at most `row_group_rows` rows, their column chunks encoded
    in parallel."""

    def __init__(self, sink, schema: t.StructType, compression: str = "zstd"):
        codec = CODECS.get(str(compression).lower())
        if codec is None:
            raise _unported(f"the {compression} parquet codec (codec)")
        self.codec = codec
        self.schema = schema
        self.elements = [_schema_element(f) for f in schema.fields]
        self._own = isinstance(sink, str)
        self._f = open(sink, "wb") if self._own else sink
        self._f.write(MAGIC)
        self._pos = 4
        self.row_groups: List[TStruct] = []
        self.num_rows = 0
        self.uncompressed_bytes = 0
        self._pool = cf.ThreadPoolExecutor(
            max_workers=min(8, max(1, len(schema.fields))))

    def write_batch(self, hb: HostBatch, row_group_rows: int = 1 << 20):
        n = hb.num_rows
        for off in range(0, n, row_group_rows):
            self._row_group(hb.slice(off, min(row_group_rows, n - off))
                            if n > row_group_rows else hb)

    def _row_group(self, hb: HostBatch) -> None:
        cols = [hb.column_by_name(f.name) for f in self.schema.fields]
        encoded = list(self._pool.map(
            lambda ce: _encode_chunk(ce[0], ce[1], self.codec),
            zip(cols, self.elements)))
        chunks = []
        start = self._pos
        total_unc = 0
        for (raw, cm, data_start, has_dict) in encoded:
            off = self._pos
            cm.data_page_offset = off + data_start
            if has_dict:
                cm.dictionary_page_offset = off
            self._f.write(raw)
            self._pos += len(raw)
            total_unc += cm.total_uncompressed_size
            chunks.append(TStruct(file_offset=off, meta_data=cm))
        self.row_groups.append(TStruct(
            columns=chunks, total_byte_size=total_unc,
            num_rows=hb.num_rows, file_offset=start,
            total_compressed_size=self._pos - start,
            ordinal=len(self.row_groups)))
        self.num_rows += hb.num_rows
        self.uncompressed_bytes += total_unc

    def close(self) -> int:
        """Write the footer; -> the file's bytes."""
        self._pool.shutdown()
        root = TStruct(name="schema", num_children=len(self.elements))
        meta = TStruct(version=2, schema=[root] + self.elements,
                       num_rows=self.num_rows, row_groups=self.row_groups,
                       created_by="spark_rapids_tpu_torch parquet writer",
                       column_orders=[TStruct(TYPE_ORDER=TStruct())
                                      for _ in self.elements])
        raw = write_struct("FileMetaData", meta)
        self._f.write(raw + struct.pack("<I", len(raw)) + MAGIC)
        self._pos += len(raw) + 8
        if self._own:
            self._f.close()
        return self._pos


def write_table(hb: HostBatch, path, compression: str = "zstd",
                row_group_rows: int = 1 << 20) -> int:
    """One HostBatch as one Parquet file (a path or a binary sink); -> the
    file's bytes."""
    w = ParquetFileWriter(path, hb.schema, compression)
    if hb.num_rows:
        w.write_batch(hb, row_group_rows)
    return w.close()


def _partition_value(col: HostColumn, row: int) -> str:
    """A Hive directory value, as pyarrow's hive partitioning writes it."""
    v = col.slice(row, 1).to_pylist()[0]
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def hive_partitions(root: str) -> List[Tuple[str, Dict[str, str]]]:
    """(file, {partition column: value}) of every parquet file under a
    Hive-style `col=value/` tree, sorted by path."""
    out = []
    for d, _dirs, files in sorted(os.walk(root)):
        rel = os.path.relpath(d, root)
        parts = {} if rel == "." else dict(
            p.split("=", 1) for p in rel.split(os.sep) if "=" in p)
        for f in sorted(files):
            if f.endswith(".parquet"):
                out.append((os.path.join(d, f), parts))
    return out


def write_parquet(df, path: str, partition_by: Optional[Sequence[str]] = None,
                  compression: str = "zstd",
                  row_group_rows: int = 1 << 20,
                  bucket_by: Optional[Tuple[Sequence[str], int]] = None
                  ) -> None:
    """Stream query results into parquet without materializing the whole
    result, or (`partition_by`, `bucket_by`) write the collected result
    as the reference does: Hive `col=value/part-0.parquet` directories
    without the partition columns, or one file a bucket named
    `part-00000-{bucket:05d}.c000.parquet`, rows routed by Spark's
    Murmur3 hash of the bucket columns pmod n."""
    from ..exec.host_exec import take_rows
    q = df.physical()
    schema = df.schema
    if bucket_by:
        cols, n_buckets = bucket_by
        tbl = q.collect()
        os.makedirs(path, exist_ok=True)
        if not tbl.num_rows:
            return
        bound = E.Murmur3Hash(*[E.ColumnRef(c) for c in cols]).bind(
            tbl.schema)
        hv = bound.eval_cpu(tbl).data.astype(np.int64)
        b = ((hv % n_buckets) + n_buckets) % n_buckets   # Spark pmod
        for bid in range(n_buckets):
            rows = np.flatnonzero(b == bid)
            if not len(rows):
                continue
            write_table(take_rows(tbl, rows), os.path.join(
                path, f"part-00000-{bid:05d}.c000.parquet"), compression,
                row_group_rows)
        return
    if partition_by:
        tbl = q.collect()
        keep = [n for n in tbl.names if n not in partition_by]
        keys = [tbl.column_by_name(c) for c in partition_by]
        from ..ops.host import group_ids
        gid, ngroups, _first = group_ids(keys, tbl.num_rows)
        for g in range(ngroups):
            rows = np.flatnonzero(gid == g)
            first = int(rows[0])
            d = os.path.join(path, *[
                f"{c}={_partition_value(k, first)}"
                for c, k in zip(partition_by, keys)])
            os.makedirs(d, exist_ok=True)
            write_table(take_rows(tbl, rows).select(keep),
                        os.path.join(d, "part-0.parquet"), compression,
                        row_group_rows)
        return
    p = path
    if not p.endswith(".parquet"):
        os.makedirs(p, exist_ok=True)
        p = os.path.join(p, "part-00000.parquet")
    writer = ParquetFileWriter(p, schema, compression)
    try:
        for hb in q.execute_host_batches():
            if hb.num_rows == 0:
                continue
            writer.write_batch(hb.select(schema.names), row_group_rows)
    finally:
        writer.close()
