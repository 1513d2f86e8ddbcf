"""CSV / JSON lines / Hive text scans, parsed by the port itself.

Counterpart of spark_rapids_tpu/io/text.py, which parses through
pyarrow.csv and pyarrow.json.  The card's machine has no pyarrow, so the
port parses on the host with Python's `csv` and `json` and keeps
pyarrow's rules, which the reference inherits:

  * CSV: `sep`, `header` (False: columns f0, f1, ...) and `column_names`
    (the first row is data); empty lines skipped; pyarrow's null markers
    and true / false spellings; numbers, dates and timestamps trimmed of
    blanks, booleans and strings not; a STRING column holds no null
    (`strings_can_be_null=False`); each column's type inferred over every
    row in pyarrow's order null -> int64 -> boolean -> date32 -> time32
    -> timestamp[s] -> timestamp[ns] -> the zoned timestamps -> float64
    -> string, or converted to the type the schema gives;
  * JSON lines: objects become STRUCT and arrays ARRAY columns (the port's
    nested host layout), fields in order of first appearance, int and
    float mixed to DOUBLE, strings that are all ISO dates or timestamps
    to TIMESTAMP, a number and a string in one field an error;
  * Hive text: the reference's serde copied (the \\N null marker matched
    before unescaping, empty non-string fields null, unparseable
    primitives null), its fast path through the port's CSV converters.

Scans read files through a thread pool (the reference's `_stream`).
"""
from __future__ import annotations

import concurrent.futures as cf
import csv
import datetime as pydt
import decimal as pydec
import io
import json
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from ..columnar.device import DeviceBatch, to_device
from ..columnar.host import (EXACT, HostBatch, HostColumn, from_pydict,
                             result_struct, string_column)
from ..exec.host_exec import HostNode
from ..exec.plan import ExecContext, PlanNode
from ..plan import logical as L

#: pyarrow.csv's ConvertOptions defaults
NULL_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"])
TRUE_VALUES = frozenset(["1", "True", "TRUE", "true"])
FALSE_VALUES = frozenset(["0", "False", "FALSE", "false"])

_INT = re.compile(r"\s*(-?)(?:0[xX]([0-9a-fA-F]+)|([0-9]+))\s*\Z")
_FLOAT = re.compile(r"\s*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)"
                    r"(?:[eE][+-]?[0-9]+)?|inf|infinity)\s*\Z", re.I)
_DATE = re.compile(r"\s*([0-9]{4})-([0-9]{2})-([0-9]{2})\s*\Z")
_TIME = re.compile(r"\s*[0-9]{2}:[0-9]{2}(?::[0-9]{2})?\s*\Z")
_TS = re.compile(r"\s*([0-9]{4})-([0-9]{2})-([0-9]{2})[T ]([0-9]{2})"
                 r"(?::([0-9]{2})(?::([0-9]{2})(?:\.([0-9]{1,9}))?)?)?"
                 r"(Z|[+-][0-9]{2}(?::?[0-9]{2})?)?\s*\Z")
_EPOCH_DAY = pydt.date(1970, 1, 1).toordinal()
_I64 = (-(1 << 63), (1 << 63) - 1)


class TextParseError(ValueError):
    """A value that does not convert to its column's type."""


# ---------------------------------------------------------------------------
# Value converters: str -> storage value, or None when the value does not
# fit the kind
# ---------------------------------------------------------------------------

def _to_int(v: str):
    m = _INT.match(v)
    if not m:
        return None
    x = int(m.group(2), 16) if m.group(2) else int(m.group(3))
    x = -x if m.group(1) else x
    return x if _I64[0] <= x <= _I64[1] else None


def _to_bool(v: str):
    return True if v in TRUE_VALUES else False if v in FALSE_VALUES \
        else None


def _to_date(v: str):
    m = _DATE.match(v)
    if not m:
        return None
    try:
        d = pydt.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))
    except ValueError:
        return None
    return d.toordinal() - _EPOCH_DAY


def _ts_parts(v: str):
    """(microseconds since the epoch, has a fraction, has a zone)."""
    m = _TS.match(v)
    if not m:
        return None
    y, mo, d, hh, mm, ss, frac, zone = m.groups()
    try:
        day = pydt.date(int(y), int(mo), int(d)).toordinal() - _EPOCH_DAY
    except ValueError:
        return None
    h, mi, s = int(hh), int(mm or 0), int(ss or 0)
    if h > 23 or mi > 59 or s > 59:
        return None
    us = ((day * 24 + h) * 60 + mi) * 60 + s
    us = us * 1_000_000 + (int((frac or "0").ljust(9, "0")) // 1000)
    if zone and zone != "Z":
        sign = -1 if zone[0] == "-" else 1
        z = zone[1:].replace(":", "")
        off = int(z[:2]) * 60 + (int(z[2:4]) if len(z) > 2 else 0)
        us -= sign * off * 60_000_000
    return us, frac is not None, zone is not None


def _ts_kind(want_frac_ok: bool, want_zone: bool):
    def conv(v: str):
        p = _ts_parts(v)
        if p is None or p[2] != want_zone or (p[1] and not want_frac_ok):
            return None
        return p[0]
    return conv


def _to_float(v: str):
    if not _FLOAT.match(v):
        return None
    return float(v)


def _to_time(v: str):
    return 0 if _TIME.match(v) else None


#: pyarrow.csv's inference order: (kind, converter, port type)
_KINDS = [("int64", _to_int, t.LONG), ("bool", _to_bool, t.BOOLEAN),
          ("date32", _to_date, t.DATE), ("time32", _to_time, None),
          ("timestamp[s]", _ts_kind(False, False), t.TIMESTAMP),
          ("timestamp[ns]", _ts_kind(True, False), t.TIMESTAMP),
          ("timestamp[s, tz=UTC]", _ts_kind(False, True), t.TIMESTAMP),
          ("timestamp[ns, tz=UTC]", _ts_kind(True, True), t.TIMESTAMP),
          ("double", _to_float, t.DOUBLE)]


def _convert_all(vals: List[str], conv) -> Optional[list]:
    out = []
    for v in vals:
        x = conv(v)
        if x is None:
            return None
        out.append(x)
    return out


def _decimal_conv(dt: t.DecimalType):
    def conv(v: str):
        try:
            d = pydec.Decimal(v.strip())
        except pydec.InvalidOperation:
            return None
        if not d.is_finite():
            return None
        u = d.scaleb(dt.scale, EXACT)
        if u != u.to_integral_value() or abs(u) >= 10 ** dt.precision:
            return None
        return int(u)
    return conv


def _typed_conv(dt: t.DataType):
    """The converter of an explicitly typed column."""
    if isinstance(dt, t.BooleanType):
        return _to_bool
    if isinstance(dt, t.IntegralType):
        bits = {t.ByteType: 8, t.ShortType: 16, t.IntegerType: 32,
                t.LongType: 64}[type(dt)]

        def conv(v: str):
            x = _to_int(v)
            return x if x is not None and -(1 << (bits - 1)) <= x < \
                (1 << (bits - 1)) else None
        return conv
    if isinstance(dt, t.FractionalType) and not isinstance(dt,
                                                           t.DecimalType):
        return _to_float
    if isinstance(dt, t.DecimalType):
        return _decimal_conv(dt)
    if isinstance(dt, t.DateType):
        return _to_date
    if isinstance(dt, t.TimestampType):
        def conv(v: str):
            p = _ts_parts(v)
            if p is None:
                d = _to_date(v)
                return None if d is None else d * 86_400_000_000
            return p[0]
        return conv
    raise TypeError(f"unsupported column type {dt} for a text scan")


def _column(vals: List[str], dt: t.DataType, nulls=NULL_VALUES,
            strict: bool = True) -> HostColumn:
    """Raw field strings -> a HostColumn of `dt`.  `strict`: a value that
    does not convert raises (pyarrow.csv); else it is null (Hive)."""
    if isinstance(dt, t.StringType):
        return string_column(np.array(vals, dtype=object))
    if isinstance(dt, t.NullType):
        n = len(vals)
        return HostColumn(np.zeros(n, np.int32), np.zeros(n, bool), dt)
    conv = _typed_conv(dt)
    lane = np.zeros(len(vals), t.physical_np_dtype(dt))
    valid = np.ones(len(vals), bool)
    for i, v in enumerate(vals):
        if v in nulls:
            valid[i] = False
            continue
        x = conv(v)
        if x is None:
            if strict:
                raise TextParseError(f"cannot convert {v!r} to {dt}")
            valid[i] = False
            continue
        lane[i] = x
    if isinstance(dt, t.DecimalType) and dt.is_wide:
        from ..columnar.host import wide_decimal_column
        ints = np.zeros(len(vals), dtype=object)
        for i, v in enumerate(vals):
            if valid[i]:
                ints[i] = conv(v)
        return wide_decimal_column(ints, None if valid.all() else valid, dt)
    return HostColumn(lane, None if valid.all() else valid, dt)


def infer_type(vals: List[str], nulls=NULL_VALUES) -> t.DataType:
    """pyarrow.csv's inferred type of a column's raw values."""
    live = [v for v in vals if v not in nulls]
    if not live:
        return t.NULL
    for kind, conv, dt in _KINDS:
        if _convert_all(live, conv) is not None:
            if dt is None:
                raise TypeError(f"unsupported inferred type {kind} in the "
                                "port (a CSV column of times)")
            return dt
    return t.STRING


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

def _split_csv(text: str, sep: str, quoting: bool) -> List[List[str]]:
    if quoting:
        rows = csv.reader(io.StringIO(text, newline=""), delimiter=sep,
                          quotechar='"', doublequote=True, strict=False)
        return [r for r in rows if r]
    return [line.rstrip("\r").split(sep) for line in text.split("\n")
            if line.rstrip("\r")]


def _table(rows: List[List[str]], names: List[str], schema, nulls,
           strict: bool) -> HostBatch:
    ncols = len(names)
    for i, r in enumerate(rows):
        if len(r) != ncols:
            raise TextParseError(f"Expected {ncols} columns, got {len(r)} "
                                 f"in row {i}")
    cols = []
    by_name = {} if schema is None else {f.name: f.data_type
                                         for f in schema.fields}
    for j, name in enumerate(names):
        vals = [r[j] for r in rows]
        dt = by_name.get(name)
        if dt is None:
            dt = infer_type(vals, nulls)
        cols.append(_column(vals, dt, nulls, strict))
    return HostBatch(cols, names)


def _read_csv(path: str, schema, opts) -> HostBatch:
    schema = None if schema is None else result_struct(schema)
    sep = opts.get("sep", ",")
    with open(path, encoding="utf-8", newline="") as f:
        text = f.read()
    rows = _split_csv(text, sep, True)
    names = opts.get("column_names")
    if names is None:
        if opts.get("header", True) is False:
            width = len(rows[0]) if rows else 0
            names = [f"f{i}" for i in range(width)]
        else:
            names, rows = (rows[0] if rows else []), rows[1:]
    return _table(rows, list(names), schema, NULL_VALUES, True)


# ---------------------------------------------------------------------------
# JSON lines
# ---------------------------------------------------------------------------

_JSON_TS = re.compile(r"[0-9]{4}-[0-9]{2}-[0-9]{2}"
                      r"(?:[T ][0-9]{2}:[0-9]{2}(?::[0-9]{2})?)?Z?\Z")


def _json_kind(v):
    """The pyarrow.json kind of one value: a tuple tree."""
    if v is None:
        return ("null",)
    if isinstance(v, bool):
        return ("bool",)
    if isinstance(v, int):
        return ("int",) if _I64[0] <= v <= _I64[1] else ("double",)
    if isinstance(v, float):
        return ("double",)
    if isinstance(v, str):
        return ("string", bool(_JSON_TS.match(v)))
    if isinstance(v, list):
        k = ("null",)
        for x in v:
            k = _merge(k, _json_kind(x))
        return ("list", k)
    if isinstance(v, dict):
        return ("struct", tuple((n, _json_kind(x)) for n, x in v.items()))
    raise TypeError(f"unsupported JSON value {v!r}")


def _merge(a, b):
    if a[0] == "null":
        return b
    if b[0] == "null":
        return a
    if {a[0], b[0]} == {"int", "double"}:
        return ("double",)
    if a[0] != b[0]:
        raise TextParseError(f"JSON column changed from {a[0]} to {b[0]}")
    if a[0] == "string":
        return ("string", a[1] and b[1])
    if a[0] == "list":
        return ("list", _merge(a[1], b[1]))
    if a[0] == "struct":
        fields = dict(a[1])
        order = [n for n, _ in a[1]]
        for n, k in b[1]:
            if n in fields:
                fields[n] = _merge(fields[n], k)
            else:
                fields[n] = k
                order.append(n)
        return ("struct", tuple((n, fields[n]) for n in order))
    return a


def _kind_type(k) -> t.DataType:
    return {"null": lambda: t.NULL, "bool": lambda: t.BOOLEAN,
            "int": lambda: t.LONG, "double": lambda: t.DOUBLE,
            "string": lambda: t.TIMESTAMP if k[1] else t.STRING,
            "list": lambda: t.ArrayType(_kind_type(k[1])),
            "struct": lambda: t.StructType([
                t.StructField(n, _kind_type(c)) for n, c in k[1]]),
            }[k[0]]()


def _json_value(v, dt: t.DataType):
    """A parsed JSON value as from_pydict's input for `dt`."""
    if v is None:
        return None
    if isinstance(dt, t.TimestampType):
        if isinstance(v, str):
            p = _ts_parts(v) if "T" in v or " " in v else None
            if p is None:
                d = _to_date(v)
                us = d * 86_400_000_000
            else:
                us = p[0]
            return pydt.datetime(1970, 1, 1, tzinfo=pydt.timezone.utc) + \
                pydt.timedelta(microseconds=us)
        return v
    if isinstance(dt, t.DoubleType):
        return float(v)
    if isinstance(dt, t.ArrayType):
        return [_json_value(x, dt.element_type) for x in v]
    if isinstance(dt, t.StructType):
        return {f.name: _json_value(v.get(f.name), f.data_type)
                for f in dt.fields}
    return v


def _read_json(path: str, schema, opts) -> HostBatch:
    schema = None if schema is None else result_struct(schema)
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if schema is None:
        kind = ("struct", ())
        for r in rows:
            kind = _merge(kind, _json_kind(r))
        schema = _kind_type(kind)
    data = {f.name: [_json_value(r.get(f.name), f.data_type) for r in rows]
            for f in schema.fields}
    return from_pydict(data, schema)


# ---------------------------------------------------------------------------
# Hive text
# ---------------------------------------------------------------------------

def _read_hive_text(path: str, schema, opts) -> HostBatch:
    """Hive default text serde: ctrl-A field delimiter, \\N nulls, no
    header (the reference's GpuHiveTextFileFormat role).

    Hive's LazySimpleSerDe matches the \\N null marker BEFORE unescaping
    (so \\N is null while \\\\N is the literal 2-char string \\N).  Files
    containing any backslash go through a token-level parser with Hive's
    exact semantics; backslash-free files take the fast split.  Only the
    empty field is null there (and only for non-string types), and an
    unparseable primitive is null, never an error."""
    opts = dict(opts or {})
    schema = None if schema is None else result_struct(schema)
    sep = opts.get("sep", "\x01")
    names = opts.get("column_names")
    if names is None and schema is not None:
        names = schema.names
    with open(path, "rb") as f:
        raw = f.read()
    if b"\\" in raw:
        return _parse_hive_escaped(raw.decode("utf-8"), sep, names, schema)
    rows = _split_csv(raw.decode("utf-8"), sep, False)
    if names is None:
        width = max((len(r) for r in rows), default=0)
        names = [f"f{i}" for i in range(width)]
    rows = [r + [""] * (len(names) - len(r)) if len(r) < len(names)
            else r for r in rows]
    return _table(rows, list(names), schema, frozenset([""]), False)


def _parse_hive_escaped(data: str, sep: str, names, schema) -> HostBatch:
    """Token-level hive parse: split rows/fields on UNESCAPED newline/
    delimiter, null-match raw tokens against \\N, then unescape."""
    rows: List[List] = []
    fields: List = []
    tok: List[str] = []
    esc = False

    def end_field():
        raw_tok = "".join(tok)
        if raw_tok == "\\N":
            fields.append(None)
        else:
            fields.append(re.sub(r"\\(.)", r"\1", raw_tok, flags=re.DOTALL))
        tok.clear()

    for ch in data:
        if esc:
            tok.append(ch)
            esc = False
        elif ch == "\\":
            tok.append("\\")
            esc = True
        elif ch == sep:
            end_field()
        elif ch == "\n":
            end_field()
            rows.append(list(fields))
            fields.clear()
        else:
            tok.append(ch)
    if tok or fields:
        end_field()
        rows.append(list(fields))
    ncols = max((len(r) for r in rows), default=0)
    if names is None:
        names = [f"f{i}" for i in range(ncols)]
    cols = []
    for i, name in enumerate(names):
        vals = [r[i] if i < len(r) else None for r in rows]
        dt = t.STRING if schema is None else schema[name].data_type
        cols.append(_cast_or_null(vals, dt))
    return HostBatch(cols, list(names))


def _cast_or_null(vals, dt: t.DataType) -> HostColumn:
    """Hive primitive conversion: unparseable or empty fields become
    null, never errors (LazySimpleSerDe contract); None is null."""
    if isinstance(dt, t.StringType):
        return string_column(np.array(vals, dtype=object))
    marked = ["" if v is None else v for v in vals]
    return _column(marked, dt, frozenset([""]), strict=False)


def write_hive_text(table: HostBatch, path: str, sep: str = "\x01") -> None:
    """Writer half of the hive text serde: the on-disk \\N null marker,
    backslash-escaped delimiter/newline/CR/backslash (LazySimpleSerDe
    escaping; a literal \\N VALUE round-trips as \\\\N exactly like
    Hive).  Takes a HostBatch (the reference takes a pa.Table)."""
    for name, c in zip(table.names, table.columns):
        if isinstance(c.dtype, t.BinaryType):
            raise TypeError(f"hive text cannot carry binary column "
                            f"{name}; use parquet/orc/avro")

    def esc(v) -> str:
        s = v if isinstance(v, str) else str(v)
        return (s.replace("\\", "\\\\").replace(sep, "\\" + sep)
                .replace("\n", "\\\n").replace("\r", "\\\r"))

    null_marker = "\\N"
    cols = [c.to_pylist() for c in table.columns]
    with open(path, "w", encoding="utf-8", newline="") as f:
        for row in zip(*cols):
            f.write(sep.join(null_marker if v is None else esc(v)
                             for v in row) + "\n")


def write_csv(table: HostBatch, path: str, sep: str = ",") -> None:
    """A header row then one line a row: nulls empty, strings quoted
    where they hold the separator, a quote or a line break (a file
    `read_csv` reads back)."""
    cols = [c.to_pylist() for c in table.columns]
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter=sep, quotechar='"',
                       quoting=csv.QUOTE_MINIMAL, lineterminator="\n")
        w.writerow(table.names)
        for row in zip(*cols):
            w.writerow(["" if v is None else v for v in row])


def write_json(table: HostBatch, path: str) -> None:
    """JSON lines, one object a row; DATE and TIMESTAMP as ISO strings,
    DECIMAL as a number."""
    cols = [c.to_pylist() for c in table.columns]

    def enc(v):
        if isinstance(v, (pydt.date, pydt.datetime)):
            return v.isoformat().replace("+00:00", "Z")
        if isinstance(v, pydec.Decimal):
            return float(v)
        raise TypeError(type(v))

    with open(path, "w", encoding="utf-8") as f:
        for row in zip(*cols):
            f.write(json.dumps(dict(zip(table.names, row)), default=enc,
                               ensure_ascii=False) + "\n")


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def _stream(paths: Sequence[str], schema, opts, conf, reader, peeked=None
            ) -> Iterator[Tuple[HostBatch, str]]:
    """(batch, source path) pairs — provenance for input_file_name.
    `peeked` maps a file to the batch its schema was resolved from (read
    once, not twice)."""
    target = conf.batch_size_rows
    peeked = peeked or {}

    def read(p):
        hit = peeked.get(p)
        if hit is not None and hit[0] == _stamp(p):
            return hit[1]
        return reader(p, schema, opts)
    with cf.ThreadPoolExecutor(max_workers=min(8, max(1, len(paths)))) as pool:
        futs = [pool.submit(read, p) for p in paths]
        for f, path in zip(futs, paths):
            hb = f.result()
            n = hb.num_rows
            if n <= target:
                yield hb, path
                continue
            for off in range(0, n, target):
                yield hb.slice(off, min(target, n - off)), path


def _stamp(path: str):
    """A file's identity for reusing what was read of it."""
    import os
    st = os.stat(path)
    return st.st_size, st.st_mtime_ns


class _TextLogicalScan(L.LogicalPlan):
    reader = None
    fmt = "text"

    def __init__(self, paths: Sequence[str], schema=None, opts=None):
        super().__init__()
        self.paths = list(paths)
        #: the user's schema as a StructType (a pyarrow Schema converts)
        self.user_schema = None if schema is None else result_struct(schema)
        self.opts = dict(opts or {})
        #: {file: (its stamp, the batch read to resolve the schema)}: the
        #: first execution takes it instead of parsing the file again
        self.peeked: Dict[str, tuple] = {}

    def _resolve_schema(self):
        if self.user_schema is not None:
            return self.user_schema
        path = self.paths[0]
        hb = type(self).reader(path, None, self.opts)
        self.peeked = {path: (_stamp(path), hb)}
        return hb.schema

    def take_peeked(self) -> dict:
        """The schema's batch, handed to one execution (then dropped, so
        a cached plan does not pin a whole file)."""
        out, self.peeked = self.peeked, {}
        return out

    def describe(self):
        return f"{type(self).__name__}[{len(self.paths)} files]"


class LogicalCsvScan(_TextLogicalScan):
    reader = staticmethod(_read_csv)
    fmt = "csv"


class LogicalJsonScan(_TextLogicalScan):
    reader = staticmethod(_read_json)
    fmt = "json"


class LogicalHiveTextScan(_TextLogicalScan):
    reader = staticmethod(_read_hive_text)
    fmt = "hivetext"


def _conform(hb: HostBatch, want: t.StructType) -> HostBatch:
    """A file's batch in the scan's column order (a later file of the
    same scan must carry the same types)."""
    if hb.names != want.names:
        hb = hb.select(want.names)
    for f, c in zip(want.fields, hb.columns):
        if type(c.dtype) is not type(f.data_type) and \
                not isinstance(c.dtype, t.NullType):
            raise TextParseError(f"column {f.name} reads as {c.dtype}, "
                                 f"the scan's schema says {f.data_type}")
    return hb


class TextScanExec(PlanNode):
    def __init__(self, logical: _TextLogicalScan, schema: t.StructType):
        super().__init__()
        self.logical = logical
        self._schema = schema

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        from ..plan.misc import set_current_input_file
        lg = self.logical
        for hb, origin in _stream(lg.paths, lg.user_schema, lg.opts,
                                  ctx.conf, type(lg).reader,
                                  lg.take_peeked()):
            ctx.bump("scanned_rows", hb.num_rows)
            hb = _conform(hb, self._schema)
            db = to_device(hb, ctx.conf, device=ctx.device)
            db.origin_file = origin
            set_current_input_file(origin)
            yield db

    def describe(self):
        return f"TextScanExec[{self.logical.fmt}, {len(self.logical.paths)} files]"


class CpuTextScanExec(HostNode):
    def __init__(self, logical: _TextLogicalScan, schema: t.StructType):
        super().__init__()
        self.logical = logical
        self._schema = schema

    @property
    def output_schema(self) -> t.StructType:
        return self._schema

    def _execute(self, ctx: ExecContext) -> Iterator[HostBatch]:
        from ..plan.misc import set_current_input_file
        lg = self.logical
        for hb, origin in _stream(lg.paths, lg.user_schema, lg.opts,
                                  ctx.conf, type(lg).reader,
                                  lg.take_peeked()):
            set_current_input_file(origin)
            yield _conform(hb, self._schema)

    def describe(self):
        return f"CpuTextScanExec[{self.logical.fmt}, {len(self.logical.paths)} files]"
