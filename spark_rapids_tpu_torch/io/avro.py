"""Avro scan: the reference's pure-Python Object Container File codec,
copied, over the port's host columns.

Counterpart of spark_rapids_tpu/io/avro.py (GpuAvroScan.scala +
AvroDataFileReader.scala role).  The container codec is the
reference's: magic 'Obj\\x01', the file-metadata map (avro.schema JSON,
avro.codec), a 16-byte sync marker, then blocks of (row count, byte size,
payload, sync); codecs null and deflate (raw zlib); every Avro primitive,
records, enums, fixed, arrays, maps, nullable unions, and the date /
timestamp-millis / timestamp-micros / decimal logical types.  Where the
reference builds pyarrow tables, the port builds HostBatch columns,
nested ones included (a record is a STRUCT, an array an ARRAY, a map a
MAP of STRING keys), and `write_avro` takes a HostBatch.  `bytes` and
`fixed` without a decimal type have no host column in the port (no
BINARY), and raise.
"""
from __future__ import annotations

import datetime as pydt
import io
import json
import os
import struct
import zlib
from typing import Any, List, Sequence, Tuple

import numpy as np

from .. import types as t
from ..columnar.host import HostBatch, from_pydict

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# binary primitives
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    def zlong(self) -> int:
        shift = 0
        accum = 0
        while True:
            if self.pos >= len(self.buf):
                raise EOFError("truncated avro data")
            b = self.buf[self.pos]
            self.pos += 1
            accum |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (accum >> 1) ^ -(accum & 1)   # zigzag decode

    def zbytes(self) -> bytes:
        return self.read(self.zlong())


def _zigzag(n: int) -> bytes:
    n = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ---------------------------------------------------------------------------
# schema -> decoder / port type
# ---------------------------------------------------------------------------

def _logical(sc: dict):
    lt = sc.get("logicalType")
    ty = sc["type"]
    if lt == "date" and ty == "int":
        return t.DATE
    if lt in ("timestamp-micros", "timestamp-millis") and ty == "long":
        return t.TIMESTAMP
    if lt == "decimal" and ty in ("bytes", "fixed"):
        return t.DecimalType(sc["precision"], sc.get("scale", 0))
    return None


_PRIMITIVE = {
    "null": t.NULL, "boolean": t.BOOLEAN, "int": t.INT, "long": t.LONG,
    "float": t.FLOAT, "double": t.DOUBLE, "string": t.STRING,
}


def schema_to_dtype(sc) -> t.DataType:
    """The port type of an Avro schema (the reference's schema_to_arrow,
    through columnar/host.arrow_to_dtype)."""
    if isinstance(sc, str):
        if sc in ("bytes",):
            raise TypeError("avro bytes: the port has no BINARY host column")
        return _PRIMITIVE[sc]
    if isinstance(sc, list):                       # union
        non_null = [s for s in sc if s != "null"]
        if len(non_null) != 1:
            raise NotImplementedError(f"general unions: {sc}")
        return schema_to_dtype(non_null[0])
    ty = sc["type"]
    lt = _logical(sc)
    if lt is not None:
        return lt
    if ty == "record":
        return t.StructType([t.StructField(f["name"],
                                           schema_to_dtype(f["type"]))
                             for f in sc["fields"]])
    if ty == "enum":
        return t.STRING
    if ty == "fixed":
        raise TypeError("avro fixed: the port has no BINARY host column")
    if ty == "array":
        return t.ArrayType(schema_to_dtype(sc["items"]))
    if ty == "map":
        return t.MapType(t.STRING, schema_to_dtype(sc["values"]))
    return schema_to_dtype(ty)                      # {"type": "int"} wrapper


def _decode(sc, r: _Reader) -> Any:
    if isinstance(sc, str):
        if sc == "null":
            return None
        if sc == "boolean":
            return r.read(1) != b"\x00"
        if sc in ("int", "long"):
            return r.zlong()
        if sc == "float":
            return struct.unpack("<f", r.read(4))[0]
        if sc == "double":
            return struct.unpack("<d", r.read(8))[0]
        if sc == "bytes":
            return r.zbytes()
        if sc == "string":
            return r.zbytes().decode("utf-8")
        raise NotImplementedError(sc)
    if isinstance(sc, list):                       # union: branch index
        return _decode(sc[r.zlong()], r)
    ty = sc["type"]
    lt = sc.get("logicalType")
    if lt == "decimal" and ty in ("bytes", "fixed"):
        import decimal as pydec
        raw = (r.read(sc["size"]) if ty == "fixed" else r.zbytes())
        unscaled = int.from_bytes(raw, "big", signed=True)
        return pydec.Decimal(unscaled).scaleb(-sc.get("scale", 0))
    if ty == "record":
        return {f["name"]: _decode(f["type"], r) for f in sc["fields"]}
    if ty == "enum":
        return sc["symbols"][r.zlong()]
    if ty == "fixed":
        return r.read(sc["size"])
    if ty == "array":
        out = []
        while True:
            n = r.zlong()
            if n == 0:
                return out
            if n < 0:                               # block with byte size
                n = -n
                r.zlong()
            for _ in range(n):
                out.append(_decode(sc["items"], r))
    if ty == "map":
        out = []
        while True:
            n = r.zlong()
            if n == 0:
                return out
            if n < 0:
                n = -n
                r.zlong()
            for _ in range(n):
                k = r.zbytes().decode("utf-8")
                out.append((k, _decode(sc["values"], r)))
    return _decode(ty, r)                           # wrapper / logical base


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------

def read_avro_rows(path: str) -> Tuple[dict, List[dict]]:
    """Decode a container file to (schema, row dicts)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro container file")
    meta = dict(_decode({"type": "map", "values": "bytes"}, r))
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if schema.get("type") != "record":
        raise NotImplementedError("top-level schema must be a record")
    rows: List[dict] = []
    while not r.at_end():
        count = r.zlong()
        payload = r.zbytes()
        if r.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise NotImplementedError(f"avro codec {codec}")
        br = _Reader(payload)
        for _ in range(count):
            rows.append(_decode(schema, br))
    return schema, rows


_EPOCH = pydt.datetime(1970, 1, 1, tzinfo=pydt.timezone.utc)


def _host_value(sc, v):
    """A decoded value as from_pydict's input: dates and timestamps as
    Python dates and datetimes."""
    if v is None:
        return None
    if isinstance(sc, list):
        non_null = [s for s in sc if s != "null"]
        return _host_value(non_null[0], v) if len(non_null) == 1 else v
    if isinstance(sc, str):
        return v
    ty, lt = sc["type"], sc.get("logicalType")
    if lt == "date" and ty == "int":
        return pydt.date(1970, 1, 1) + pydt.timedelta(days=v)
    if lt == "timestamp-micros" and ty == "long":
        return _EPOCH + pydt.timedelta(microseconds=v)
    if lt == "timestamp-millis" and ty == "long":
        return _EPOCH + pydt.timedelta(milliseconds=v)
    if ty == "record":
        return {f["name"]: _host_value(f["type"], v[f["name"]])
                for f in sc["fields"]}
    if ty == "array":
        return [_host_value(sc["items"], x) for x in v]
    if ty == "map":
        return [(k, _host_value(sc["values"], x)) for k, x in v]
    if isinstance(ty, (dict, list)):
        return _host_value(ty, v)
    return v


#: a flat field's kind for native/codecs.cpp avro_decode_flat
_FLAT_KINDS = {"null": 0, "boolean": 1, "int": 2, "long": 2, "float": 3,
               "double": 4, "string": 5}


def _flat_field(sc):
    """(kind, null branch, the value schema) of a field the native
    decoder reads (a primitive, an enum, a date or timestamp, each
    possibly a ["null", T] union), or None."""
    branch = -1
    if isinstance(sc, list):
        non_null = [s for s in sc if s != "null"]
        if len(non_null) != 1 or len(sc) != 2:
            return None
        branch = sc.index("null")
        sc = non_null[0]
    if isinstance(sc, dict):
        ty, lt = sc.get("type"), sc.get("logicalType")
        if ty == "enum":
            return 6, branch, sc
        if lt is not None and _logical(sc) is not None and \
                lt in ("date", "timestamp-micros", "timestamp-millis"):
            return 2, branch, sc
        if lt is None and isinstance(ty, str) and ty in _FLAT_KINDS:
            return _FLAT_KINDS[ty], branch, ty
        return None
    if sc in _FLAT_KINDS:
        return _FLAT_KINDS[sc], branch, sc
    return None


def _header(path: str, data: bytes):
    """(schema, codec, sync marker, reader after the header)."""
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro container file")
    meta = dict(_decode({"type": "map", "values": "bytes"}, r))
    sync = r.read(16)
    return (json.loads(meta["avro.schema"]),
            meta.get("avro.codec", b"null").decode(), sync, r)


def read_avro_schema(path: str) -> dict:
    """The container's writer schema, from its header alone."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    try:
        return _header(path, head)[0]
    except EOFError:                  # a header past 64 KiB
        with open(path, "rb") as f:
            return _header(path, f.read())[0]


def _blocks(path: str):
    """(schema, [(row count, decompressed payload)]) of a container."""
    with open(path, "rb") as f:
        data = f.read()
    schema, codec, sync, r = _header(path, data)
    out = []
    while not r.at_end():
        count = r.zlong()
        payload = r.zbytes()
        if r.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise NotImplementedError(f"avro codec {codec}")
        out.append((count, payload))
    return schema, out


def _flat_column(sc, kind, vals, valid, bufs):
    """One natively decoded field as a HostColumn."""
    from ..columnar.host import HostColumn, dictionary_column
    from .. import native
    dt = schema_to_dtype(sc)
    validity = None if valid.all() else valid
    if kind == 0:
        n = len(vals)
        return HostColumn(np.zeros(n, np.int32), np.zeros(n, bool), t.NULL)
    if kind == 6:
        return dictionary_column(vals.astype(np.int32), sc["symbols"],
                                 validity)
    if kind == 5:
        fixed = [native.gather_fixed(b, v, ln) for b, v, ln in bufs]
        allv = np.concatenate(fixed) if fixed else np.array([], "S1")
        uniq, inv = np.unique(allv, return_inverse=True)
        strs = np.char.decode(uniq, "utf-8") if len(uniq) \
            else np.array([], str)
        codes = inv.reshape(-1).astype(np.int32)
        if validity is not None:
            codes = np.where(validity, codes, 0).astype(np.int32)
        return dictionary_column(codes, strs, validity)
    if kind == 3 or kind == 4:
        data = vals.view(np.float64)
        data = data.astype(np.float32) if kind == 3 else data.copy()
    elif isinstance(sc, dict) and sc.get("logicalType") == \
            "timestamp-millis":
        data = vals * 1000
    else:
        data = vals
    data = data.astype(t.physical_np_dtype(dt))
    if validity is not None:
        data = np.where(validity, data, np.zeros((), data.dtype))
    return HostColumn(data, validity, dt)


def read_avro(path: str, schema=None, opts=None) -> HostBatch:
    """A container file as a HostBatch.  Records of flat fields decode in
    C++ (native/codecs.cpp), anything else through the reference's
    Python codec."""
    avsc, blocks = _blocks(path)
    if avsc.get("type") != "record":
        raise NotImplementedError("top-level schema must be a record")
    flat = [_flat_field(f["type"]) for f in avsc["fields"]]
    if all(x is not None for x in flat):
        from .. import native
        names = [f["name"] for f in avsc["fields"]]
        parts = []
        for count, payload in blocks:
            buf = np.frombuffer(payload, np.uint8)
            vals, lens, valid, _used = native.avro_decode_flat(
                buf, count, [k for k, _b, _s in flat],
                [b for _k, b, _s in flat])
            parts.append((buf, vals, lens, valid))
        cols = []
        for i, (kind, _b, sc) in enumerate(flat):
            cat = (lambda xs: np.concatenate(xs) if xs else
                   np.zeros(0, np.int64))
            vals = cat([p[1][i] for p in parts])
            valid = np.concatenate([p[3][i] for p in parts]) if parts \
                else np.zeros(0, bool)
            bufs = [(p[0], p[1][i], p[2][i]) for p in parts]
            cols.append(_flat_column(sc, kind, vals, valid, bufs))
        return HostBatch(cols, names)
    _avsc, rows = read_avro_rows(path)
    fields = [(f["name"], f["type"], schema_to_dtype(f["type"]))
              for f in avsc["fields"]]
    st = t.StructType([t.StructField(n, dt) for n, _sc, dt in fields])
    data = {n: [_host_value(sc, row[n]) for row in rows]
            for n, sc, _dt in fields}
    return from_pydict(data, st)


# ---------------------------------------------------------------------------
# minimal writer (tests + round-trips)
# ---------------------------------------------------------------------------

_PORT_TO_AVRO = {t.BooleanType: "boolean", t.ByteType: "int",
                 t.ShortType: "int", t.IntegerType: "int",
                 t.LongType: "long", t.FloatType: "float",
                 t.DoubleType: "double", t.StringType: "string"}


def _avro_schema_of(name: str, dt: t.DataType, nullable: bool = True
                    ) -> Any:
    if type(dt) in _PORT_TO_AVRO:
        base = _PORT_TO_AVRO[type(dt)]
    elif isinstance(dt, t.DateType):
        base = {"type": "int", "logicalType": "date"}
    elif isinstance(dt, t.TimestampType):
        base = {"type": "long", "logicalType": "timestamp-micros"}
    elif isinstance(dt, t.DecimalType):
        base = {"type": "bytes", "logicalType": "decimal",
                "precision": dt.precision, "scale": dt.scale}
    elif isinstance(dt, t.ArrayType):
        base = {"type": "array",
                "items": _avro_schema_of("item", dt.element_type)}
    else:
        raise NotImplementedError(f"avro write: {dt}")
    return ["null", base] if nullable else base


def _encode(sc, v, out: bytearray) -> None:
    if isinstance(sc, list):                       # nullable union
        if v is None:
            out += _zigzag(sc.index("null"))
            return
        idx = next(i for i, s in enumerate(sc) if s != "null")
        out += _zigzag(idx)
        _encode(sc[idx], v, out)
        return
    if isinstance(sc, str):
        if sc == "null":
            return
        if sc == "boolean":
            out += b"\x01" if v else b"\x00"
        elif sc in ("int", "long"):
            out += _zigzag(int(v))
        elif sc == "float":
            out += struct.pack("<f", v)
        elif sc == "double":
            out += struct.pack("<d", v)
        elif sc in ("bytes", "string"):
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            out += _zigzag(len(b)) + b
        else:
            raise NotImplementedError(sc)
        return
    ty, lt = sc["type"], sc.get("logicalType")
    if lt == "decimal":
        unscaled = int(v.scaleb(sc.get("scale", 0)))
        nbytes = max(1, (unscaled.bit_length() + 8) // 8)
        out += _zigzag(nbytes) + unscaled.to_bytes(nbytes, "big", signed=True)
    elif lt == "date":
        import datetime as pydt
        days = (v - pydt.date(1970, 1, 1)).days if hasattr(v, "year") else int(v)
        out += _zigzag(days)
    elif lt in ("timestamp-micros", "timestamp-millis"):
        if hasattr(v, "timestamp"):
            # integer arithmetic: float epoch-seconds can't hold micros
            import datetime as pydt
            if v.tzinfo is None:
                v = v.replace(tzinfo=pydt.timezone.utc)
            epoch = pydt.datetime(1970, 1, 1, tzinfo=pydt.timezone.utc)
            unit = pydt.timedelta(
                microseconds=1 if lt == "timestamp-micros" else 1000)
            out += _zigzag((v - epoch) // unit)
        else:
            out += _zigzag(int(v))
    elif ty == "array":
        if v:
            out += _zigzag(len(v))
            for item in v:
                _encode(sc["items"], item, out)
        out += _zigzag(0)
    elif ty == "record":
        for f in sc["fields"]:
            _encode(f["type"], v[f["name"]], out)
    elif ty == "map":
        items = list(v.items()) if isinstance(v, dict) else list(v or ())
        if items:
            out += _zigzag(len(items))
            for k, mv in items:
                kb = k.encode("utf-8")
                out += _zigzag(len(kb)) + kb
                _encode(sc["values"], mv, out)
        out += _zigzag(0)
    else:
        _encode(ty, v, out)


def write_avro_records(avsc: dict, rows: Sequence[dict], path: str,
                       codec: str = "deflate") -> None:
    """Write dict rows under an explicit Avro record schema (nested
    records/arrays/maps supported) — used by Iceberg manifest writing in
    tests and by any caller that needs non-tabular Avro."""
    sync = os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(avsc).encode(),
            "avro.codec": codec.encode()}
    out.write(_zigzag(len(meta)))
    for k, v in meta.items():
        kb = k.encode()
        out.write(_zigzag(len(kb)) + kb + _zigzag(len(v)) + v)
    out.write(_zigzag(0))
    out.write(sync)
    block = bytearray()
    for row in rows:
        _encode(avsc, row, block)
    payload = bytes(block)
    if codec == "deflate":
        payload = zlib.compress(payload)[2:-4]
    elif codec != "null":
        raise NotImplementedError(f"avro codec {codec}")
    if rows:
        out.write(_zigzag(len(rows)))
        out.write(_zigzag(len(payload)) + payload)
        out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


def _zigzag_varints(v: np.ndarray):
    """(byte matrix, lengths): each value's zigzag varint in a row."""
    x = v.astype(np.int64)
    z = ((x << np.int64(1)) ^ (x >> np.int64(63))).view(np.uint64)
    nbytes = np.ones(len(z), np.int64)
    for k in range(1, 10):
        nbytes += (z >> np.uint64(7 * k)) > 0
    mat = np.empty((len(z), 10), np.uint8)
    for k in range(10):
        byte = (z >> np.uint64(7 * k)) & np.uint64(0x7F)
        more = (k < nbytes - 1).astype(np.uint64) << np.uint64(7)
        mat[:, k] = (byte | more).astype(np.uint8)
    return mat, nbytes


def _row_bytes(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The first lens[i] bytes of each row of `mat`, concatenated."""
    keep = np.arange(mat.shape[1])[None, :] < lens[:, None]
    return mat[keep]


def _column_bytes(c):
    """(the column's encoded bytes, row by row, and each row's length)
    for a flat column of `write_avro`'s nullable unions, or None."""
    dt = c.dtype
    n = len(c)
    valid = c.valid_mask()
    if isinstance(dt, t.StringType):
        enc = [s.encode("utf-8") for s in c.dictionary.tolist()]
        mat, ln = _zigzag_varints(np.array([len(b) for b in enc],
                                           np.int64))
        ent = [bytes(mat[i, :ln[i]]) + b for i, b in enumerate(enc)]
        body = np.frombuffer(b"".join(ent), np.uint8) if ent \
            else np.zeros(0, np.uint8)
        eoff = np.zeros(len(ent) + 1, np.int64)
        np.cumsum([len(e) for e in ent], out=eoff[1:])
        codes = c.data.astype(np.int64)
        size = np.where(valid, (eoff[1:] - eoff[:-1])[codes]
                        if len(ent) else 0, 0)
        out_off = np.zeros(n + 1, np.int64)
        np.cumsum(size, out=out_off[1:])
        src = np.arange(int(out_off[-1]), dtype=np.int64) - \
            np.repeat(out_off[:-1], size) + np.repeat(
                eoff[codes] if len(ent) else np.zeros(n, np.int64), size)
        vals, vlen = body[src], size
    elif isinstance(dt, (t.IntegralType, t.DateType, t.TimestampType)):
        mat, vlen = _zigzag_varints(np.where(valid, c.data, 0))
        vlen = np.where(valid, vlen, 0)
        vals = _row_bytes(mat, vlen)
    elif isinstance(dt, t.BooleanType):
        vals = c.data.astype(np.uint8)[valid]
        vlen = valid.astype(np.int64)
    elif isinstance(dt, (t.FloatType, t.DoubleType)):
        w = 4 if isinstance(dt, t.FloatType) else 8
        mat = c.data.astype("<f4" if w == 4 else "<f8").view(np.uint8) \
            .reshape(n, w)
        vlen = np.where(valid, w, 0)
        vals = _row_bytes(mat, vlen)
    else:
        return None
    # the union's branch: 0 ("null") or 2 (the value, index 1 zigzagged)
    branch = np.where(valid, 2, 0).astype(np.uint8)
    lens = vlen + 1
    total = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=total[1:])
    out = np.empty(int(total[-1]), np.uint8)
    out[total[:-1]] = branch
    dst = np.repeat(total[:-1] + 1, vlen) + np.arange(len(vals)) - \
        np.repeat(np.cumsum(vlen) - vlen, vlen)
    out[dst] = vals
    return out, lens


def write_avro(table: HostBatch, path: str, codec: str = "deflate") -> None:
    """One container file of a HostBatch (the reference's takes a
    pa.Table), every column a nullable union.  Flat columns encode
    vectorized in numpy; any other column through the reference's
    per-value encoder."""
    avsc = {"type": "record", "name": "topLevelRecord",
            "fields": [{"name": n, "type": _avro_schema_of(n, c.dtype)}
                       for n, c in zip(table.names, table.columns)]}
    parts = [_column_bytes(c) for c in table.columns]
    if any(p is None for p in parts) or not table.columns:
        rows_cols = [c.to_pylist() for c in table.columns]
        write_avro_records(avsc, [dict(zip(table.names, r))
                                  for r in zip(*rows_cols)], path, codec)
        return
    n = table.num_rows
    row_len = np.sum([ln for _b, ln in parts], axis=0) if n else \
        np.zeros(0, np.int64)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(row_len, out=row_off[1:])
    payload = np.empty(int(row_off[-1]), np.uint8)
    at = row_off[:-1].copy()
    for body, ln in parts:
        dst = np.repeat(at, ln) + np.arange(len(body)) - \
            np.repeat(np.cumsum(ln) - ln, ln)
        payload[dst] = body
        at += ln
    _write_container(avsc, payload.tobytes(), n, path, codec)


def _write_container(avsc: dict, payload: bytes, nrows: int, path: str,
                     codec: str) -> None:
    """The reference's container layout around one block's payload."""
    sync = os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(avsc).encode(),
            "avro.codec": codec.encode()}
    out.write(_zigzag(len(meta)))
    for k, v in meta.items():
        kb = k.encode()
        out.write(_zigzag(len(kb)) + kb + _zigzag(len(v)) + v)
    out.write(_zigzag(0))
    out.write(sync)
    if codec == "deflate":
        payload = zlib.compress(payload)[2:-4]      # raw, no zlib wrapper
    elif codec != "null":
        raise NotImplementedError(f"avro codec {codec}")
    if nrows:
        out.write(_zigzag(nrows))
        out.write(_zigzag(len(payload)) + payload)
        out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


# ---------------------------------------------------------------------------
# scan plumbing (over the text-scan infra, as the reference's)
# ---------------------------------------------------------------------------

from .text import _TextLogicalScan                            # noqa: E402


def _read_avro_scan(path: str, schema, opts) -> HostBatch:
    hb = read_avro(path)
    if schema is not None:
        hb = hb.select(schema.names)
    return hb


class LogicalAvroScan(_TextLogicalScan):
    """Avro container scan (GpuAvroScan.scala role)."""
    reader = staticmethod(_read_avro_scan)
    fmt = "avro"

    def _resolve_schema(self):
        if self.user_schema is not None:
            return self.user_schema
        avsc = read_avro_schema(self.paths[0])
        return t.StructType([t.StructField(f["name"],
                                           schema_to_dtype(f["type"]))
                             for f in avsc["fields"]])
