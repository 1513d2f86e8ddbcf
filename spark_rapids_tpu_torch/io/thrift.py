"""The Thrift compact protocol and the Parquet footer structures.

The JAX package reads and writes Parquet through pyarrow, which does this
work in C++.  The port decodes the footer and the page headers itself:

  * `read_struct(buf, pos, name)` decodes one struct of `STRUCTS` into a
    `TStruct` (fields by name; an absent field reads None), skipping any
    field id it does not know by its wire type, so a newer writer's
    footer reads;
  * `write_struct(name, value)` encodes a `TStruct` or a dict by the same
    table.

Field ids and types follow parquet-format's parquet.thrift.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

# compact protocol wire types
STOP, TRUE, FALSE, BYTE, I16, I32, I64, DOUBLE, BINARY, LIST, SET, MAP, \
    STRUCT = range(13)


class TStruct(dict):
    """A decoded struct: attribute access by field name, None if absent."""

    def __getattr__(self, name):
        return self.get(name)

    def __setattr__(self, name, value):
        self[name] = value


#: struct name -> {field id: (field name, type)}.  A type is a scalar
#: name ("bool", "i8", "i16", "i32", "i64", "double", "binary",
#: "string"), ("list", element type) or a struct name.
STRUCTS: Dict[str, Dict[int, Tuple[str, object]]] = {
    "Empty": {},
    "KeyValue": {1: ("key", "string"), 2: ("value", "string")},
    "DecimalType": {1: ("scale", "i32"), 2: ("precision", "i32")},
    "TimeUnit": {1: ("MILLIS", "Empty"), 2: ("MICROS", "Empty"),
                 3: ("NANOS", "Empty")},
    "TimestampType": {1: ("isAdjustedToUTC", "bool"),
                      2: ("unit", "TimeUnit")},
    "TimeType": {1: ("isAdjustedToUTC", "bool"), 2: ("unit", "TimeUnit")},
    "IntType": {1: ("bitWidth", "i8"), 2: ("isSigned", "bool")},
    "LogicalType": {1: ("STRING", "Empty"), 2: ("MAP", "Empty"),
                    3: ("LIST", "Empty"), 4: ("ENUM", "Empty"),
                    5: ("DECIMAL", "DecimalType"), 6: ("DATE", "Empty"),
                    7: ("TIME", "TimeType"),
                    8: ("TIMESTAMP", "TimestampType"),
                    10: ("INTEGER", "IntType"), 11: ("UNKNOWN", "Empty"),
                    12: ("JSON", "Empty"), 13: ("BSON", "Empty"),
                    14: ("UUID", "Empty"), 15: ("FLOAT16", "Empty")},
    "SchemaElement": {1: ("type", "i32"), 2: ("type_length", "i32"),
                      3: ("repetition_type", "i32"), 4: ("name", "string"),
                      5: ("num_children", "i32"),
                      6: ("converted_type", "i32"), 7: ("scale", "i32"),
                      8: ("precision", "i32"), 9: ("field_id", "i32"),
                      10: ("logicalType", "LogicalType")},
    "Statistics": {1: ("max", "binary"), 2: ("min", "binary"),
                   3: ("null_count", "i64"), 4: ("distinct_count", "i64"),
                   5: ("max_value", "binary"), 6: ("min_value", "binary"),
                   7: ("is_max_value_exact", "bool"),
                   8: ("is_min_value_exact", "bool")},
    "PageEncodingStats": {1: ("page_type", "i32"), 2: ("encoding", "i32"),
                          3: ("count", "i32")},
    "ColumnMetaData": {1: ("type", "i32"), 2: ("encodings", ("list", "i32")),
                       3: ("path_in_schema", ("list", "string")),
                       4: ("codec", "i32"), 5: ("num_values", "i64"),
                       6: ("total_uncompressed_size", "i64"),
                       7: ("total_compressed_size", "i64"),
                       8: ("key_value_metadata", ("list", "KeyValue")),
                       9: ("data_page_offset", "i64"),
                       10: ("index_page_offset", "i64"),
                       11: ("dictionary_page_offset", "i64"),
                       12: ("statistics", "Statistics"),
                       13: ("encoding_stats",
                            ("list", "PageEncodingStats"))},
    "ColumnChunk": {1: ("file_path", "string"), 2: ("file_offset", "i64"),
                    3: ("meta_data", "ColumnMetaData")},
    "RowGroup": {1: ("columns", ("list", "ColumnChunk")),
                 2: ("total_byte_size", "i64"), 3: ("num_rows", "i64"),
                 5: ("file_offset", "i64"),
                 6: ("total_compressed_size", "i64"), 7: ("ordinal", "i16")},
    "ColumnOrder": {1: ("TYPE_ORDER", "Empty")},
    "FileMetaData": {1: ("version", "i32"),
                     2: ("schema", ("list", "SchemaElement")),
                     3: ("num_rows", "i64"),
                     4: ("row_groups", ("list", "RowGroup")),
                     5: ("key_value_metadata", ("list", "KeyValue")),
                     6: ("created_by", "string"),
                     7: ("column_orders", ("list", "ColumnOrder"))},
    "DataPageHeader": {1: ("num_values", "i32"), 2: ("encoding", "i32"),
                       3: ("definition_level_encoding", "i32"),
                       4: ("repetition_level_encoding", "i32"),
                       5: ("statistics", "Statistics")},
    "DictionaryPageHeader": {1: ("num_values", "i32"),
                             2: ("encoding", "i32"),
                             3: ("is_sorted", "bool")},
    "DataPageHeaderV2": {1: ("num_values", "i32"), 2: ("num_nulls", "i32"),
                         3: ("num_rows", "i32"), 4: ("encoding", "i32"),
                         5: ("definition_levels_byte_length", "i32"),
                         6: ("repetition_levels_byte_length", "i32"),
                         7: ("is_compressed", "bool"),
                         8: ("statistics", "Statistics")},
    "PageHeader": {1: ("type", "i32"), 2: ("uncompressed_page_size", "i32"),
                   3: ("compressed_page_size", "i32"), 4: ("crc", "i32"),
                   5: ("data_page_header", "DataPageHeader"),
                   7: ("dictionary_page_header", "DictionaryPageHeader"),
                   8: ("data_page_header_v2", "DataPageHeaderV2")},
}

_WIRE = {"bool": TRUE, "i8": BYTE, "i16": I16, "i32": I32, "i64": I64,
         "double": DOUBLE, "binary": BINARY, "string": BINARY}


def _wire(ty) -> int:
    if isinstance(ty, tuple):
        return LIST
    return _WIRE.get(ty, STRUCT)


class ThriftError(ValueError):
    """A footer or page header that does not decode."""


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _varint(buf, pos: int):
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf, pos: int, wire: int, ty):
    if wire in (TRUE, FALSE):
        return wire == TRUE, pos
    if wire == BYTE:
        v = buf[pos]
        return (v - 256 if v > 127 else v), pos + 1
    if wire in (I16, I32, I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if wire == DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if wire == BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ThriftError("truncated binary")
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8", "replace") if ty == "string" else raw), \
            pos + n
    if wire in (LIST, SET):
        head = buf[pos]
        pos += 1
        size, etype = head >> 4, head & 15
        if size == 15:
            size, pos = _varint(buf, pos)
        elem = ty[1] if isinstance(ty, tuple) else None
        out = []
        for _ in range(size):
            if etype in (TRUE, FALSE):
                out.append(buf[pos] == TRUE)
                pos += 1
                continue
            v, pos = _read_value(buf, pos, etype, elem)
            out.append(v)
        return out, pos
    if wire == MAP:
        size, pos = _varint(buf, pos)
        out = {}
        if size:
            kv = buf[pos]
            pos += 1
            for _ in range(size):
                k, pos = _read_value(buf, pos, kv >> 4, None)
                v, pos = _read_value(buf, pos, kv & 15, None)
                out[k] = v
        return out, pos
    if wire == STRUCT:
        return read_struct(buf, pos, ty if isinstance(ty, str)
                           and ty in STRUCTS else None)
    raise ThriftError(f"unknown compact wire type {wire}")


def read_struct(buf, pos: int, name) -> Tuple[TStruct, int]:
    """One struct at `pos` -> (TStruct, position after it).  `name` is a
    key of STRUCTS (None: a struct no field is read from)."""
    fields = STRUCTS.get(name, {}) if name else {}
    out = TStruct()
    last = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated struct")
        head = buf[pos]
        pos += 1
        wire = head & 15
        if wire == STOP:
            return out, pos
        delta = head >> 4
        if delta:
            fid = last + delta
        else:
            v, pos = _varint(buf, pos)
            fid = _zigzag(v)
        last = fid
        spec = fields.get(fid)
        value, pos = _read_value(buf, pos, wire, spec[1] if spec else None)
        if spec is not None:
            out[spec[0]] = value


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _put_varint(out: bytearray, n: int) -> None:
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _put_zigzag(out: bytearray, n: int) -> None:
    _put_varint(out, (n << 1) ^ (n >> 63))


def _write_value(out: bytearray, ty, v) -> None:
    if isinstance(ty, tuple):
        elem = ty[1]
        ew = _wire(elem)
        if len(v) < 15:
            out.append((len(v) << 4) | ew)
        else:
            out.append(0xF0 | ew)
            _put_varint(out, len(v))
        for x in v:
            _write_value(out, elem, x)
        return
    if ty == "bool":
        out.append(TRUE if v else FALSE)
    elif ty == "i8":
        out.append(v & 0xFF)
    elif ty in ("i16", "i32", "i64"):
        _put_zigzag(out, int(v))
    elif ty == "double":
        out += struct.pack("<d", v)
    elif ty in ("binary", "string"):
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _put_varint(out, len(raw))
        out += raw
    else:
        _write_struct(out, ty, v)


def _write_struct(out: bytearray, name: str, value) -> None:
    last = 0
    for fid, (fname, ty) in sorted(STRUCTS[name].items()):
        v = value.get(fname)
        if v is None:
            continue
        wire = _wire(ty)
        if ty == "bool":
            wire = TRUE if v else FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire)
        else:
            out.append(wire)
            _put_zigzag(out, fid)
        last = fid
        if ty != "bool":
            _write_value(out, ty, v)
    out.append(STOP)


def write_struct(name: str, value) -> bytes:
    """The compact encoding of `value` (a TStruct or dict by field name)
    as struct `name` of STRUCTS."""
    out = bytearray()
    _write_struct(out, name, value)
    return bytes(out)
