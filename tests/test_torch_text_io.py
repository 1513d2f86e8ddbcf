"""The port's CSV, JSON lines and Hive text scans (spark_rapids_tpu_torch/
io/text.py), parsed by the port itself, against the JAX package's, which
parses through pyarrow.csv and pyarrow.json: port copies of the CSV and
JSON tests of tests/test_io.py and the Hive tests of
tests/test_io_extra.py, and pyarrow's inference at its edges (a column of
nulls, ints and floats mixed, dates, timestamps with and without a
fraction or a zone, the null markers, hex ints, blanks).  Every value is
exact; a DOUBLE parsed from text is held bit for bit.
"""
import datetime as pydt
import struct

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.io import text as JTEXT
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.io import text as T
from spark_rapids_tpu_torch.io.text import _read_hive_text, write_hive_text
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.session import TpuSession, col, lit

torch.set_num_threads(1)


def _session(conf=None):
    return TpuSession(conf, device="cpu")


def _bits(v):
    return struct.pack("<d", v) if isinstance(v, float) else v


def _same(hb, tbl):
    want = from_arrow(tbl)
    assert hb.names == want.names
    for name in want.names:
        a, b = hb.column_by_name(name), want.column_by_name(name)
        assert a.dtype == b.dtype, name
        assert [_bits(x) for x in a.to_pylist()] == \
            [_bits(x) for x in b.to_pylist()], name


def test_csv_scan(tmp_path):
    p = str(tmp_path / "x.csv")
    with open(p, "w") as f:
        f.write("a,b\n1,x\n2,y\n3,z\n")
    s = _session()
    out = s.read_csv(p).collect()
    assert out.column_by_name("a").to_pylist() == [1, 2, 3]
    assert out.column_by_name("b").to_pylist() == ["x", "y", "z"]
    # filter on device over csv source
    out2 = s.read_csv(p).filter(E.GreaterThan(col("a"), lit(1))).collect()
    assert out2.column_by_name("b").to_pylist() == ["y", "z"]


def test_json_scan(tmp_path):
    p = str(tmp_path / "x.jsonl")
    with open(p, "w") as f:
        f.write('{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}\n')
    s = _session()
    out = s.read_json(p).collect()
    assert out.column_by_name("a").to_pylist() == [1, 2]


CSV_CASES = {
    "all_null": ["", "NA", "null", "NaN"],
    "ints": ["1", " 2 ", "007", "0x10", "-5"],
    "int_then_float": ["1", "2", "3.5"],
    "plus_sign": ["+5", "6"],
    "bools": ["true", "False", "1", "0", "TRUE"],
    "bool_blank": [" true", "false"],
    "dates": ["2020-01-01", " 1969-12-31", ""],
    "bad_date": ["2020-13-01", "2020-01-01"],
    "ts_s": ["2020-01-01 10:00:00", "1999-12-31T23:59"],
    "ts_ns": ["2020-01-01 10:00:00.123", "2020-01-01 10:00:00"],
    "ts_zone": ["2020-01-01 10:00:00+01:00", "2020-01-01T00:00:00Z"],
    "ts_mixed": ["2020-01-01T10:00:00.5", "2020-01-01T10:00:00Z"],
    "floats": ["1.", ".5", "1e5", "+1.5E-3", "inf", "-Infinity", "nan",
               "0.1", "1E400", "-0"],
    "big_int": ["9223372036854775808", "1"],
    "strings": ["x", "NA", "", "  ", "N/A", "null"],
    "underscore": ["1_000", "2"],
    "quoted": ['"x,y"', '"he said ""hi"""', '""', '"1"'],
}


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_csv_inference_equals_pyarrow_s(tmp_path, case):
    vals = CSV_CASES[case]
    p = str(tmp_path / "c.csv")
    with open(p, "w") as f:
        f.write("v,k\n" + "".join(f"{v},{i}\n" for i, v in enumerate(vals)))
    _same(T._read_csv(p, None, {}), JTEXT._read_csv(p, None, {}))


def test_csv_options_and_explicit_schema(tmp_path):
    p = str(tmp_path / "o.csv")
    with open(p, "w") as f:
        f.write("1;2.5;2020-01-02\n3;;2021-03-04\n")
    opts = {"sep": ";", "header": False}
    _same(T._read_csv(p, None, opts), JTEXT._read_csv(p, None, opts))
    opts = {"sep": ";", "column_names": ["a", "b", "c"]}
    _same(T._read_csv(p, None, opts), JTEXT._read_csv(p, None, opts))
    schema = pa.schema([("a", pa.int32()), ("b", pa.float64()),
                        ("c", pa.string())])
    _same(T._read_csv(p, schema, opts), JTEXT._read_csv(p, schema, opts))
    got = _session().read_csv(p, schema=schema, **opts).collect()
    assert got.schema.names == ["a", "b", "c"]
    assert got.column_by_name("a").dtype == t.INT
    # a value that does not convert to the schema's type raises, as
    # pyarrow's conversion does
    bad = pa.schema([("a", pa.int32()), ("b", pa.int64()),
                     ("c", pa.string())])
    with pytest.raises(ValueError):
        T._read_csv(p, bad, opts)
    with pytest.raises(pa.ArrowInvalid):
        JTEXT._read_csv(p, bad, opts)


def test_doubles_parse_bit_for_bit(tmp_path):
    rng = np.random.default_rng(9)
    vals = np.concatenate([rng.standard_normal(500) * 10.0 **
                           rng.integers(-300, 300, 500),
                           [5e-324, 1.7976931348623157e308, 0.1, 1 / 3]])
    p = str(tmp_path / "d.csv")
    with open(p, "w") as f:
        f.write("x\n" + "".join(f"{v!r}\n" for v in vals))
    _same(T._read_csv(p, None, {}), JTEXT._read_csv(p, None, {}))


def test_csv_inference_spans_the_whole_file(tmp_path):
    # pyarrow's reader loosens a type past its first block
    p = str(tmp_path / "big.csv")
    with open(p, "w") as f:
        f.write("a\n" + "".join(f"{i}\n" for i in range(150_000)) + "1.5\n")
    got = T._read_csv(p, None, {})
    assert got.column_by_name("a").dtype == t.DOUBLE
    ref = JTEXT._read_csv(p, None, {})
    assert str(ref.schema.field("a").type) == "double"
    assert got.column_by_name("a").to_pylist()[-2:] == \
        ref.column("a").to_pylist()[-2:]


JSON_CASES = {
    "int_float": ['{"a":1}', '{"a":1.5}'],
    "dates": ['{"a":"2020-01-01"}', '{"a":"2021-02-03 10:00:00"}'],
    "missing": ['{"a":null}', '{"b":true}'],
    "struct": ['{"a":{"x":1,"y":"s"}}', '{"a":{"y":"t","z":2}}',
               '{"a":null}'],
    "list": ['{"a":[1,2]}', '{"a":[]}', '{"a":null}'],
    "list_mixed": ['{"a":[1,2.5]}'],
    "order": ['{"b":1,"a":2}', '{"a":3,"c":[{"k":1}]}'],
    "big_int": ['{"a":9223372036854775808}'],
    "unicode": ['{"a":"\\u00e9"}', '{"a":"x"}'],
}


@pytest.mark.parametrize("case", list(JSON_CASES))
def test_json_inference_equals_pyarrow_s(tmp_path, case):
    p = str(tmp_path / "j.jsonl")
    with open(p, "w") as f:
        f.write("\n".join(JSON_CASES[case]) + "\n")
    got = T._read_json(p, None, {})
    ref = JTEXT._read_json(p, None, {})
    assert got.schema == from_arrow(ref).schema
    assert got.to_pydict() == from_arrow(ref).to_pydict()


def test_json_mixed_kinds_raise(tmp_path):
    p = str(tmp_path / "bad.jsonl")
    with open(p, "w") as f:
        f.write('{"a":1}\n{"a":"x"}\n')
    with pytest.raises(ValueError):
        T._read_json(p, None, {})


def test_hive_text_roundtrip_and_scan(tmp_path):
    tbl = pa.table({
        "a": pa.array([1, None, 3], pa.int64()),
        "s": pa.array(["x,y", None, "z\x02w"]),
        "f": pa.array([1.5, 2.5, None]),
    })
    path = str(tmp_path / "t.hive")
    write_hive_text(from_arrow(tbl), path)
    raw = open(path, encoding="utf-8").read()
    assert "\\N" in raw and "\x01" in raw
    # byte for byte the reference writer's file
    jpath = str(tmp_path / "j.hive")
    JTEXT.write_hive_text(tbl, jpath)
    assert open(jpath, encoding="utf-8").read() == raw
    s = _session()
    schema = pa.schema([("a", pa.int64()), ("s", pa.string()),
                        ("f", pa.float64())])
    got = s.read_hive_text(path, schema=schema).collect()
    assert got.to_pydict() == tbl.to_pydict()
    # device placement + conf gate
    df = s.read_hive_text(path, schema=schema).filter(
        E.IsNotNull(E.ColumnRef("a")))
    assert df.physical().kind == "device"
    off = _session({"spark.rapids.tpu.sql.format.hivetext.enabled":
                    "false"})
    assert "hivetext scan disabled" in \
        off.read_hive_text(path, schema=schema).physical().explain()


def test_hive_null_marker_matches_hive_semantics(tmp_path):
    """Genuine Hive files: \\N (2 bytes) is null, \\\\N is the literal
    string \\N — matched BEFORE unescaping, as LazySimpleSerDe does."""
    p = str(tmp_path / "hive_made.txt")
    with open(p, "w") as f:
        f.write("\\N\x011\n")         # null, 1
        f.write("\\\\N\x012\n")       # literal \N, 2
        f.write("plain\x01\\N\n")     # plain, null int
    schema = pa.schema([("s", pa.string()), ("k", pa.int64())])
    got = _read_hive_text(p, schema, {})
    assert got.column_by_name("s").to_pylist() == [None, "\\N", "plain"]
    assert got.column_by_name("k").to_pylist() == [1, 2, None]
    # engine writer round-trips the literal \N value like Hive
    tbl = pa.table({"s": pa.array(["\\N", None, "x"]),
                    "k": pa.array([1, 2, 3], pa.int64())})
    p2 = str(tmp_path / "rt.txt")
    write_hive_text(from_arrow(tbl), p2)
    assert _read_hive_text(p2, schema, {}).to_pydict() == tbl.to_pydict()


def test_hive_literal_null_strings_and_empty_preserved(tmp_path):
    """'' and 'NULL' are real string values in Hive (only \\N is null);
    empty numeric fields are null; malformed numerics are null not
    errors — on BOTH parser paths."""
    schema = pa.schema([("s", pa.string()), ("k", pa.int64())])
    # fast path (no backslashes anywhere)
    p1 = str(tmp_path / "fast.txt")
    with open(p1, "w") as f:
        f.write("\x011\n")            # empty string, 1
        f.write("NULL\x012\n")        # literal 'NULL', 2
        f.write("x\x01\n")            # x, empty int -> null
    got = _read_hive_text(p1, schema, {})
    assert got.column_by_name("s").to_pylist() == ["", "NULL", "x"]
    assert got.column_by_name("k").to_pylist() == [1, 2, None]
    # escaped path (backslash present): same semantics + malformed int
    p2 = str(tmp_path / "esc.txt")
    with open(p2, "w") as f:
        f.write("a\\\x01b\x011\n")    # escaped delimiter, 1
        f.write("NULL\x01\n")         # literal 'NULL', empty int
        f.write("y\x01oops\n")        # y, malformed int -> null
    got2 = _read_hive_text(p2, schema, {})
    assert got2.column_by_name("s").to_pylist() == ["a\x01b", "NULL", "y"]
    assert got2.column_by_name("k").to_pylist() == [1, None, None]
    # round trip with empty strings via our writer stays lossless
    tbl = pa.table({"s": pa.array(["", "NULL", None]),
                    "k": pa.array([7, 8, 9], pa.int64())})
    p3 = str(tmp_path / "rt.txt")
    write_hive_text(from_arrow(tbl), p3)
    assert _read_hive_text(p3, schema, {}).to_pydict() == tbl.to_pydict()


def test_hive_fast_path_malformed_numeric_nulls(tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("a\x011\n")
        f.write("b\x01oops\n")      # malformed int, no backslash in file
        f.write("NULL\x013\n")      # literal 'NULL' string value
    schema = pa.schema([("s", pa.string()), ("k", pa.int64())])
    got = _read_hive_text(p, schema, {})
    assert got.column_by_name("s").to_pylist() == ["a", "b", "NULL"]
    assert got.column_by_name("k").to_pylist() == [1, None, 3]
    assert got.to_pydict() == JTEXT._read_hive_text(p, schema, {}) \
        .to_pydict()


def test_csv_and_json_writers_read_back(tmp_path):
    tbl = pa.table({"i": pa.array([1, None, 3], pa.int64()),
                    "f": pa.array([0.1, 2.5, None]),
                    "s": pa.array(["a,b", "q\"", "x"]),
                    "d": pa.array([pydt.date(2020, 1, 2), None,
                                   pydt.date(1999, 1, 1)])})
    hb = from_arrow(tbl)
    p, j = str(tmp_path / "w.csv"), str(tmp_path / "w.jsonl")
    T.write_csv(hb, p)
    _same(T._read_csv(p, None, {}), JTEXT._read_csv(p, None, {}))
    assert T._read_csv(p, None, {}).to_pydict() == tbl.to_pydict()
    T.write_json(hb, j)
    got = T._read_json(j, None, {})
    assert got.column_by_name("i").to_pylist() == [1, None, 3]
    assert got.column_by_name("s").to_pylist() == ["a,b", "q\"", "x"]
