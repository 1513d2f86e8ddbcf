"""The port's Avro codec and scan (spark_rapids_tpu_torch/io/avro.py):
port copies of tests/test_avro.py, each file also read by the other
package (the port's written files by the reference's reader, the
reference's by the port's), value for value.  The port builds HostBatch
columns where the reference builds pyarrow tables; an Avro `bytes` or
`fixed` field without a decimal type has no host column in the port (no
BINARY) and raises.
"""
import datetime as pydt
import decimal as pydec
import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.io import avro as JAVRO
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.io.avro import (MAGIC, LogicalAvroScan,
                                            _zigzag, read_avro,
                                            read_avro_rows, write_avro)
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.plan.overrides import apply_overrides
from spark_rapids_tpu_torch.session import TpuSession, col

torch.set_num_threads(1)
D = pydec.Decimal
CPU = torch.device("cpu")


@pytest.fixture()
def avro_file(tmp_path):
    rng = np.random.default_rng(11)
    tbl = pa.table({
        "a": pa.array(rng.integers(0, 100, 300), pa.int64()),
        "b": pa.array(rng.standard_normal(300)),
        "s": pa.array([f"v{i % 5}" for i in range(300)]),
    })
    path = str(tmp_path / "t.avro")
    write_avro(from_arrow(tbl), path)
    return path, tbl


def _both_read(path, tbl):
    """The port's and the reference's readers give `tbl`'s values."""
    assert read_avro(path).to_pydict() == tbl.to_pydict()
    assert JAVRO.read_avro(path).to_pydict() == tbl.to_pydict()


def test_roundtrip_primitives(tmp_path):
    tbl = pa.table({
        "i": pa.array([1, None, -3], pa.int32()),
        "l": pa.array([2**40, None, -2**40], pa.int64()),
        "f": pa.array([1.5, None, -0.25], pa.float32()),
        "d": pa.array([1.5e100, None, -2.5], pa.float64()),
        "b": pa.array([True, None, False], pa.bool_()),
        "s": pa.array(["abc", None, "ünïcode"], pa.string()),
    })
    path = str(tmp_path / "prim.avro")
    write_avro(from_arrow(tbl), path)
    _both_read(path, tbl)
    # the reference's file with a bytes column: the port refuses it
    jpath = str(tmp_path / "bin.avro")
    JAVRO.write_avro(pa.table({"y": pa.array([b"\x00\xff", None, b""],
                                             pa.binary())}), jpath)
    with pytest.raises(TypeError, match="BINARY"):
        read_avro(jpath)


def test_roundtrip_logical_types(tmp_path):
    tbl = pa.table({
        "dt": pa.array([pydt.date(1994, 1, 1), None,
                        pydt.date(1969, 12, 31)], pa.date32()),
        "ts": pa.array([pydt.datetime(2001, 2, 3, 4, 5, 6, 789000,
                                      tzinfo=pydt.timezone.utc), None],
                       pa.timestamp("us", tz="UTC")).take([0, 1, 0]),
        "m": pa.array([D("12.34"), None, D("-9999999999.99")],
                      pa.decimal128(12, 2)),
    })
    path = str(tmp_path / "logical.avro")
    write_avro(from_arrow(tbl), path)
    got = read_avro(path)
    assert got.column_by_name("dt").to_pylist() == \
        tbl.column("dt").to_pylist()
    assert got.column_by_name("m").to_pylist() == tbl.column("m").to_pylist()
    assert [x.timestamp() if x else None
            for x in got.column_by_name("ts").to_pylist()] == \
        [x.timestamp() if x else None for x in tbl.column("ts").to_pylist()]
    ref = JAVRO.read_avro(path)
    assert ref.column("m").to_pylist() == tbl.column("m").to_pylist()
    # the reference's file reads the same in the port
    jpath = str(tmp_path / "jlogical.avro")
    JAVRO.write_avro(tbl, jpath)
    assert read_avro(jpath).to_pydict() == got.to_pydict()


def test_roundtrip_arrays_and_null_codec(tmp_path):
    tbl = pa.table({
        "arr": pa.array([[1, 2, 3], None, []], pa.list_(pa.int64())),
        "k": pa.array([1, 2, 3], pa.int64()),
    })
    path = str(tmp_path / "arr.avro")
    write_avro(from_arrow(tbl), path, codec="null")
    _both_read(path, tbl)


def test_decode_enum_fixed_map(tmp_path):
    """Hand-built container exercising decoder-only branches."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "e", "type": {"type": "enum", "name": "col",
                               "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "fx", "type": {"type": "fixed", "name": "f4", "size": 4}},
        {"name": "m", "type": {"type": "map", "values": "long"}},
    ]}
    body = bytearray()
    for sym, fx, items in [(1, b"abcd", [("x", 7)]),
                           (2, b"WXYZ", [("a", 1), ("b", -2)])]:
        body += _zigzag(sym)
        body += fx
        body += _zigzag(len(items))
        for k, v in items:
            kb = k.encode()
            body += _zigzag(len(kb)) + kb + _zigzag(v)
        body += _zigzag(0)
    sync = b"S" * 16
    out = bytearray(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null"}
    out += _zigzag(len(meta))
    for k, v in meta.items():
        kb = k.encode()
        out += _zigzag(len(kb)) + kb + _zigzag(len(v)) + v
    out += _zigzag(0) + sync
    out += _zigzag(2) + _zigzag(len(body)) + bytes(body) + sync
    path = str(tmp_path / "hand.avro")
    with open(path, "wb") as f:
        f.write(bytes(out))
    _, rows = read_avro_rows(path)
    assert rows == [
        {"e": "GREEN", "fx": b"abcd", "m": [("x", 7)]},
        {"e": "BLUE", "fx": b"WXYZ", "m": [("a", 1), ("b", -2)]},
    ]
    assert rows == JAVRO.read_avro_rows(path)[1]
    # fixed has no host column; the enum and the map do
    with pytest.raises(TypeError, match="BINARY"):
        read_avro(path)
    schema["fields"].pop(1)
    body2 = bytearray()
    for sym, items in [(1, [("x", 7)]), (2, [("a", 1), ("b", -2)])]:
        body2 += _zigzag(sym) + _zigzag(len(items))
        for k, v in items:
            body2 += _zigzag(len(k)) + k.encode() + _zigzag(v)
        body2 += _zigzag(0)
    out2 = bytearray(MAGIC)
    meta2 = {"avro.schema": json.dumps(schema).encode(),
             "avro.codec": b"null"}
    out2 += _zigzag(len(meta2))
    for k, v in meta2.items():
        out2 += _zigzag(len(k)) + k.encode() + _zigzag(len(v)) + v
    out2 += _zigzag(0) + sync + _zigzag(2) + _zigzag(len(body2)) + \
        bytes(body2) + sync
    with open(path, "wb") as f:
        f.write(bytes(out2))
    got = read_avro(path)
    assert got.column_by_name("e").to_pylist() == ["GREEN", "BLUE"]
    assert got.column_by_name("m").to_pylist() == [[("x", 7)],
                                                   [("a", 1), ("b", -2)]]


def test_avro_scan_device(avro_file):
    path, tbl = avro_file
    plan = L.LogicalAggregate(
        ["s"], [(Sum(E.ColumnRef("a")), "sa"), (Count(None), "c")],
        LogicalAvroScan([path]))
    q = apply_overrides(plan, device=CPU)
    assert q.kind == "device", q.explain()
    out = q.collect()
    d = tbl.to_pydict()
    exp = {}
    for a, s in zip(d["a"], d["s"]):
        exp[s] = exp.get(s, 0) + a
    got = dict(zip(out.column_by_name("s").to_pylist(),
                   out.column_by_name("sa").to_pylist()))
    assert got == exp


def test_avro_scan_cpu_fallback_conf(avro_file):
    path, tbl = avro_file
    conf = TpuConf({"spark.rapids.tpu.sql.format.avro.enabled": False})
    plan = L.LogicalFilter(E.GreaterThan(E.ColumnRef("a"), E.Literal(50)),
                           LogicalAvroScan([path]))
    q = apply_overrides(plan, conf, device=CPU)
    assert "avro scan disabled" in " ".join(q.meta.children[0].reasons)
    out = q.collect()
    assert out.num_rows == sum(1 for a in tbl.column("a").to_pylist()
                               if a > 50)


def test_session_read_avro(avro_file):
    path, tbl = avro_file
    s = TpuSession(device="cpu")
    got = s.read_avro(path).filter(
        E.EqualTo(col("s"), E.Literal("v0"))).count()
    assert got == sum(1 for i in range(300) if i % 5 == 0)


def test_deflate_block_is_actually_compressed(tmp_path):
    hb = from_arrow(pa.table({"s": pa.array(["zzzz" * 50] * 200)}))
    p1, p2 = str(tmp_path / "c.avro"), str(tmp_path / "n.avro")
    write_avro(hb, p1, codec="deflate")
    write_avro(hb, p2, codec="null")
    assert os.path.getsize(p1) < os.path.getsize(p2) / 4
    assert read_avro(p1).to_pydict() == read_avro(p2).to_pydict()
    assert JAVRO.read_avro(p1).to_pydict() == read_avro(p1).to_pydict()
