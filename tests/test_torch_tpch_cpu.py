"""The 22 TPC-H queries on the port's CPU engine
(`spark.rapids.tpu.sql.enabled=false`) against the JAX package's CPU
engine at scale 0.001: integers, strings and decimals exactly, DOUBLE
columns within a relative 1e-12 (sums in another order); and the CPU
engine in a process where neither pyarrow nor pandas can be imported,
as on the card's machine (with a compiled UDF, a TpuUDF and a row-based
PythonUDF query too)."""
import math
import os
import subprocess
import sys

import pytest

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.session import TpuSession as PSession
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
RTOL = 1e-12


@pytest.fixture(scope="module")
def jtables():
    return JTPCH.gen_tables(0.001)


@pytest.fixture(scope="module")
def ptables():
    return PTPCH.gen_tables(0.001)


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b)) or \
            abs(a - b) <= RTOL * max(abs(a), abs(b))
    return a == b


@pytest.mark.parametrize("name", sorted(PTPCH.QUERIES,
                                        key=lambda q: int(q[1:])))
def test_query_on_the_cpu_engine_equals_the_reference_cpu_engine(
        name, jtables, ptables):
    want = JTPCH.QUERIES[name](JSession(ORACLE), jtables).collect() \
        .to_pydict()
    q = PTPCH.QUERIES[name](PSession(ORACLE, device="cpu"), ptables) \
        .physical()
    assert q.kind == "host" and "HostToDeviceExec" not in \
        q.physical_tree()
    got = q.collect().to_pydict()
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        assert all(_close(a, b) for a, b in zip(got[k], want[k])), \
            (k, got[k], want[k])


NO_PYARROW = r"""
import sys
sys.modules["pyarrow"] = None             # import pyarrow now raises
sys.modules["pandas"] = None              # and so does import pandas
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch.session import TpuSession
tables = tpch.gen_tables(0.001)
s = TpuSession({"spark.rapids.tpu.sql.enabled": "false"}, device="cpu")
for name in sorted(tpch.QUERIES):
    q = tpch.QUERIES[name](s, tables).physical()
    assert q.kind == "host", name
    q.collect()
# a shattered STRUCT query, a MAP query and an RLIKE query, built with
# the numpy constructors, on the device path (CPU tensors)
import numpy as np
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.plan import collections as C
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan import strings as S
from spark_rapids_tpu_torch.plan.aggregates import Sum
d = TpuSession(device="cpu")
k = H.HostColumn(np.arange(6, dtype=np.int64), None, T.LONG)
st = H.struct_column([k, H.string_column(["a", "b", "c", "a", "b", "c"])],
                     ["x", "y"], np.array([1, 1, 0, 1, 1, 1], bool))
mp = H.map_column(k, H.HostColumn(np.arange(6, dtype=np.int64) * 10, None,
                                  T.LONG), [0, 2, 2, 3, 6, 6, 6])
hb = H.HostBatch([st, mp, k], ["s", "m", "k"])
got = d.from_host(hb).filter(E.IsNotNull(E.ColumnRef("s"))).group_by(
    C.GetStructField(E.ColumnRef("s"), "y")).agg(
    (Sum(C.GetStructField(E.ColumnRef("s"), "x")), "t")).sort("col0") \
    .to_pydict()
assert got == {"col0": ["a", "b", "c"], "t": [3, 5, 5]}, got
got = d.from_host(hb).select(C.MapElementAt(E.ColumnRef("m"), 4),
                             E.ColumnRef("m"), names=["v", "m"]).to_pydict()
assert got["v"] == [None, None, None, 40, None, None], got
assert got["m"][0] == [(0, 0), (1, 10)] and got["m"][3] == [(3, 30), (4, 40),
                                                            (5, 50)]
got = d.from_host(tables["part"]).filter(S.RLike(E.ColumnRef("p_name"),
                                                 "green")).count()
assert got == sum("green" in v for v in tables["part"].column_by_name(
    "p_name").to_pylist()), got
# a compiled UDF, a TpuUDF and a row-based PythonUDF on the CPU engine
from spark_rapids_tpu_torch.plan.udf import PythonUDF, TpuUDF
from spark_rapids_tpu_torch.plan.udf_compiler import udf
li = s.from_host(tables["lineitem"])
ref = li.agg((Sum(E.Multiply(E.ColumnRef("l_extendedprice"), E.Subtract(
    E.Literal(1), E.ColumnRef("l_discount")))), "r")).to_pydict()
comp = udf(lambda p, d: p * (1 - d), T.DOUBLE,
           E.ColumnRef("l_extendedprice"), E.ColumnRef("l_discount"))
assert not isinstance(comp, PythonUDF)
assert li.agg((Sum(comp), "r")).to_pydict() == ref
tq = TpuUDF(lambda q: q * 2, T.LONG, E.ColumnRef("l_orderkey"))
got = li.agg((Sum(tq), "t")).to_pydict()["t"][0]
assert got == 2 * int(tables["lineitem"].column_by_name("l_orderkey")
                      .data.sum()), got
def looped(n):
    acc = 0
    for ch in n:
        acc += ord(ch) % 3
    return acc
py = udf(looped, T.LONG, E.ColumnRef("p_name"))
assert isinstance(py, PythonUDF)
got = s.from_host(tables["part"]).agg((Sum(py), "t")).to_pydict()["t"][0]
assert got == sum(looped(v) for v in tables["part"].column_by_name(
    "p_name").to_pylist()), got
# every file format of the port's I/O, written and read back, and q1,
# q3 and q6 from the port's own Parquet files
import os, tempfile
from spark_rapids_tpu_torch.io import avro as AV, iceberg as IC
from spark_rapids_tpu_torch.io import parquet as PQ, text as TX
tmp = tempfile.mkdtemp()
orders = tables["orders"]
for codec in ("zstd", "snappy", "gzip", "uncompressed"):
    f = os.path.join(tmp, f"o_{codec}.parquet")
    PQ.write_table(orders, f, codec, row_group_rows=5000)
    assert d.read_parquet(f).collect().to_pydict() == orders.to_pydict()
supp = tables["supplier"].select(["s_suppkey", "s_name", "s_acctbal"])
TX.write_csv(supp, os.path.join(tmp, "s.csv"))
assert d.read_csv(os.path.join(tmp, "s.csv")).collect().to_pydict() == \
    s.from_host(supp).select(E.ColumnRef("s_suppkey"), E.ColumnRef(
        "s_name"), E.Cast(E.ColumnRef("s_acctbal"), T.DOUBLE),
        names=supp.names).collect().to_pydict()
TX.write_json(supp, os.path.join(tmp, "s.jsonl"))
assert d.read_json(os.path.join(tmp, "s.jsonl")).count() == supp.num_rows
TX.write_hive_text(supp, os.path.join(tmp, "s.hive"))
got = d.read_hive_text(os.path.join(tmp, "s.hive"), schema=supp.schema)
assert got.collect().to_pydict() == supp.to_pydict()
AV.write_avro(supp, os.path.join(tmp, "s.avro"))
assert d.read_avro(os.path.join(tmp, "s.avro")).collect().to_pydict() \
    == supp.to_pydict()
data = os.path.join(tmp, "ice", "data", "d.parquet")
meta = os.path.join(tmp, "ice", "metadata")
os.makedirs(os.path.dirname(data))
os.makedirs(meta)
PQ.write_table(supp, data)
df_schema = {"type": "record", "name": "r2", "fields": [
    {"name": "content", "type": "int"},
    {"name": "file_path", "type": "string"}]}
AV.write_avro_records({"type": "record", "name": "e", "fields": [
    {"name": "status", "type": "int"},
    {"name": "data_file", "type": df_schema}]},
    [{"status": 1, "data_file": {"content": 0, "file_path": data}}],
    os.path.join(meta, "m.avro"))
AV.write_avro_records({"type": "record", "name": "l", "fields": [
    {"name": "manifest_path", "type": "string"}]},
    [{"manifest_path": os.path.join(meta, "m.avro")}],
    os.path.join(meta, "snap.avro"))
import json
with open(os.path.join(meta, "v1.metadata.json"), "w") as fh:
    json.dump({"format-version": 2, "current-snapshot-id": 1,
               "snapshots": [{"snapshot-id": 1, "manifest-list":
                              os.path.join(meta, "snap.avro")}]}, fh)
assert d.read_iceberg(os.path.join(tmp, "ice")).collect().to_pydict() == \
    supp.to_pydict()
files = {}
for name in ("lineitem", "orders", "customer"):
    files[name] = os.path.join(tmp, f"{name}.parquet")
    PQ.write_table(tables[name], files[name], row_group_rows=2000)
class FileSession:
    def __init__(self, real):
        self.real = real
        self.by = {id(tables[k]): v for k, v in files.items()}
    def from_host(self, table):
        return self.real.read_parquet(self.by[id(table)])
    def __getattr__(self, name):
        return getattr(self.real, name)
for name in ("q1", "q3", "q6"):
    want = getattr(tpch, name)(d, tables).to_pydict()
    assert getattr(tpch, name)(FileSession(d), tables).to_pydict() == want
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert "pyarrow" not in loaded and "pandas" not in loaded
print("ran", len(tpch.QUERIES))
"""


def test_the_cpu_engine_runs_without_pyarrow():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", NO_PYARROW], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == f"ran {len(PTPCH.QUERIES)}"
