"""Hive UDFs in the port (spark_rapids_tpu_torch/plan/hive_udf.py): port
copies of tests/test_hive_udf.py, each held against the JAX package on
the same table: row-based host evaluation inside the columnar pipeline
(the reference's rowBasedHiveUDFs.scala), device placement of a
TpuHiveUDF's columnar form (hiveUDFs.scala's RapidsUDF role, over torch
tensors here), and the cogrouped pandas exec with its worker error.
The hive UDF object is pinned, as a TpuUDF's function is."""
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan.hive_udf import HiveGenericUDF as JHiveGenericUDF
from spark_rapids_tpu.plan.hive_udf import HiveSimpleUDF as JHiveSimpleUDF
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.plan.hive_udf import (HiveGenericUDF,
                                                  HiveSimpleUDF, TpuHiveUDF)
from spark_rapids_tpu_torch.plan.udf import _UDF_PIN
from spark_rapids_tpu_torch.session import DataFrame, TpuSession, col

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

CPU = {"spark.rapids.tpu.sql.enabled": "false"}


class _PlusTax:
    """Plain hive UDF: row-based, no columnar form."""

    def evaluate(self, price, rate):
        if price is None or rate is None:
            return None
        return price + price * rate


class _Scale(TpuHiveUDF):
    """RapidsUDF analogue: columnar device form + row form."""

    def evaluate(self, x):
        return None if x is None else x * 3

    def evaluate_columnar(self, x):
        return x * 3


def _port(build, tbl):
    """(the port's device-engine answer, its CPU engine's, the plan)."""
    df = build(TpuSession(device="cpu").from_arrow(tbl), col)
    cpu = DataFrame(df._plan, TpuSession(CPU, device="cpu")).collect()
    return df.collect().to_pydict(), cpu.to_pydict(), df


def _ref(build, tbl):
    df = build(JSession().from_arrow(tbl), jcol)
    return df.collect().to_pydict(), \
        JDF(df._plan, JSession(CPU)).collect().to_pydict()


def test_row_based_hive_udf_host_path():
    tbl = pa.table({"p": pa.array([10.0, None, 2.0]),
                    "r": pa.array([0.1, 0.2, None])})
    out, cpu, df = _port(lambda d, c: d.select(
        HiveSimpleUDF(_PlusTax(), t.DOUBLE, c("p"), c("r")), names=["t"]),
        tbl)
    tree = df.physical().physical_tree()
    assert "Cpu" in tree            # row-based -> host placement
    assert out == cpu
    assert out["t"] == [11.0, None, None]
    ref, oracle = _ref(lambda d, c: d.select(
        JHiveSimpleUDF(_PlusTax(), JT.DOUBLE, c("p"), c("r")), names=["t"]),
        tbl)
    assert out == ref == oracle
    assert df.physical().explain().replace("_PlusTax", "") == \
        JDF(_jplan(tbl), JSession()).physical().explain() \
        .replace("_PlusTax", "")


def _jplan(tbl):
    return JSession().from_arrow(tbl).select(
        JHiveSimpleUDF(_PlusTax(), JT.DOUBLE, jcol("p"), jcol("r")),
        names=["t"])._plan


def test_tpu_hive_udf_device_path():
    tbl = pa.table({"x": pa.array([1, None, 4], pa.int64())})
    out, cpu, df = _port(lambda d, c: d.select(
        HiveSimpleUDF(_Scale(), t.LONG, c("x")), names=["y"]), tbl)
    tree = df.physical().physical_tree()
    assert tree.startswith("ProjectExec")   # device placement
    assert out == cpu
    assert out["y"] == [3, None, 12]
    ref, oracle = _ref(lambda d, c: d.select(
        JHiveSimpleUDF(_Scale(), JT.LONG, c("x")), names=["y"]), tbl)
    assert out == ref == oracle


def test_hive_generic_udf_deferred():
    class Concatish:
        def evaluate(self, deferred):
            a, b = (d.get() for d in deferred)
            if a is None or b is None:
                return None
            return int(a) * 100 + int(b)

    tbl = pa.table({"a": pa.array([1, 2, None], pa.int64()),
                    "b": pa.array([7, None, 9], pa.int64())})
    out, cpu, _df = _port(lambda d, c: d.select(
        HiveGenericUDF(Concatish(), t.LONG, c("a"), c("b")), names=["c"]),
        tbl)
    assert out == cpu
    assert out["c"] == [107, None, None]
    ref, oracle = _ref(lambda d, c: d.select(
        JHiveGenericUDF(Concatish(), JT.LONG, c("a"), c("b")), names=["c"]),
        tbl)
    assert out == ref == oracle


def test_cogroup_apply_in_pandas():
    import pandas as pd
    left = pa.table({"k": pa.array([1, 1, 2, 3], pa.int64()),
                     "v": pa.array([10, 11, 20, 30], pa.int64())})
    right = pa.table({"k2": pa.array([1, 2, 2, 4], pa.int64()),
                      "w": pa.array([5, 6, 7, 8], pa.int64())})

    def merge(ldf, rdf):
        k = ldf["k"].iloc[0] if len(ldf) else rdf["k2"].iloc[0]
        return pd.DataFrame({"k": [int(k)],
                             "lsum": [int(ldf["v"].sum())],
                             "rsum": [int(rdf["w"].sum())]})

    schema = pa.schema([("k", pa.int64()), ("lsum", pa.int64()),
                        ("rsum", pa.int64())])
    s = TpuSession(device="cpu")
    out = (s.from_arrow(left).group_by("k")
           .cogroup(s.from_arrow(right).group_by("k2"))
           .apply_in_pandas(merge, schema).collect().to_pydict())
    assert out == {"k": [1, 2, 3, 4], "lsum": [21, 20, 30, 0],
                   "rsum": [5, 13, 0, 8]}
    js = JSession()
    ref = (js.from_arrow(left).group_by("k")
           .cogroup(js.from_arrow(right).group_by("k2"))
           .apply_in_pandas(merge, schema).collect().to_pydict())
    assert out == ref


def test_cogroup_worker_error_propagates():
    from spark_rapids_tpu_torch.exec.python_exec import PythonWorkerError
    s = TpuSession(device="cpu")
    left = s.from_arrow(pa.table({"k": pa.array([1], pa.int64())}))
    right = s.from_arrow(pa.table({"k2": pa.array([1], pa.int64())}))

    def boom(ldf, rdf):
        raise ValueError("kaput")

    df = (left.group_by("k").cogroup(right.group_by("k2"))
          .apply_in_pandas(boom, t.StructType([t.StructField("k", t.LONG)])))
    with pytest.raises(PythonWorkerError, match="kaput"):
        df.collect()


def test_hive_udf_object_is_pinned():
    """The fingerprint keys on the UDF object's id, and the plan cache on
    the fingerprint: the object lives as long as the process, so a
    graph cached for a dropped UDF is never found under a recycled id."""
    expr = HiveSimpleUDF(_Scale(), t.LONG, col("x"))
    uid = id(expr.udf)
    assert f"@{uid}" in expr.fingerprint()
    del expr
    assert id(_UDF_PIN[uid]) == uid
    assert isinstance(_UDF_PIN[uid], _Scale)
