"""The 22 TPC-H queries on the port's CPU engine
(`spark.rapids.tpu.sql.enabled=false`) against the JAX package's CPU
engine at scale 0.001: integers, strings and decimals exactly, DOUBLE
columns within a relative 1e-12 (sums in another order); and the CPU
engine in a process where pyarrow cannot be imported, as on the card's
machine."""
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
assert "pyarrow" not in {m.split(".")[0] for m, v in sys.modules.items()
                         if v is not None}
print("ran", len(tpch.QUERIES))
"""


def test_the_cpu_engine_runs_without_pyarrow():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", NO_PYARROW], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == f"ran {len(PTPCH.QUERIES)}"
