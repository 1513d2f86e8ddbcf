"""The PyTorch/CUDA port's host format, device batches and data
generation against the JAX package.

* `gen_tables` of the port equals the reference's value for value, table
  by table, from the same seed.
* Every lineitem column survives the port's host -> device -> host round
  trip (on CPU tensors) and equals the reference's own round trip.
* The port needs neither jax, nor the JAX package, nor pyarrow: a
  subprocess with all three blocked imports it and runs q6.
* `TpuSession()` with no device refuses to run where there is no GPU.
"""
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.columnar import device as JD
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import device as PD
from spark_rapids_tpu_torch.columnar import host as PHOST
from spark_rapids_tpu_torch.session import TpuSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jtables():
    return JTPCH.gen_tables(0.001)


@pytest.fixture(scope="module")
def ptables():
    return PTPCH.gen_tables(0.001)


@pytest.mark.parametrize("name", list(PTPCH.TABLES))
def test_gen_tables_value_identical(jtables, ptables, name):
    want = jtables[name]
    got = ptables[name]
    assert got.names == want.schema.names
    assert got.schema.simple_string == PHOST.from_arrow(
        want).schema.simple_string
    assert got.to_pydict() == want.to_pydict()


@pytest.mark.parametrize("subset", [("lineitem",),
                                    ("customer", "orders", "lineitem")])
def test_gen_tables_subset_draws_identically(ptables, subset):
    only = PTPCH.gen_tables(0.001, tables=subset)
    assert list(only) == list(subset)
    for name in subset:
        assert only[name].to_pydict() == ptables[name].to_pydict()


_LINEITEM_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                     "l_extendedprice", "l_discount", "l_tax",
                     "l_returnflag", "l_linestatus", "l_shipdate",
                     "l_commitdate", "l_receiptdate", "l_shipmode"]


@pytest.mark.parametrize("column", _LINEITEM_COLUMNS)
def test_lineitem_column_round_trip(jtables, column):
    table = jtables["lineitem"].select([column])
    hb = PHOST.from_arrow(table)
    db = PD.to_device(hb, device="cpu")
    assert db.capacity == PD.bucket_capacity(table.num_rows)
    back = PD.fetch_result_batch(db)
    got = PHOST.to_arrow(back)
    assert got.equals(table), column
    # the reference's own device round trip gives the same values
    jback = JD.to_host(JD.to_device(JHostBatch(table.to_batches()[0])),
                       table.num_rows)
    assert jback.to_table().to_pydict() == got.to_pydict()


def test_from_numpy_nulls_decimals_and_strings():
    schema = PT.StructType([
        PT.StructField("s", PT.STRING), PT.StructField("d",
                                                       PT.DecimalType(9, 2)),
        PT.StructField("i", PT.INT), PT.StructField("f", PT.DOUBLE)])
    hb = PHOST.from_numpy({
        "s": np.array(["b", None, "a", "b"], dtype=object),
        "d": (np.array([125, -5, 0, 7]), np.array([True, True, False, True])),
        "i": np.array([1, 2, 3, 4]),
        "f": np.array([0.5, -0.0, np.nan, 1e300])}, schema)
    s = hb.column_by_name("s")
    assert list(s.dictionary) == ["a", "b"]
    assert s.to_pylist() == ["b", None, "a", "b"]
    back = PD.fetch_result_batch(PD.to_device(hb, device="cpu"))
    got = back.to_pydict()
    assert got["s"] == ["b", None, "a", "b"]
    assert [str(v) if v is not None else None for v in got["d"]] == \
        ["1.25", "-0.05", None, "0.07"]
    assert got["i"] == [1, 2, 3, 4]
    f = back.column_by_name("f").data
    assert f.view(np.int64).tolist() == np.array(
        [0.5, -0.0, np.nan, 1e300]).view(np.int64).tolist()
    assert PHOST.to_arrow(back).to_pydict()["s"] == got["s"]


def test_all_null_strings_round_trip_and_concat():
    a = PHOST.string_column(np.array([None, None], object))
    b = PHOST.string_column(np.array(["x", None], object))
    assert len(a.dictionary) == 0 and a.to_pylist() == [None, None]
    both = PHOST.concat_host([PHOST.HostBatch([a], ["s"]),
                              PHOST.HostBatch([b], ["s"])])
    assert both.to_pydict() == {"s": [None, None, "x", None]}
    back = PD.fetch_result_batch(PD.to_device(both, device="cpu"))
    assert back.to_pydict() == {"s": [None, None, "x", None]}


def test_bucket_capacity_matches_reference():
    from spark_rapids_tpu.config import TpuConf as JConf
    from spark_rapids_tpu_torch.config import TpuConf as PConf
    for n in (0, 1, 1000, 1025, 4096, 70_000, 4_194_304, 4_194_305):
        assert PD.bucket_capacity(n, PConf()) == JD.bucket_capacity(
            n, JConf())


def test_conf_keys_and_defaults_match_reference():
    from spark_rapids_tpu import config as JC
    from spark_rapids_tpu_torch import config as PC
    port = {e.key: e.default for e in PC.all_entries()}
    ref = {e.key: e.default for e in JC.all_entries()}
    assert set(ref) <= set(port) or set(port) <= set(ref)
    differ = {k for k in set(port) & set(ref) if port[k] != ref[k]}
    # the port turns the kernel tier on by default, and lets its hash
    # table take every join it can table (README)
    assert differ == {"spark.rapids.tpu.sql.kernels.pallas.enabled",
                      "spark.rapids.tpu.sql.kernels.pallas.join.denseReplace"}


def test_session_without_device_refuses_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: TpuSession() rightly uses it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuSession(device="cuda")


def test_entry_points_without_device_refuse_on_cpu_only_host():
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points rightly use it")
    tables = tpch.gen_tables(0.0001, tables=("lineitem",))
    plan = tpch.q6(TpuSession(device="cpu"), tables)._plan
    hb = tables["lineitem"]
    for call in (lambda: apply_overrides(plan),
                 lambda: ExecContext(),
                 lambda: PD.to_device(hb),
                 lambda: PD.empty_device_batch(hb.schema)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for explicitly, the CPU runs the same plan
    assert apply_overrides(plan, device="cpu").collect().num_rows == 1


def test_port_runs_without_jax_reference_or_pyarrow():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'pyarrow', 'spark_rapids_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from spark_rapids_tpu_torch import tpch\n"
        "from spark_rapids_tpu_torch.session import TpuSession\n"
        "t = tpch.gen_tables(0.001, tables=('lineitem',))\n"
        "r = tpch.q6(TpuSession(device='cpu'), t).collect().to_pydict()\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and\n"
        "          m.split('.')[0] in ('jax', 'jaxlib', 'pyarrow',\n"
        "                              'spark_rapids_tpu')]\n"
        "assert not loaded, loaded\n"
        "print(r['revenue'][0])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip()


def _uniq_case(case):
    """(arrow table, key names, expected) of one uniqueness case."""
    rng = np.random.default_rng(len(case))
    a = rng.permutation(5000)
    b = rng.integers(0, 7, 5000)
    if case == "single_unique":
        return pa.table({"a": a}), ["a"], True
    if case == "single_dup":
        return pa.table({"a": np.r_[a[:-1], a[0]]}), ["a"], False
    if case == "wide_span":                # sparse values: the sort path
        return pa.table({"a": a * 10 ** 12}), ["a"], True
    if case == "pair_unique":
        return pa.table({"a": a // 7, "b": a % 7}), ["a", "b"], True
    if case == "pair_dup":
        return pa.table({"a": a // 7, "b": b}), ["a", "b"], False
    if case == "pair_too_wide":            # spans multiply past 2^62
        return pa.table({"a": a.astype(np.int64) << 40,
                         "b": (a % 11).astype(np.int64) << 40}), \
            ["a", "b"], True
    # a duplicate whose second copy has a null key is not a duplicate
    mask = np.zeros(5000, bool)
    mask[-1] = True
    return pa.table({"a": pa.array(np.r_[a[:-1], a[0]], mask=mask),
                     "b": a % 3}), ["a", "b"], True


@pytest.mark.parametrize("case", ["single_unique", "single_dup",
                                  "wide_span", "pair_unique", "pair_dup",
                                  "pair_too_wide", "nulls"])
def test_keys_unique_statistic_matches_reference(case):
    from spark_rapids_tpu.exec.plan import _table_keys_unique
    table, names, want = _uniq_case(case)
    assert _table_keys_unique(table, tuple(names)) == want
    assert PHOST.from_arrow(table).keys_unique(names) == want
