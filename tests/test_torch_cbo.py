"""The port's cost-based optimizer (plan/cbo.py, off by default): port
copies of tests/test_cbo.py.  The reference's island comes from a Python
UDF, which the port has no class for; a projection that the port's
tagging sends to the CPU engine (a cast to STRING and back) makes the
same shape, and the reference's same plan is tagged alike."""
import pyarrow as pa

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan.overrides import apply_overrides as japply
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.aggregates import Sum
from spark_rapids_tpu_torch.plan.overrides import apply_overrides
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

CBO = {"spark.rapids.tpu.sql.optimizer.enabled": True}


def _host_long(E, T, name, plus=0):
    """A LONG that only the CPU engine computes: the text of the value
    (+ plus) read back."""
    v = E.ColumnRef(name)
    if plus:
        v = E.Add(v, E.Literal(plus))
    return E.Cast(E.Cast(v, T.STRING), T.LONG)


def _island_plan(E, T, Lg, scan):
    """CPU(project) -> device-capable Filter -> CPU(project): the middle
    Filter is a device island costing two transitions."""
    inner = Lg.LogicalProject([_host_long(E, T, "x", 1), E.ColumnRef("x")],
                              scan, names=["y", "x"])
    filt = Lg.LogicalFilter(E.GreaterThan(E.ColumnRef("y"), E.Literal(5)),
                            inner)
    return Lg.LogicalProject([E.Multiply(_host_long(E, T, "y"),
                                         E.Literal(2))], filt, names=["z"])


def _table():
    return pa.table({"x": pa.array(range(20), pa.int64())})


def test_cbo_off_by_default_keeps_island():
    q = apply_overrides(_island_plan(E, t, L, L.LogicalScan(
        from_arrow(_table()))), device="cpu")
    tree = q.root.tree_string()
    assert "FilterExec" in tree and "CpuFilterExec" not in tree
    assert "HostToDeviceExec" in tree
    jq = japply(_island_plan(JE, JT, JL, JL.LogicalScan(_table())))
    assert q.explain() == jq.explain()


def test_cbo_untags_cheap_island():
    conf = TpuConf(CBO)
    q = apply_overrides(_island_plan(E, t, L, L.LogicalScan(
        from_arrow(_table()))), conf, device="cpu")
    tree = q.root.tree_string()
    assert "CpuFilterExec" in tree          # island pushed to the CPU
    assert "HostToDeviceExec" not in tree
    exp = [(x + 1) * 2 for x in range(20) if x + 1 > 5]
    assert sorted(q.collect().to_pydict()["z"]) == sorted(exp)
    assert "cost-based" in q.explain()      # the reason shows in explain
    jq = japply(_island_plan(JE, JT, JL, JL.LogicalScan(_table())),
                JConf(CBO))
    assert q.explain() == jq.explain()


def test_cbo_keeps_expensive_island():
    tbl = from_arrow(pa.table({"k": pa.array([1, 1, 2], pa.int64()),
                               "x": pa.array([1, 2, 3], pa.int64())}))
    inner = L.LogicalProject([_host_long(E, t, "x"), E.ColumnRef("k")],
                             L.LogicalScan(tbl), names=["v", "k"])
    agg = L.LogicalAggregate(["k"], [(Sum(E.ColumnRef("v")), "s")], inner)
    outer = L.LogicalProject([_host_long(E, t, "s")], agg, names=["o"])
    q = apply_overrides(outer, TpuConf(CBO), device="cpu")
    assert "HashAggregateExec" in q.root.tree_string()   # stays on device
    assert sorted(q.collect().to_pydict()["o"]) == [3, 3]
