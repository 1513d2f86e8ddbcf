"""Three plan-level pieces of plan/overrides.py against the reference's:

  * the aggregate-twin CSE (`dedupe_agg_twins`, the reference's
    `_dedupe_agg_twins`): q15's revenue view is one object read twice
    and runs once per query, with the same result; aggregates over
    different tables (q56's channels) or over a node the walk does not
    cover never merge; the reference merges the same nodes;
  * the shim gate (shims.py, `spark.rapids.tpu.spark.version`): the
    expressions a Spark line lacks tag for the CPU engine with the
    reference's reason, var_samp / stddev_samp of one row is NaN before
    3.1 on both engines, and the ANSI default follows the line;
  * `generate_supported_ops`: its rows equal the reference's for every
    class both registries have.
"""
import math

import pyarrow as pa
import pytest

from spark_rapids_tpu import shims as JSHIMS
from spark_rapids_tpu import tpcds as JDS
from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.config import TpuConf as JConf
from spark_rapids_tpu.exec.plan import HashAggregateExec as JHashAgg
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu.plan import strings as JS
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import shims as PSHIMS
from spark_rapids_tpu_torch import tpcds as PDS
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf as PConf
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.exec.plan import HashAggregateExec
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import overrides as PO
from spark_rapids_tpu_torch.plan import strings as PS
from spark_rapids_tpu_torch.plan import window as PW
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}


def _aggs(root, cls):
    """(HashAggregateExec nodes in the tree, distinct objects among them)."""
    out = []

    def walk(n):
        if isinstance(n, cls):
            out.append(n)
        for c in n.children:
            walk(c)
    walk(root)
    return len(out), len({id(n) for n in out})


# ---------------------------------------------------------------------------
# the CSE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_tables():
    return PTPCH.gen_tables(0.001)


def test_q15_revenue_view_is_one_object_run_once(tpch_tables, monkeypatch):
    q = PTPCH.QUERIES["q15"](PSession(device="cpu"), tpch_tables).physical()
    # the view read twice and once under MAX: three visits, two objects
    assert _aggs(q.root, HashAggregateExec) == (3, 2)
    runs = []
    real = HashAggregateExec._execute

    def counted(self, ctx):
        runs.append(id(self))
        return real(self, ctx)
    monkeypatch.setattr(HashAggregateExec, "_execute", counted)
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    # each aggregate object runs once: the view read twice runs once,
    # its batches held until its second reader is done
    assert len(runs) == len(set(runs)) == 2
    assert ctx.metrics["shared_subtree_runs"] == 1
    assert not ctx.shared
    jt = JTPCH.gen_tables(0.001)
    want = JTPCH.QUERIES["q15"](JSession(), jt).collect().to_pydict()
    # DOUBLE sums within the README's f64 tolerance
    assert list(got) == list(want)
    for name in want:
        for x, y in zip(got[name], want[name]):
            assert math.isclose(x, y, rel_tol=1e-12) \
                if isinstance(y, float) else x == y
    jq = JTPCH.QUERIES["q15"](JSession(), jt).physical()
    assert _aggs(jq.root, JHashAgg) == (3, 2)


@pytest.mark.parametrize("name", ["q56", "q60", "q65", "q33"])
def test_tpcds_twins_merge_as_the_reference_merges(name):
    pt = PDS.gen_tables(0.0005)
    jt = JDS.gen_tables(0.0005)
    q = PDS.QUERIES[name](PSession(device="cpu"), pt).physical()
    jq = JDS.QUERIES[name](JSession(), jt).physical()
    assert _aggs(q.root, HashAggregateExec) == _aggs(jq.root, JHashAgg)
    if name in ("q56", "q60", "q33"):
        # one aggregate shape per channel, over different fact tables
        n, distinct = _aggs(q.root, HashAggregateExec)
        assert n == distinct


def _twin_query(s, e, a, c, table, other, window=None):
    left = table.group_by("k").agg((a.Sum(c("x")), "sx"))
    src = other
    if window is not None:
        src = src.window([(window, "rn")], partition_by=[c("k")],
                         order_by=[("x", True, True)])
    right = src.group_by("k").agg((a.Sum(c("x")), "sx"))
    return left.join(right.select(c("k"), c("sx"), names=["k2", "sx2"]),
                     left_on=["k"], right_on=["k2"]).sort("k")


def test_aggregates_over_other_tables_or_unknown_nodes_never_merge():
    t1 = pa.table({"k": [1, 2, 1, 3], "x": [1, 2, 3, 4]})
    t2 = pa.table({"k": [1, 2, 1, 3], "x": [1, 2, 3, 4]})
    s = PSession(device="cpu")
    d1, d2 = s.from_arrow(t1), s.from_arrow(t2)
    same = _twin_query(s, PE, PA, pcol, d1, d1).physical()
    other = _twin_query(s, PE, PA, pcol, d1, d2).physical()
    hidden = _twin_query(s, PE, PA, pcol, d1, d1, PW.RowNumber()) \
        .physical()
    assert _aggs(same.root, HashAggregateExec) == (2, 1)
    assert _aggs(other.root, HashAggregateExec) == (2, 2)
    assert _aggs(hidden.root, HashAggregateExec) == (2, 2)
    assert same.collect().to_pydict() == other.collect().to_pydict()
    assert from_arrow(t1).num_rows == 4


# ---------------------------------------------------------------------------
# the shim gate
# ---------------------------------------------------------------------------

VERSIONS = ["3.0.3", "3.1.2", "3.3.1", "3.4.0", "3.5.0", "4.0.0"]


@pytest.mark.parametrize("version", VERSIONS)
def test_the_shims_are_the_reference_s(version):
    j, p = JSHIMS.get_shims(version), PSHIMS.get_shims(version)
    assert (p.version_prefix, p.legacy_statistical_aggregate,
            p.ansi_default, p.unavailable_expressions) == \
        (j.version_prefix, j.legacy_statistical_aggregate, j.ansi_default,
         j.unavailable_expressions)
    conf = {"spark.rapids.tpu.spark.version": version}
    assert PConf(conf).ansi == JConf(conf).ansi
    with pytest.raises(ValueError):
        PSHIMS.get_shims("2.4.8")


@pytest.mark.parametrize("version", VERSIONS)
def test_the_shim_gate_tags_what_the_spark_line_lacks(version):
    conf = {"spark.rapids.tpu.spark.version": version}
    table = pa.table({"s": ["a-b-c", "x-y", None], "i": [1, 2, 3]})

    def build(e, st, c, s):
        return s.from_arrow(table).select(
            c("i"), e.Alias(st.SplitPart(c("s"), "-", 2), "p"))
    jdf = build(JE, JS, jcol, JSession(conf))
    pdf = build(PE, PS, pcol, PSession(conf, device="cpu"))
    q = pdf.physical()
    assert q.explain() == jdf.physical().explain()
    assert ("shim gate" in q.explain()) == version.startswith(
        ("3.0", "3.1", "3.2", "3.3"))
    assert q.collect().to_pydict() == \
        JDF(jdf._plan, JSession({**conf, **ORACLE})).collect().to_pydict()


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("version", ["3.0.3", "3.5.0"])
def test_sample_variance_of_one_row_follows_the_spark_line(version, engine):
    conf = {"spark.rapids.tpu.spark.version": version}
    table = pa.table({"k": [1, 2, 2, 3], "x": [4.0, 1.0, 3.0, None]})

    def build(a, c, s):
        return s.from_arrow(table).group_by("k").agg(
            (a.VarianceSamp(c("x")), "v"), (a.StddevSamp(c("x")), "sd"),
            (a.VariancePop(c("x")), "vp")).sort("k")
    js = JSession({**conf, **ORACLE})
    want = JDF(build(JA, jcol, js)._plan, js).collect().to_pydict()
    pconf = {**conf, **ORACLE} if engine == "cpu" else conf
    got = build(PA, pcol, PSession(pconf, device="cpu")).to_pydict()
    one = got["v"][0]
    if version.startswith("3.0"):
        assert one != one and got["sd"][0] != got["sd"][0]      # NaN
    else:
        assert one is None
    # PyTorch's CPU float64 sqrt may land 1 ulp off (README)
    for name in ("v", "sd", "vp"):
        for x, y in zip(got[name], want[name]):
            assert (x is None and y is None) or (x != x and y != y) or \
                math.isclose(x, y, rel_tol=4.5e-16), (name, x, y)


# ---------------------------------------------------------------------------
# the supported-ops table
# ---------------------------------------------------------------------------

def _rows(text: str) -> dict:
    section, out = None, {}
    for line in text.splitlines():
        if line.startswith("## "):
            section = line[3:]
        elif line.startswith("| ") and not line.startswith("|---") and \
                section in ("Execs", "Expressions", "Aggregate functions"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            if cells[0] in ("operator", "expression", "function"):
                continue
            out[(section, cells[0])] = cells[1:]
    return out


def test_generate_supported_ops_rows_equal_the_reference_s():
    mine = _rows(PO.generate_supported_ops())
    ref = _rows(JO.generate_supported_ops())
    both = sorted(set(mine) & set(ref))
    assert len(both) >= 130
    for key in both:
        assert mine[key] == ref[key], key
    # every class of the port's registry is one of the reference's
    assert set(mine) <= set(ref)
    assert PO.generate_supported_ops().startswith(
        "# Supported expressions and operators")
