"""Selection vectors and late materialization in the port's join
pipelines (columnar/lanes.py, `sql.join.lazySelection`,
`sql.join.lateMaterialization.enabled`), against the JAX package.

Ports of tests/test_late_materialization.py: chained outer, semi and
anti joins with null-extended rows, filters and projections between the
joins (a mid-chain filter on a deferred column forces the early
materialization of just that column), and aggregate, sort and result
sinks.  Every case runs the port (CPU tensors) under the defaults and
with each of the two keys off, and all must equal the JAX package's
device path (late materialization on, its kernel tier in interpret mode)
and its CPU oracle as sorted row sets, as the reference's tests compare
them.  The reference's whole-plan compiled boundary (ROADMAP Queue 1
item 5) is the result fetch here: a thin batch handed to the fetch
resolves to its rows.  Added: a thin batch through a sub-partitioned
join that spills under `sql.ooc` (the bucket build batches its lanes
point into stay in the budget until the sink drops them), and the
AssertionError of a prefix consumer handed a batch with a selection
vector.
"""
import gc
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import lit as jlit
from spark_rapids_tpu_torch.columnar import lanes as L
from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                    DeviceColumn,
                                                    fetch_result_batch)
from spark_rapids_tpu_torch.exec.adaptive import AdaptiveShuffledJoinExec
from spark_rapids_tpu_torch.exec.join import HashJoinExec
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.ops.batch_ops import ensure_prefix
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
from spark_rapids_tpu_torch import types as PT

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

LATE = "spark.rapids.tpu.sql.join.lateMaterialization.enabled"
LAZY = "spark.rapids.tpu.sql.join.lazySelection"
#: the port's modes: the defaults, each key off, both off
MODES = {"defaults": {}, "late_off": {LATE: "false"},
         "lazy_off": {LAZY: "false"},
         "both_off": {LATE: "false", LAZY: "false"}}
PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.join.denseReplace": "ON"}
CPU = {"spark.rapids.tpu.sql.enabled": "false"}


def _tables(seed=7, n_fact=3000, n_d1=60, n_d2=35):
    rng = np.random.default_rng(seed)
    fact = pa.table({
        # keys range past the dimension domains (unmatched rows) and
        # carry nulls (never match, null-extend under outer joins)
        "fk1": pa.array(rng.integers(0, n_d1 + 8, n_fact), pa.int64(),
                        mask=rng.random(n_fact) < 0.06),
        "fk2": pa.array(rng.integers(0, n_d2 + 8, n_fact), pa.int64(),
                        mask=rng.random(n_fact) < 0.06),
        "fv": pa.array(rng.integers(0, 1000, n_fact), pa.int64()),
    })
    d1 = pa.table({
        "k1": pa.array(np.arange(n_d1), pa.int64()),
        "p1": pa.array(rng.integers(0, 100, n_d1), pa.int64()),
        "s1": pa.array([f"grp_{i % 7}" for i in range(n_d1)]),
    })
    d2 = pa.table({
        "k2": pa.array(np.arange(n_d2), pa.int64()),
        "p2": pa.array(rng.integers(0, 50, n_d2), pa.int64()),
    })
    return fact, d1, d2


def _norm(d: dict):
    rows = list(zip(*d.values()))
    return sorted(rows, key=lambda r: tuple(
        (v is None, v if v is not None else 0) for v in r))


class _Pkg:
    """One package's session-level names for the shared query text."""

    def __init__(self, port: bool):
        self.port = port
        self.col = pcol if port else jcol
        self.Sum = PA.Sum if port else JA.Sum
        self.Count = PA.Count if port else JA.Count

    def lit(self, v):
        return PE.Literal(v) if self.port else jlit(v)

    def gt(self, a, b):
        return PE.GreaterThan(a, b) if self.port else a > b

    def plus(self, a, b):
        return PE.Add(a, b) if self.port else a + b


def _joins(node, out=None):
    out = [] if out is None else out
    if isinstance(node, (HashJoinExec, AdaptiveShuffledJoinExec)):
        out.append(node)
    for c in node.children:
        _joins(c, out)
    return out


_REFERENCE: dict = {}


def _reference(build, tables, extra):
    """The reference's device-path and oracle rows of a query, once a
    query (the modes of one case share them)."""
    key = (build.__code__, tuple(c.cell_contents for c in
                                 build.__closure__ or ()),
           tuple(t.num_rows for t in tables),
           tuple(sorted((extra or {}).items())))
    if key not in _REFERENCE:
        jdf = build(JSession({**PALLAS_ON, **(extra or {})}), _Pkg(False),
                    *tables)
        _REFERENCE[key] = (
            _norm(jdf.collect().to_pydict()),
            _norm(JDF(jdf._plan, JSession(CPU)).collect().to_pydict()))
    return _REFERENCE[key]


def _check(build, tables, mode, extra=None):
    """The port under `mode` against the reference's device path and its
    CPU oracle (sorted row sets); -> (the port's PhysicalQuery, its
    ExecContext)."""
    want, oracle = _reference(build, tables, extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = PSession({**MODES[mode], **(extra or {})}, device="cpu")
    q = build(s, _Pkg(True), *tables).physical()
    ctx = ExecContext(q.conf, q.device)
    got = _norm(q.collect(ctx).to_pydict())
    assert got == want, "port != the reference's device path"
    assert got == oracle, "port != the reference's CPU oracle"
    return q, ctx


def _arrow(s, t):
    return s.from_arrow(t)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("how1,how2", [
    ("inner", "inner"), ("left_outer", "inner"),
    ("inner", "left_outer"), ("left_outer", "left_outer")])
def test_chained_joins_with_filters_match_oracle(how1, how2, mode):
    """fact ⋈ d1 → filter → ⋈ d2 → sort: two chained joins with a filter
    between them and null-extended rows."""
    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how=how1,
                                  left_on=["fk1"], right_on=["k1"])
        j1 = j1.filter(P.gt(P.col("fv"), P.lit(200)))
        j2 = j1.join(_arrow(s, d2), how=how2, left_on=["fk2"],
                     right_on=["k2"])
        return j2.sort(("fv", False), ("fk1", False))

    q, ctx = _check(build, _tables(), mode)
    joins = _joins(q.root)
    assert joins
    if MODES[mode].get(LATE) == "false":
        assert all(j.thin_payload is None for j in joins)
        assert "join_deferred_gathers" not in ctx.metrics
    else:
        assert all(j.thin_payload for j in joins), \
            "the legality pass should mark both chained joins thin"
        assert ctx.metrics.get("join_deferred_gathers", 0) > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mid_chain_filter_on_deferred_column(mode):
    """The filter between the joins reads d1's p1, which join 1 defers:
    the filter materializes exactly that column (materialize_refs) and
    s1 stays thin to the sort."""
    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how="left_outer",
                                  left_on=["fk1"], right_on=["k1"])
        # null-extended rows drop at the filter (null > 30 is not true)
        j1 = j1.filter(P.gt(P.col("p1"), P.lit(30)))
        j2 = j1.join(_arrow(s, d2), how="inner", left_on=["fk2"],
                     right_on=["k2"])
        return j2.sort(("fv", False), ("p2", False))

    _q, ctx = _check(build, _tables(), mode)
    if MODES[mode].get(LATE) != "false":
        assert ctx.metrics.get("join_deferred_gathers", 0) > 0, \
            "the chain should defer payload gathers"
        assert ctx.metrics.get("late_gather_rows", 0) > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_semi_anti_through_chain(mode):
    """Semi and anti joins pass a thin probe stream through unchanged."""
    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how="left_outer",
                                  left_on=["fk1"], right_on=["k1"])
        semi = j1.join(_arrow(s, d2), how="left_semi", left_on=["fk2"],
                       right_on=["k2"])
        anti = j1.join(_arrow(s, d2), how="left_anti", left_on=["fk2"],
                       right_on=["k2"])
        return semi.union(anti).sort(("fv", False), ("fk1", False))

    _check(build, _tables(), mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_aggregate_sink_materializes_referenced_only(mode):
    """A group-by over a deferred dimension column: the aggregation
    materializes its key and input columns through the composed lanes,
    and with lazy selection folds the join's selection vector into its
    live mask."""
    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how="inner",
                                  left_on=["fk1"], right_on=["k1"])
        j2 = j1.join(_arrow(s, d2), how="left_outer", left_on=["fk2"],
                     right_on=["k2"])
        return (j2.group_by("s1")
                .agg((P.Sum(P.col("fv")), "sv"),
                     (P.Count(P.col("p2")), "cnt"))
                .sort(("s1", False)))

    q, ctx = _check(build, _tables(), mode)
    joins = _joins(q.root)
    if MODES[mode].get(LATE) != "false":
        assert ctx.metrics.get("join_deferred_gathers", 0) > 0
    # the join under the aggregation is mask-aware unless the key is off
    assert any(j.lazy_sel for j in joins) == \
        (MODES[mode].get(LAZY) != "false")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_projection_passes_deferred_columns_through(mode):
    """A projection between the joins: plain references to deferred
    columns pass through as lanes (project_batch), computed expressions
    materialize exactly their references."""
    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how="left_outer",
                                  left_on=["fk1"], right_on=["k1"])
        proj = j1.select(P.col("fk2"), P.col("fv"),
                         P.plus(P.col("fv"), P.lit(1)), P.col("s1"),
                         P.col("p1"), names=["fk2", "fv", "fv2", "s1", "p1"])
        j2 = proj.join(_arrow(s, d2), how="inner", left_on=["fk2"],
                       right_on=["k2"])
        return j2.sort(("fv", False), ("p1", False))

    _check(build, _tables(), mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_result_boundary_fetch_of_a_thin_pipeline(mode):
    """The result fetch is a boundary: a thin, masked batch handed to it
    resolves to its rows.  The negotiation leaves the root join dense, so
    the root join is marked by hand here; the results equal the
    reference's."""
    fact, d1, d2 = _tables(seed=11, n_fact=1500)

    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how="left_outer",
                                  left_on=["fk1"], right_on=["k1"])
        j1 = j1.filter(P.gt(P.col("fv"), P.lit(100)))
        return j1.join(_arrow(s, d2), how="inner", left_on=["fk2"],
                       right_on=["k2"])

    jdf = build(JSession(PALLAS_ON), _Pkg(False), fact, d1, d2)
    want = _norm(JDF(jdf._plan, JSession(CPU)).collect().to_pydict())
    s = PSession(MODES[mode], device="cpu")
    q = build(s, _Pkg(True), fact, d1, d2).physical()
    if MODES[mode].get(LATE) != "false":
        for j in _joins(q.root):
            j.thin_payload = frozenset(j.output_schema.names)
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx)
    assert _norm(got.to_pydict()) == want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_off_switches(mode):
    fact, d1, _d2 = _tables()
    s = PSession(MODES[mode], device="cpu")
    df = s.from_arrow(fact).join(s.from_arrow(d1), how="inner",
                                 left_on=["fk1"], right_on=["k1"]) \
        .group_by("s1").agg((PA.Sum(pcol("fv")), "sv"))
    joins = _joins(df.physical().root)
    assert joins
    assert all((j.thin_payload is None) ==
               (MODES[mode].get(LATE) == "false") for j in joins)
    assert all(j.lazy_sel == (MODES[mode].get(LAZY) != "false")
               for j in joins)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_deferred_string_rides_as_codes(mode):
    """A deferred string column keeps its dictionary on the placeholder
    and materializes as codes at the sink; values round-trip exactly,
    null-extended outer rows included."""
    def build(s, P, fact, d1, d2):
        j1 = _arrow(s, fact).join(_arrow(s, d1), how="left_outer",
                                  left_on=["fk1"], right_on=["k1"])
        j2 = j1.join(_arrow(s, d2), how="left_outer", left_on=["fk2"],
                     right_on=["k2"])
        return j2.select(P.col("fv"), P.col("s1"), P.col("p2"),
                         names=["fv", "s1", "p2"]) \
            .sort(("fv", False), ("s1", False), ("p2", False))

    _check(build, _tables(seed=23), mode)


OOC = {"spark.rapids.tpu.sql.batchSizeRows": "1024",
       "spark.rapids.tpu.sql.shape.minBucketRows": "256",
       "spark.rapids.tpu.memory.tpu.budgetBytes": str(1 << 16),
       "spark.rapids.tpu.sql.adaptive.enabled": "false"}


@pytest.mark.parametrize("mode", ["defaults", "both_off"])
def test_thin_batches_through_a_spilling_sub_partitioned_join(mode):
    """fact ⋈ a 3,000-row dimension (over 2 x batchSizeRows: the
    sub-partition join, under a 64 KiB budget: its buckets spill) ⋈ d2,
    grouped.  Under the defaults the first join defers its dimension
    columns behind bucket build batches that outlive their spillables:
    the budget holds their bytes until the sink drops the lanes, and
    releases every one after the query."""
    rng = np.random.default_rng(31)
    n_dim = 3000
    fact = pa.table({
        "fk1": pa.array(rng.integers(0, n_dim + 50, 5000), pa.int64()),
        "fk2": pa.array(rng.integers(0, 40, 5000), pa.int64()),
        "fv": pa.array(rng.integers(0, 1000, 5000), pa.int64())})
    dim = pa.table({
        "k1": pa.array(rng.permutation(n_dim), pa.int64()),
        "p1": pa.array(rng.integers(0, 100, n_dim), pa.int64()),
        "s1": pa.array([f"g{i % 11}" for i in range(n_dim)])})
    _f, _d, d2 = _tables()

    def build(s, P, fact, dim, d2):
        j1 = _arrow(s, fact).join(_arrow(s, dim), how="inner",
                                  left_on=["fk1"], right_on=["k1"])
        j2 = j1.join(_arrow(s, d2), how="inner", left_on=["fk2"],
                     right_on=["k2"])
        return (j2.group_by("s1")
                .agg((P.Sum(P.col("p1")), "sp"), (P.Sum(P.col("p2")), "s2"),
                     (P.Count(None), "n"))
                .sort(("s1", True)))

    q, ctx = _check(build, (fact, dim, d2), mode, extra=OOC)
    m, bm = ctx.metrics, ctx.budget.metrics
    assert m.get("join_subpartition_fallbacks", 0) > 0
    assert bm["spilled_batches"] > 0
    if mode == "defaults":
        assert m.get("join_deferred_gathers", 0) > 0
        assert bm["held_batches"] > 0 and bm["held_bytes"] > 0
    else:
        assert bm["held_batches"] == 0
    del q
    gc.collect()
    assert ctx.budget.settle() == 0
    assert bm["release_underflow"] == 0


def test_prefix_consumer_handed_a_selection_vector_raises():
    """A zero-length placeholder sliced in PyTorch is silently empty, not
    a shape error: every prefix consumer resolves a selection vector and
    deferred columns first (ensure_prefix) and then asserts that it
    holds a row prefix, which raises AssertionError when it does not."""
    col = DeviceColumn(torch.arange(8), torch.ones(8, dtype=torch.bool),
                       PT.LONG)
    sel = torch.tensor([True, False, True, False, False, True, False,
                        False])
    db = DeviceBatch([col], 3, ["x"], sel)
    with pytest.raises(AssertionError, match="ensure_prefix"):
        db.assert_prefix()
    assert L.deferred_column(col).data[:3].numel() == 0    # no error
    dense = ensure_prefix(db)
    dense.assert_prefix()
    assert dense.columns[0].data[:3].tolist() == [0, 2, 5]
    assert fetch_result_batch(db).column_by_name("x").data.tolist() == \
        [0, 2, 5]
