"""The ARRAY classes of plan/collections.py and explode / posexplode in
the port against the JAX package.

Port copies of the ARRAY cases of tests/test_collections.py: explode,
posexplode and their outer forms on the CPU engine (CpuGenerateExec) and
on the device (GenerateExec), the Generate placement rule, and every
ARRAY class of module 4 (the ragged device ones, CreateArray, and the
CPU-only set and list functions) on both engines of the port, each equal
to the reference's device path and to its CPU oracle, with the
reference's placement lines.  STRUCT and MAP columns enter and run
(their own file is tests/test_torch_structs.py); the device explode
captures whole under
`sql.compile.wholePlan=ON` and equals the eager run.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import collections as JC
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan.overrides import apply_overrides as japply
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.exec import compiled as PCOMP
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import collections as PC
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.overrides import apply_overrides as papply
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}


def arr_table():
    return pa.table({
        "a": pa.array([[1, 2, 3], [], None, [5, None], [7]],
                      pa.list_(pa.int64())),
        "k": pa.array([1, 2, 3, 4, 5], pa.int64()),
    })


def _scan(Lm, table):
    return Lm.LogicalScan(table if Lm is JL else PH.from_arrow(table))


def _both_plans(make, table):
    """The reference's and the port's physical queries of one plan
    function `make(L, E, C, A, scan)`."""
    jq = japply(make(JL, JE, JC, JA, _scan(JL, table)))
    pq = papply(make(PL, PE, PC, PA, _scan(PL, table)), device="cpu")
    return jq, pq


def _gen(pos=False, outer=False, names=("v",)):
    def make(Lm, E, C, A, scan):
        return Lm.LogicalGenerate(C.ExplodeGen(E.ColumnRef("a"), pos=pos,
                                               outer=outer), scan,
                                  list(names))
    return make


@pytest.mark.parametrize("pos,outer,names,want_k,want_p,want_v", [
    (False, False, ("v",), [1, 1, 1, 4, 4, 5], None,
     [1, 2, 3, 5, None, 7]),
    (False, True, ("v",), [1, 1, 1, 2, 3, 4, 4, 5], None,
     [1, 2, 3, None, None, 5, None, 7]),
    (True, False, ("p", "v"), [1, 1, 1, 4, 4, 5], [0, 1, 2, 0, 1, 0],
     [1, 2, 3, 5, None, 7]),
    (True, True, ("p", "v"), [1, 1, 1, 2, 3, 4, 4, 5],
     [0, 1, 2, None, None, 0, 1, 0], [1, 2, 3, None, None, 5, None, 7]),
])
def test_explode_forms_on_the_cpu_engine_equal_the_reference(
        pos, outer, names, want_k, want_p, want_v):
    jq, pq = _both_plans(_gen(pos, outer, names), arr_table())
    # no parent projection prunes the array: the CPU engine's Generate
    assert pq.kind == jq.kind == "host"
    assert pq.explain() == jq.explain()
    got = pq.collect().to_pydict()
    assert got == jq.collect().to_pydict()
    assert got["k"] == want_k and got["v"] == want_v
    if pos:
        assert got["p"] == want_p
    if pos and outer:
        assert PL.LogicalGenerate(
            PC.ExplodeGen(PE.ColumnRef("a"), pos=True, outer=True),
            _scan(PL, arr_table()), ["p", "v"]).schema["p"].nullable


def test_explode_then_device_aggregate():
    def make(Lm, E, C, A, scan):
        return Lm.LogicalAggregate(
            ["k"], [(A.Sum(E.ColumnRef("v")), "s"), (A.Count(None), "c")],
            _gen()(Lm, E, C, A, scan))
    jq, pq = _both_plans(make, arr_table())
    tree = pq.root.tree_string()
    assert "HashAggregateExec" in tree and "HostToDeviceExec" in tree
    assert pq.explain() == jq.explain()
    out = pq.collect().to_pydict()
    assert {k: (s, c) for k, s, c in zip(out["k"], out["s"], out["c"])} \
        == {1: (6, 3), 4: (5, 2), 5: (7, 1)}
    assert sorted(zip(*out.values())) == \
        sorted(zip(*jq.collect().to_pydict().values()))


def _placement(Lm, E, C, A, scan, case):
    """A Generate under each of the reference's placement rules."""
    if case == "device":
        g = _gen(names=("col",))(Lm, E, C, A, scan)
        return Lm.LogicalProject([E.ColumnRef("k"), E.ColumnRef("col")], g,
                                 ["k", "col"])
    if case == "parent_reads":
        g = _gen(names=("col",))(Lm, E, C, A, scan)
        return Lm.LogicalProject([E.ColumnRef("col"), C.Size(
            E.ColumnRef("a"))], g, ["col", "n"])
    if case == "not_a_column":
        g = Lm.LogicalGenerate(C.ExplodeGen(C.SortArray(E.ColumnRef("a"))),
                               scan, ["col"])
        return Lm.LogicalProject([E.ColumnRef("col")], g, ["col"])
    if case == "second_nested":
        two = Lm.LogicalProject([E.ColumnRef("k"), E.ColumnRef("a"),
                                 E.ColumnRef("b")], scan, ["k", "a", "b"])
        g = _gen(names=("col",))(Lm, E, C, A, two)
        return Lm.LogicalProject([E.ColumnRef("k"), E.ColumnRef("col")], g,
                                 ["k", "col"])
    if case == "double_elements":
        g = Lm.LogicalGenerate(C.ExplodeGen(E.ColumnRef("d")), scan,
                               ["col"])
        return Lm.LogicalProject([E.ColumnRef("k"), E.ColumnRef("col")], g,
                                 ["k", "col"])
    raise ValueError(case)


@pytest.mark.parametrize("case", ["device", "parent_reads", "not_a_column",
                                  "second_nested", "double_elements"])
def test_the_generate_placement_rule_equals_the_reference(case):
    table = arr_table()
    if case == "second_nested":
        table = table.append_column("b", pa.array(
            [[1], None, [2, 3], [], [4]], pa.list_(pa.int32())))
    if case == "double_elements":
        table = table.append_column("d", pa.array(
            [[1.5], None, [2.0, -0.0], [], [4.25]], pa.list_(pa.float64())))
    jq, pq = _both_plans(lambda *a: _placement(*a, case), table)
    assert pq.explain() == jq.explain()
    assert ("CpuGenerateExec" in pq.physical_tree()) == (case != "device")
    key = lambda r: repr(r)                       # noqa: E731
    assert sorted(zip(*pq.collect().to_pydict().values()), key=key) == \
        sorted(zip(*jq.collect().to_pydict().values()), key=key)


def test_explode_of_a_non_array_raises():
    scan = PL.LogicalScan(PH.from_pydict({"x": [1]}))
    plan = PL.LogicalGenerate(PC.ExplodeGen(PE.ColumnRef("x")), scan, ["v"])
    with pytest.raises(TypeError):
        plan.schema


def test_a_count_over_an_array_only_child():
    tbl = pa.table({"a": pa.array([[1], [2, 3], None],
                                  pa.list_(pa.int64()))})

    def make(Lm, E, C, A, scan):
        return Lm.LogicalAggregate([], [(A.Count(None), "c")], scan)
    jq, pq = _both_plans(make, tbl)
    assert pq.explain() == jq.explain()
    assert pq.collect().to_pydict() == {"c": [3]}


SET_TABLE = pa.table({
    "a": pa.array([[1, 2, 2, None], [], None, [3, None, 3], [7, 8], [5]],
                  pa.list_(pa.int64())),
    "b": pa.array([[2, 9], [1], [4], [None], [], None],
                  pa.list_(pa.int64())),
    "s": pa.array([["x", None, "y"], [], ["z"], None, ["w", "w"], ["q"]],
                  pa.list_(pa.string())),
    "n": pa.array([2, 0, None, 1, -1, 3], pa.int64()),
    "x": pa.array([1, 2, 3, None, 5, 6], pa.int64()),
    "y": pa.array([10, None, 30, 40, 50, 60], pa.int64()),
})


def _cpu_only_exprs(E, C):
    a, b, s = E.ColumnRef("a"), E.ColumnRef("b"), E.ColumnRef("s")
    x, y, n = E.ColumnRef("x"), E.ColumnRef("y"), E.ColumnRef("n")
    return [
        ("mk", C.CreateArray(x, y)),
        ("rep", C.ArrayRepeat(x, n)),
        ("flat", C.Flatten(C.CreateArray(a, b))),
        ("dist", C.ArrayDistinct(a)),
        ("ov", C.ArraysOverlap(a, b)),
        ("un", C.ArrayUnion(a, b)),
        ("it", C.ArrayIntersect(a, b)),
        ("ex", C.ArrayExcept(a, b)),
        ("rm", C.ArrayRemove(a, 3)),
        ("js", C.ArrayJoin(s, "-", "?")),
        ("jn", C.ArrayJoin(s, ",")),
        ("sq", C.Sequence(x, y)),
        ("sq3", C.Sequence(x, y, E.Literal(7))),
        ("ssz", C.Size(s)),
        ("sct", C.ArrayContains(s, "y")),
        ("sat", C.ElementAt(s, -1)),
        ("sit", C.GetArrayItem(s, 0)),
        ("spos", C.ArrayPosition(s, "w")),
        ("sso", C.SortArray(s, False)),
        ("srev", C.ReverseArray(s)),
        ("ssl", C.Slice(s, 1, 1)),
    ]


def _project_all(Lm, E, C, A, scan):
    named = _cpu_only_exprs(E, C)
    return Lm.LogicalProject([e for _n, e in named], scan,
                             [n for n, _e in named])


def test_every_array_class_equals_the_reference_on_both_engines():
    jq, pq = _both_plans(_project_all, SET_TABLE)
    assert pq.kind == jq.kind == "host"
    assert pq.explain() == jq.explain()
    got = pq.collect().to_pydict()
    assert got == jq.collect().to_pydict()
    oq = papply(_project_all(PL, PE, PC, PA, _scan(PL, SET_TABLE)),
                PSession(ORACLE, device="cpu").conf, device="cpu")
    joq = japply(_project_all(JL, JE, JC, JA, _scan(JL, SET_TABLE)),
                 JSession(ORACLE).conf)
    assert oq.collect().to_pydict() == joq.collect().to_pydict() == got
    assert got["mk"][:2] == [[1, 10], [2, None]]
    assert got["flat"][0] == [1, 2, 2, None, 2, 9]
    assert got["ov"] == [True, False, None, None, False, None]


def test_struct_and_map_columns_refuse_naming_their_slice():
    # their slice (plan/structs.py) has ported: STRUCT and MAP columns
    # enter the port and run (tests/test_torch_structs.py holds them to
    # the reference); an ARRAY<STRUCT> of a flat struct shatters too
    st = PT.StructType([PT.StructField("f", PT.LONG)])
    f = PH.HostColumn(np.array([3, 4], np.int64), None, PT.LONG)
    cols = {"struct": PH.struct_column([f], ["f"]),
            "map": PH.map_column(f, f, [0, 1, 2]),
            "array": PH.list_column(PH.struct_column([f], ["f"]), [0, 2, 2])}
    for dt, col in cols.items():
        hb = PH.HostBatch([col, PH.HostColumn(np.arange(2), None,
                                              PT.LONG)], ["n", "k"])
        out = PSession(device="cpu").from_host(hb).collect()
        assert out.to_pydict() == hb.to_pydict(), dt
    assert cols["array"].dtype == PT.ArrayType(st)
    assert not hasattr(PE, "NESTED_SLICE")
    hb = PH.from_arrow(pa.table({"m": pa.array(
        [{"f": 1}], pa.struct([("f", pa.int64())]))}))
    assert hb.to_pydict() == {"m": [{"f": 1}]}


def test_the_device_explode_captures_whole_and_equals_eager():
    PCOMP.clear_caches()
    hb = PH.from_arrow(arr_table())

    def df(conf):
        plan = _placement(PL, PE, PC, PA, PL.LogicalScan(hb), "device")
        return PDF(plan, PSession(conf, device="cpu"))
    q = df({"spark.rapids.tpu.sql.compile.wholePlan": "ON"}).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert PCOMP.decision(q) == "whole", PCOMP.decision(q)
    assert ctx.metrics.get("whole_plan_compiled_queries") == 1
    assert got == df({}).to_pydict()
    assert sorted(zip(got["k"], got["col"]), key=repr) == sorted(
        [(1, 1), (1, 2), (1, 3), (4, 5), (4, None), (5, 7)], key=repr)
