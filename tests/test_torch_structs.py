"""STRUCT and MAP columns in the port (columnar/host.py's nested layout,
plan/structs.py's shatter, the struct and map classes of
plan/collections.py) against the JAX package.

Port copies of tests/test_structs.py and tests/test_structs_nested.py:
each plan runs on the same Arrow table through the reference (its device
path and its CPU oracle) and through the port (its device path on CPU
tensors, which shatters, and its CPU engine, which keeps the nested
plan), and all four answers are equal; where the reference's CPU engine
has no answer (a group-by on a whole struct, a struct carried through a
join) the port's two engines are held to Python.  The placement lines
equal the reference's, except where the port places a shattered map's
element_at on the device (the reference registers no rule for it).
Beside them: the layout's Arrow and numpy round trips, the pins of a
null struct over a non-null child value and of a null map over a
non-empty span, the CPU engine's map functions, the shattered scan
kept per source, and the shattered queries under whole-plan capture.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import collections as JC
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.exec import compiled as PCOMP
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import collections as PC
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import structs as PSTR
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
RNG = np.random.default_rng(21)


def struct_table(n=400):
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "s": pa.array([None if i % 11 == 0 else
                       {"a": int(i % 7), "b": None if i % 5 == 0
                        else float(i) / 2, "c": f"v{i % 3}"}
                       for i in range(n)],
                      pa.struct([("a", pa.int64()), ("b", pa.float64()),
                                 ("c", pa.string())])),
    })


def map_table(n=300):
    def mk(i):
        if i % 13 == 0:
            return None
        return [(int(k), int(i * 10 + k)) for k in range(i % 4)]
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "m": pa.array([mk(i) for i in range(n)],
                      pa.map_(pa.int64(), pa.int64())),
    })


def pair_struct_table(n, null_every, seeded=False):
    vals = [None if i % null_every == 0 else
            {"a": int(RNG.integers(0, 5)) if seeded else int(i % 3),
             "b": int(RNG.integers(0, 5)) if seeded else int(i % 2)}
            for i in range(n)]
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "s": pa.array(vals, pa.struct([("a", pa.int64()),
                                       ("b", pa.int64())]))})


def struct_struct_table():
    inner = pa.struct([("c", pa.int64()), ("d", pa.string())])
    return pa.table({
        "s": pa.array([{"a": 1, "b": {"c": 10, "d": "x"}},
                       {"a": 2, "b": None}, None],
                      pa.struct([("a", pa.int64()), ("b", inner)])),
        "k": pa.array([1, 2, 3], pa.int64())})


def array_struct_table():
    st = pa.struct([("x", pa.int64()), ("y", pa.int32())])
    return pa.table({
        "arr": pa.array([[{"x": 1, "y": 2}, None, {"x": 3, "y": 4}],
                         [], None], pa.list_(st)),
        "k": pa.array([1, 2, 3], pa.int64())})


class _NS:
    """One package's modules, so each plan is written once."""

    def __init__(self, E, C, A, session, frame):
        self.E, self.C, self.A = E, C, A
        self.session, self.frame = session, frame

    def scan(self, table):
        if self.session is JSession:
            return self.session().from_arrow(table)
        return self.session(device="cpu").from_arrow(table)

    def col(self, name):
        return self.E.ColumnRef(name)

    def field(self, e, name):
        return self.C.GetStructField(e, name)


JNS = _NS(JE, JC, JA, JSession, JDF)
PNS = _NS(PE, PC, PA, PSession, PDF)


def _p_getfield_filter(ns, tables):
    s = ns.col("s")
    return (ns.scan(tables["struct"])
            .with_column("a", ns.field(s, "a"))
            .filter(ns.E.GreaterThan(ns.field(s, "a"), ns.E.Literal(2)))
            .select("id", "a"))


def _p_struct_passthrough(ns, tables):
    return ns.scan(tables["struct"]).filter(
        ns.E.LessThan(ns.col("id"), ns.E.Literal(50)))


def _p_isnull_groupby(ns, tables):
    return (ns.scan(tables["struct"])
            .filter(ns.E.IsNotNull(ns.col("s")))
            .group_by(ns.field(ns.col("s"), "a"))
            .agg((ns.A.Count(None), "n")).sort("col0"))


def _p_map_lanes(ns, tables):
    m = ns.col("m")
    return (ns.scan(tables["map"])
            .with_column("ks", ns.C.MapKeys(m))
            .with_column("vs", ns.C.MapValues(m))
            .with_column("n", ns.C.Size(ns.C.MapKeys(m)))
            .with_column("at1", ns.C.MapElementAt(m, 1))
            .select("id", "ks", "vs", "n", "at1"))


def _p_map_element_at(ns, tables):
    return (ns.scan(tables["map"])
            .with_column("at1", ns.C.MapElementAt(ns.col("m"), 1))
            .select("id", "at1")
            .filter(ns.E.IsNotNull(ns.col("at1"))))


def _p_map_passthrough(ns, tables):
    return ns.scan(tables["map"]).filter(
        ns.E.LessThan(ns.col("id"), ns.E.Literal(40)))


def _p_map_size(ns, tables):
    return ns.scan(tables["map"]).select(
        ns.col("id"), ns.C.Size(ns.col("m")), names=["id", "n"])


def _p_unshatterable(ns, tables):
    return ns.scan(tables["unshatterable"]).filter(
        ns.E.LessThan(ns.col("id"), ns.E.Literal(10)))


def _p_computed_struct(ns, tables):
    return (ns.scan(tables["ids"])
            .with_column("t", ns.C.CreateNamedStruct(["x"],
                                                     [ns.col("id")]))
            .with_column("y", ns.field(ns.col("t"), "x"))
            .select("id", "y"))


def _p_field_chain(ns, tables):
    s = ns.col("s")
    return ns.scan(tables["struct_struct"]).select(
        ns.field(ns.field(s, "b"), "c"), ns.field(ns.field(s, "b"), "d"),
        ns.field(s, "a"), ns.E.IsNull(ns.field(s, "b")),
        names=["c", "d", "a", "bnull"])


def _p_subfield_renest(ns, tables):
    return ns.scan(tables["struct_struct"]).select(
        ns.field(ns.col("s"), "b"), ns.col("s"), names=["b", "s"])


def _p_array_struct(ns, tables):
    return ns.scan(tables["array_struct"]).select(
        ns.C.Size(ns.col("arr")), ns.col("arr"), names=["sz", "arr"])


def _p_inner_field_filter(ns, tables):
    return (ns.scan(tables["struct_struct"])
            .filter(ns.E.EqualTo(ns.field(ns.field(ns.col("s"), "b"), "c"),
                                 ns.E.Literal(10)))
            .select(ns.col("k"), names=["k"]))


def _p_field_join_key(ns, tables):
    return ns.scan(tables["struct100"]).join(
        ns.scan(tables["dim_a"]),
        left_on=[ns.field(ns.col("s"), "a")],
        right_on=["a"]).select("id", "label").sort("id")


def _p_stat_agg(ns, tables):
    s = ns.col("s")
    return ns.scan(tables["corr"]).group_by("g").agg(
        (ns.A.Corr(ns.field(s, "a"), ns.field(s, "b")), "c"))


#: plan -> the placement kind both packages give (None: not pinned)
PLANS = {
    "getfield_project_filter_device": (_p_getfield_filter, "device"),
    "struct_passthrough_renests": (_p_struct_passthrough, "host"),
    "struct_isnull_and_groupby_key": (_p_isnull_groupby, "device"),
    "map_lanes_device": (_p_map_lanes, "device"),
    "map_element_at_runs_on_device": (_p_map_element_at, "device"),
    "map_passthrough_renests": (_p_map_passthrough, "host"),
    "map_size": (_p_map_size, "device"),
    "unshatterable_struct_on_cpu": (_p_unshatterable, "host"),
    "computed_struct_not_rewritten": (_p_computed_struct, "device"),
    "struct_of_struct_field_chain": (_p_field_chain, "device"),
    "struct_of_struct_subfield_renest": (_p_subfield_renest, "host"),
    "array_of_struct_renests": (_p_array_struct, "host"),
    "struct_of_struct_inner_field_filter": (_p_inner_field_filter,
                                            "device"),
    "struct_field_join_key": (_p_field_join_key, "device"),
    "struct_field_in_binary_stat_agg": (_p_stat_agg, "device"),
}
#: where the port's placement lines differ from the reference's on
#: purpose: the reference registers no rule for ShatteredMapElementAt,
#: so its projection runs on its CPU engine; the port runs the kernel
PLACEMENT_DIFFERS = {"map_lanes_device", "map_element_at_runs_on_device"}
#: where the reference's CPU oracle has no answer (pyarrow has no
#: list_value_length over a map): Python's instead
ORACLE_NO_ANSWER = {
    "map_size": lambda t: {
        "id": t["map"].column("id").to_pylist(),
        "n": [None if v is None else len(v)
              for v in t["map"].column("m").to_pylist()]},
    # pyarrow's acero carries no struct through a join
    "struct_field_join_key": lambda t: dict(zip(("id", "label"), map(
        list, zip(*[(i, f"L{v['a']}") for i, v in zip(
            t["struct100"].column("id").to_pylist(),
            t["struct100"].column("s").to_pylist()) if v is not None]))))}


@pytest.fixture(scope="module")
def tables():
    n = 60
    unshat = pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "s": pa.array([{"a": int(i), "xs": list(range(i % 3))}
                       for i in range(n)],
                      pa.struct([("a", pa.int64()),
                                 ("xs", pa.list_(pa.int64()))]))})
    m = 200
    return {
        "struct": struct_table(), "map": map_table(),
        "unshatterable": unshat,
        "ids": pa.table({"id": pa.array(np.arange(20), pa.int64())}),
        "struct_struct": struct_struct_table(),
        "array_struct": array_struct_table(),
        "struct100": struct_table(100),
        "dim_a": pa.table({
            "a": pa.array(np.arange(7), pa.int64()),
            "label": pa.array([f"L{i}" for i in range(7)])}),
        "corr": pa.table({
            "g": pa.array(np.zeros(m, np.int64)),
            "s": pa.array([{"a": int(i), "b": float(i) * 2 + 1}
                           for i in range(m)],
                          pa.struct([("a", pa.int64()),
                                     ("b", pa.float64())]))}),
    }


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-9 * max(1.0, abs(a))
    return a == b


def _same(got, want):
    assert list(got) == list(want)
    for k in got:
        assert len(got[k]) == len(want[k]), k
        assert all(_close(x, y) for x, y in zip(got[k], want[k])), \
            (k, got[k], want[k])


@pytest.mark.parametrize("case", list(PLANS))
def test_each_plan_equals_the_reference_on_both_engines(case, tables):
    build, kind = PLANS[case]
    jdf, pdf = build(JNS, tables), build(PNS, tables)
    jq, pq = jdf.physical(), pdf.physical()
    assert pq.kind == jq.kind == kind
    if case not in PLACEMENT_DIFFERS:
        assert pq.explain() == jq.explain()
    got = pdf.collect().to_pydict()
    cpu = PDF(pdf._plan, PSession(ORACLE, device="cpu")).collect() \
        .to_pydict()
    ref = jq.collect().to_pydict()
    oracle = ORACLE_NO_ANSWER[case](tables) if case in ORACLE_NO_ANSWER \
        else JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict()
    for other in (cpu, ref, oracle):
        _same(got, other)


def test_map_element_at_places_its_kernel_on_the_device(tables):
    q = _p_map_element_at(PNS, tables).physical()
    assert "cannot" not in q.explain()
    assert "CpuProjectExec" not in q.physical_tree()
    jq = _p_map_element_at(JNS, tables).physical()
    assert "ShatteredMapElementAt has no TPU rule" in jq.explain()


def test_the_struct_oracles_hold(tables):
    """The independent Python answers of the reference's file."""
    tbl = tables["struct"]
    out = _p_getfield_filter(PNS, tables).collect()
    exp = [(i, v["a"]) for i, v in zip(tbl.column("id").to_pylist(),
                                      tbl.column("s").to_pylist())
           if v is not None and v["a"] is not None and v["a"] > 2]
    assert list(zip(out.column_by_name("id").to_pylist(),
                    out.column_by_name("a").to_pylist())) == exp
    out = _p_struct_passthrough(PNS, tables).collect()
    assert out.column_by_name("s").to_pylist() == \
        tbl.column("s").to_pylist()[:50]
    assert PH.to_arrow(out).schema.field("s").type == \
        tbl.schema.field("s").type
    mt = tables["map"]
    out = _p_map_lanes(PNS, tables).collect()
    assert out.column_by_name("at1").to_pylist() == [
        None if v is None else dict(v).get(1)
        for v in mt.column("m").to_pylist()]
    out = _p_map_passthrough(PNS, tables).collect()
    assert out.column_by_name("m").to_pylist() == \
        mt.column("m").to_pylist()[:40]


def _group_answer(table):
    want = {}
    for v in table.column("s").to_pylist():
        k = None if v is None else (v["a"], v["b"])
        want[k] = want.get(k, 0) + 1
    return want


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_groupby_whole_struct_key_equals_python(engine):
    # the reference's CPU engine cannot group by a struct (pyarrow), so
    # both engines of the port hold to Python; the device groups a null
    # struct apart from a struct of null fields
    tbl = pair_struct_table(300, 10)
    extra = pa.table({"id": pa.array([300, 301], pa.int64()),
                      "s": pa.array([{"a": None, "b": None}, None],
                                    tbl.schema.field("s").type)})
    tbl = pa.concat_tables([tbl, extra])
    conf = ORACLE if engine == "cpu" else None
    df = PSession(conf, device="cpu").from_arrow(tbl).group_by("s").agg(
        (PA.Count(None), "n"))
    out = df.collect()
    got = {None if v is None else (v["a"], v["b"]): c
           for v, c in zip(out.column_by_name("s").to_pylist(),
                           out.column_by_name("n").to_pylist())}
    assert got == _group_answer(tbl)
    if engine == "device":
        jout = JSession().from_arrow(tbl).group_by("s").agg(
            (JA.Count(None), "n")).collect()
        assert got == {None if v is None else (v["a"], v["b"]): c
                       for v, c in zip(jout.column("s").to_pylist(),
                                       jout.column("n").to_pylist())}


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_sort_by_struct_equals_python(engine):
    tbl = pair_struct_table(120, 9, seeded=True)
    conf = ORACLE if engine == "cpu" else None
    got = PSession(conf, device="cpu").from_arrow(tbl).sort("s", "id") \
        .collect().column_by_name("s").to_pylist()

    def key(v):
        return (v is not None, (v["a"], v["b"]) if v else ())
    assert got == sorted(tbl.column("s").to_pylist(), key=key)
    if engine == "device":
        assert got == JSession().from_arrow(tbl).sort("s", "id").collect() \
            .column("s").to_pylist()


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_struct_through_join_equals_python(engine):
    # pyarrow's acero carries no struct through a join: the reference's
    # CPU engine has no answer, the port's has
    tbl = struct_table(200)
    dim = pa.table({"id": pa.array(np.arange(0, 200, 2), pa.int64()),
                    "w": pa.array(np.arange(100), pa.int64())})
    s = PSession(ORACLE if engine == "cpu" else None, device="cpu")
    out = s.from_arrow(tbl).join(s.from_arrow(dim), left_on=["id"],
                                 right_on=["id"]) \
        .select("id", "s", "w").sort("id").collect()
    svals = dict(zip(tbl.column("id").to_pylist(),
                     tbl.column("s").to_pylist()))
    ids = sorted(set(svals) & set(dim.column("id").to_pylist()))
    assert out.column_by_name("id").to_pylist() == ids
    assert out.column_by_name("s").to_pylist() == [svals[i] for i in ids]


def test_a_whole_struct_join_key_keeps_the_column_nested():
    tbl = pair_struct_table(40, 7)
    other = pair_struct_table(40, 5)
    s = PSession(device="cpu")
    df = s.from_arrow(tbl).join(s.from_arrow(other).select(
        PE.Alias(PE.ColumnRef("s"), "s2"), PE.Alias(PE.ColumnRef("id"),
                                                    "id2")),
        left_on=["s"], right_on=["s2"])
    plan = PSTR.shatter_nested(df._plan)
    assert "s" in plan.schema.names and "s#__v" not in plan.schema.names


# ---------------------------------------------------------------------------
# The host layout
# ---------------------------------------------------------------------------

def test_a_null_struct_over_a_valid_child_reads_null():
    # Arrow keeps a child value under a null struct: StructArray.field
    # gives it, pc.struct_field and Spark's getField give null
    arr = pa.StructArray.from_arrays([pa.array([1, 2], pa.int64())], ["x"],
                                     mask=pa.array([False, True]))
    assert arr.field(0).to_pylist() == [1, 2]
    hb = PH.from_arrow(pa.table({"s": arr, "k": [1, 2]}))
    col = hb.columns[0]
    assert col.field("x").to_pylist() == [1, 2]
    assert PH.struct_field(col, "x").to_pylist() == [1, None]
    assert hb.to_pydict()["s"] == [{"x": 1}, None]
    for conf in (None, ORACLE):
        out = PSession(conf, device="cpu").from_host(hb).select(
            PC.GetStructField(PE.ColumnRef("s"), "x"), names=["x"]) \
            .to_pydict()
        assert out == {"x": [1, None]}
    flat = PSTR._flatten_table(hb, {"s"})
    assert flat.names == ["s#__v", "s#x", "k"]
    assert flat.to_pydict()["s#x"] == [1, None]


def test_a_null_map_over_a_span_leaks_no_entry():
    arr = pa.MapArray.from_arrays(pa.array([0, 1, 3], pa.int32()),
                                  pa.array([1, 2, 3], pa.int64()),
                                  pa.array([10, 20, 30], pa.int64()),
                                  mask=pa.array([False, True]))
    assert arr.to_pylist() == [[(1, 10)], None]
    hb = PH.from_arrow(pa.table({"m": arr}))
    col = hb.columns[0]
    assert col.offsets.tolist() == [0, 1, 1]
    assert len(col.elements()) == 1
    flat = PSTR._flatten_table(hb, {"m"})
    assert flat.to_pydict() == {"m#__v": [True, False],
                                "m#keys": [[1], None],
                                "m#vals": [[10], None]}
    for conf in (None, ORACLE):
        out = PSession(conf, device="cpu").from_host(hb).select(
            PC.Size(PE.ColumnRef("m")), PC.MapElementAt(PE.ColumnRef("m"), 2),
            PE.ColumnRef("m"), names=["n", "v", "m"]).to_pydict()
        assert out == {"n": [1, None], "v": [None, None],
                       "m": [[(1, 10)], None]}


def test_the_layout_round_trips_arrow_and_numpy():
    st = pa.struct([("a", pa.int64()), ("b", pa.float64()),
                    ("c", pa.string())])
    tbl = pa.table({
        "s": pa.array([None if i % 3 == 0 else
                       {"a": i, "b": None if i % 2 else i / 2,
                        "c": f"v{i}"} for i in range(9)], st).slice(1),
        "m": pa.concat_arrays([map_table(5).column("m").combine_chunks()]
                              * 2).slice(1, 8),
        "arr": pa.array([[{"x": 1}, None], [], None, [{"x": 4}]] * 2,
                        pa.list_(pa.struct([("x", pa.int64())]))),
    })
    hb = PH.from_arrow(tbl)
    assert hb.to_pydict() == tbl.to_pydict()
    assert PH.to_arrow(hb).to_pydict() == tbl.to_pydict()
    assert PH.to_arrow(hb).schema == tbl.schema
    idx = np.array([3, -1, 0, 7, 7])
    from spark_rapids_tpu_torch.ops import host as OH
    taken = PH.HostBatch([OH.take(c, idx) for c in hb.columns], hb.names)
    want = tbl.to_pydict()
    assert taken.to_pydict() == {k: [None if i < 0 else v[i] for i in idx]
                                 for k, v in want.items()}
    parts = PH.concat_host([hb.slice(0, 3), hb.slice(3, 5)])
    assert parts.to_pydict() == want
    # numpy alone: dicts and (key, value) pairs, typed or inferred
    py = {"s": [{"a": 1, "b": "x"}, None, {"a": None, "b": "y"}],
          "m": [[(1, 2.5)], None, []], "l": [[1], None, [2, 3]]}
    pb = PH.from_pydict(py)
    assert pb.schema.simple_string == ("struct<s:struct<a:bigint,b:string>,"
                                       "m:map<bigint,double>,"
                                       "l:array<bigint>>")
    assert pb.to_pydict() == py
    keys = PH.HostColumn(np.array([1, 2, 3], np.int32), None, PT.INT)
    vals = PH.HostColumn(np.array([4, 5, 6], np.int64), None, PT.LONG)
    m = PH.map_column(keys, vals, [0, 2, 2, 3], np.array([True, False,
                                                         True]))
    assert m.to_pylist() == [[(1, 4), (2, 5)], None, [(3, 6)]]
    s = PH.struct_column([keys, vals], ["k", "v"], np.array([True, False,
                                                            True]))
    assert s.to_pylist() == [{"k": 1, "v": 4}, None, {"k": 3, "v": 6}]
    assert PH.host_nbytes(s) == 3 + 12 + 24
    assert PH.host_nbytes(m) == 3 + 12 + 24


def test_a_struct_batch_uploads_as_its_lanes_and_renests():
    hb = PH.from_arrow(struct_table(30))
    df = PSession(device="cpu").from_host(hb)
    q = df.physical()
    assert q.physical_tree().splitlines()[0] == "CpuProjectExec[id, s]"
    assert q.collect().to_pydict() == hb.to_pydict()


# ---------------------------------------------------------------------------
# The CPU engine's map functions and the struct-valued classes
# ---------------------------------------------------------------------------

def _map_fn_exprs(E, C):
    m, t = E.ColumnRef("m"), E.ColumnRef("t")
    return [
        ("stm", C.StrToMap(t, ",", ":")),
        ("mfa", C.MapFromArrays(E.ColumnRef("ka"), E.ColumnRef("va"))),
        ("mc", C.MapConcat(m, C.MapFromArrays(E.ColumnRef("kb"),
                                              E.ColumnRef("va")))),
        ("me", C.MapEntries(m)),
        ("tv", C.TransformValues(m, lambda k, v: v * 2)),
        ("tk", C.TransformKeys(m, lambda k, v: k + 100)),
        ("mf", C.MapFilter(m, lambda k, v: v % 2 == 0)),
        ("ns", C.CreateNamedStruct(["p", "q"], [E.ColumnRef("ka"), t])),
    ]


def test_the_map_functions_equal_the_reference():
    tbl = pa.table({
        "m": pa.array([[(1, 10), (2, 21)], None, [], [(5, 50)]],
                      pa.map_(pa.int64(), pa.int64())),
        "t": pa.array(["a:1,b:2", "x", None, "k:"]),
        "ka": pa.array([[1, 2], [3], None, [4]], pa.list_(pa.int64())),
        "kb": pa.array([[7, 8], [9], [6], [3]], pa.list_(pa.int64())),
        "va": pa.array([[5, 6], [7], [8], [9]], pa.list_(pa.int64())),
    })
    pairs = _map_fn_exprs(PE, PC)
    jpairs = _map_fn_exprs(JE, JC)
    pdf = PSession(device="cpu").from_arrow(tbl).select(
        *[e for _n, e in pairs], names=[n for n, _e in pairs])
    jdf = JSession().from_arrow(tbl).select(
        *[e for _n, e in jpairs], names=[n for n, _e in jpairs])
    pq, jq = pdf.physical(), jdf.physical()
    assert pq.kind == jq.kind == "host"
    assert pq.fallback_reasons() == jq.fallback_reasons()
    got = pq.collect().to_pydict()
    assert got == jq.collect().to_pydict()
    assert got == PDF(pdf._plan, PSession(ORACLE, device="cpu")).collect() \
        .to_pydict()


@pytest.mark.parametrize("build", [
    lambda C, E: C.StrToMap(E.ColumnRef("t"), ",", ":"),
    lambda C, E: C.MapConcat(E.ColumnRef("m"), E.ColumnRef("m")),
])
def test_a_duplicate_map_key_raises_as_the_reference(build):
    tbl = pa.table({"t": pa.array(["a:1,a:2"]),
                    "m": pa.array([[(1, 2)]], pa.map_(pa.int64(),
                                                      pa.int64()))})
    with pytest.raises(ValueError, match="mapKeyDedupPolicy=EXCEPTION"):
        JSession().from_arrow(tbl).select(build(JC, JE), names=["r"]) \
            .collect()
    with pytest.raises(ValueError, match="mapKeyDedupPolicy=EXCEPTION"):
        PSession(device="cpu").from_arrow(tbl).select(
            build(PC, PE), names=["r"]).collect()


# ---------------------------------------------------------------------------
# The shattered scan per source, and whole-plan capture
# ---------------------------------------------------------------------------

def test_the_flattened_scan_is_kept_per_source():
    hb = PH.from_arrow(struct_table(50))
    s = PSession(device="cpu")
    roots = []
    for _ in range(2):
        q = s.from_host(hb).select(
            PC.GetStructField(PE.ColumnRef("s"), "a"), names=["a"]) \
            .physical()
        node = q.root
        while node.children:
            node = node.children[0]
        roots.append(node.table.source)
    assert roots[0] is roots[1]
    assert roots[0].names == ["id", "s#__v", "s#a", "s#b", "s#c"]


@pytest.mark.parametrize("case", ["getfield_project_filter_device",
                                  "map_element_at_runs_on_device",
                                  "struct_passthrough_renests"])
def test_shattered_queries_capture_and_equal_eager(case, tables):
    PCOMP.clear_caches()
    build, _kind = PLANS[case]
    hb = PH.from_arrow(tables["struct" if "struct" in case else "map"])
    eager = build(PNS, tables).collect().to_pydict()
    s = PSession({"spark.rapids.tpu.sql.compile.wholePlan": "ON"},
                 device="cpu")
    frame = build(_NS(PE, PC, PA, lambda *a, **k: s, PDF), tables)
    q = frame.physical()
    out = q.collect(ExecContext(q.conf, q.device)).to_pydict()
    assert out == eager
    if case == "struct_passthrough_renests":
        # the top re-nest is a CPU operator: the device part below it
        # captures, the re-nest runs on the host over its result
        assert q.kind == "host" and q._renest_top() is not None
    assert PCOMP.decision(q) == "whole"
    # a second collect replays the cached graph
    again = q.collect(ExecContext(q.conf, q.device)).to_pydict()
    assert again == eager
    assert hb.num_rows
