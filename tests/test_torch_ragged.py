"""Ragged ARRAY columns in the port (columnar/host.py, columnar/device.py,
ops/ragged.py, ops/search.py, plan/collections.py) against the JAX
package.

Port copies of tests/test_ragged.py: the same logical plan runs on the
port's device path (CPU tensors, the kernels' plain versions) and on its
CPU engine (sql.enabled=false), and each equals the reference's device
path and its CPU oracle; the placement lines equal the reference's.
Beside them: a `pa.list_` column's round trip through `from_arrow` /
`to_arrow` and through numpy alone (`list_column`), the upload and
fetch of the lanes, `ops/search.searchsorted` against numpy, and the
seeded fuzz of the reference's file.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.plan import collections as JC
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import device as PD
from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.ops.search import searchsorted
from spark_rapids_tpu_torch.plan import collections as PC
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}

ARR = pa.table({
    "id": pa.array([1, 2, 3, 4, 5], pa.int64()),
    "a": pa.array([[1, 2, 3], [], None, [5, None, -2], [7]],
                  pa.list_(pa.int64())),
})


def _exprs(E, C):
    """(name, expression) of every ragged device class over `a`."""
    a = E.ColumnRef("a")
    x = C.LambdaVar("x")
    return [
        ("size", C.Size(a)), ("item1", C.GetArrayItem(a, 1)),
        ("item9", C.GetArrayItem(a, 9)), ("has2", C.ArrayContains(a, 2)),
        ("has99", C.ArrayContains(a, 99)), ("amin", C.ArrayMin(a)),
        ("amax", C.ArrayMax(a)), ("sa", C.SortArray(a, True)),
        ("sd", C.SortArray(a, False)),
        ("t", C.ArrayTransform(a, E.Multiply(x, E.Literal(2)), "x")),
        ("f", C.ArrayFilter(a, E.GreaterThan(x, E.Literal(1)), "x")),
        ("e", C.ArrayExists(a, E.GreaterThan(x, E.Literal(4)), "x")),
        ("fa", C.ArrayForAll(a, E.GreaterThan(x, E.Literal(0)), "x")),
        ("m", C.ArrayMin(C.ArrayFilter(
            a, E.GreaterThanOrEqual(x, E.Literal(0)), "x"))),
        ("at1", C.ElementAt(a, 1)), ("at_1", C.ElementAt(a, -1)),
        ("at9", C.ElementAt(a, 9)), ("pos5", C.ArrayPosition(a, 5)),
        ("pos9", C.ArrayPosition(a, 9)), ("sl", C.Slice(a, 2, 2)),
        ("sln", C.Slice(a, -2, 5)), ("rev", C.ReverseArray(a)),
    ]


def _select(S, E, C, table, conf=None, **kw):
    named = _exprs(E, C)
    return S(conf, **kw).from_arrow(table).select(
        E.ColumnRef("id"), *[e for _n, e in named],
        names=["id"] + [n for n, _e in named])


def _four(table):
    """(port device, port CPU engine, reference device, reference
    oracle) of the projection of every ragged expression, and the two
    physical queries."""
    jdf = _select(JSession, JE, JC, table)
    pdf = _select(PSession, PE, PC, table, device="cpu")
    jq, pq = jdf.physical(), pdf.physical()
    return (pq.collect().to_pydict(),
            PDF(pdf._plan, PSession(ORACLE, device="cpu")).to_pydict(),
            jq.collect().to_pydict(),
            JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict(), jq, pq)


@pytest.fixture(scope="module")
def four():
    return _four(ARR)


def test_every_ragged_expression_equals_the_reference_on_both_engines(four):
    dev, cpu, ref, oracle, jq, pq = four
    assert pq.kind == jq.kind == "device"
    assert pq.explain() == jq.explain()
    assert dev == ref
    assert cpu == oracle
    # the reference's own expected values (tests/test_ragged.py)
    assert dev["size"] == [3, 0, None, 3, 1]
    assert dev["has2"] == [True, False, None, None, False]
    assert dev["sd"] == [[3, 2, 1], [], None, [5, -2, None], [7]]


def test_scan_collect_round_trip_on_the_device_path():
    for tbl in (ARR, pa.table({"sa": pa.array([["x", "y"], None, ["z"]],
                                              pa.list_(pa.string()))})):
        q = PSession(device="cpu").from_arrow(tbl).physical()
        jq = JSession().from_arrow(tbl).physical()
        assert q.kind == "device" and q.explain() == jq.explain()
        out = q.collect()
        assert PH.to_arrow(out).to_pydict() == tbl.to_pydict()


def test_a_list_column_round_trips_through_arrow_and_list_column():
    tbl = pa.table({
        "l": pa.array([[1, None], None, [], [4, 5, 6]], pa.list_(pa.int64())),
        "s": pa.array([["b", None], ["a"], None, []], pa.list_(pa.string())),
        "d": pa.array([[1.5], [float("nan"), -0.0], None, []],
                      pa.list_(pa.float64())),
        "t": pa.array([[pa.scalar(0, pa.date32()).as_py()], None, [], None],
                      pa.list_(pa.date32()))})
    hb = PH.from_arrow(tbl)
    assert [c.dtype.simple_string for c in hb.columns] == \
        ["array<bigint>", "array<string>", "array<double>", "array<date>"]
    back = PH.to_arrow(hb)
    assert back.schema == tbl.schema
    assert back.to_pydict().keys() == tbl.to_pydict().keys()
    assert back.column("l").to_pylist() == tbl.column("l").to_pylist()
    assert back.column("s").to_pylist() == tbl.column("s").to_pylist()
    assert back.column("t").to_pylist() == tbl.column("t").to_pylist()
    # a null row holds no value: its span is empty
    l = hb.column_by_name("l")
    assert l.offsets.tolist() == [0, 2, 2, 2, 5]
    # numpy alone (no pyarrow: the card's machine has none)
    elems = PH.from_numpy({"e": (np.array([1, 0, 9, 4, 5, 6]),
                                 np.array([True, False, True, True, True,
                                           True]))},
                          PT.StructType([PT.StructField("e", PT.LONG)]))
    built = PH.list_column(elems.columns[0], [0, 2, 3, 3, 6],
                           np.array([True, False, True, True]))
    assert built.to_pylist() == tbl.column("l").to_pylist()
    assert built.offsets.tolist() == [0, 2, 2, 2, 5]
    assert PH.from_pydict({"l": tbl.column("l").to_pylist()},
                          PT.StructType([PT.StructField(
                              "l", PT.ArrayType(PT.LONG))])) \
        .columns[0].to_pylist() == tbl.column("l").to_pylist()


def test_the_lanes_upload_and_fetch_with_their_layout():
    hb = PH.from_arrow(ARR)
    db = PD.to_device(hb, device="cpu")
    c = db.column_by_name("a")
    assert c.capacity == db.capacity and c.offsets.shape == \
        (db.capacity + 1,)
    assert c.offsets[:6].tolist() == [0, 3, 3, 3, 6, 7]
    # the padding rows are empty spans at the last value
    assert bool((c.offsets[6:] == 7).all())
    assert c.elem_valid[:7].tolist() == [True] * 4 + [False, True, True]
    assert PD.fetch_result_batch(db).to_pydict() == ARR.to_pydict()
    # a row gather moves each row's values (a null row none)
    moved = c.take(torch.tensor([4, 3, 0, 2]),
                   torch.tensor([True, True, True, False]))
    assert moved.offsets.tolist() == [0, 1, 4, 7, 7]
    assert moved.data[:7].tolist() == [7, 5, 0, -2, 1, 2, 3]


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_equals_numpy(side):
    rng = np.random.default_rng(5)
    a = np.sort(rng.integers(-50, 50, 300)).astype(np.int32)
    v = rng.integers(-60, 60, 1000).astype(np.int64)
    got = searchsorted(torch.from_numpy(a), torch.from_numpy(v), side)
    assert got.dtype == torch.int64
    assert got.tolist() == np.searchsorted(a, v, side).tolist()


def _gen_plan(Lm, E, C, table, pos, outer):
    plan = Lm.LogicalGenerate(C.ExplodeGen(E.ColumnRef("a"), pos=pos,
                                           outer=outer),
                              Lm.LogicalScan(table),
                              ["pos", "col"] if pos else ["col"])
    names = ["id", "pos", "col"] if pos else ["id", "col"]
    return Lm.LogicalProject([E.ColumnRef(n) for n in names], plan, names)


def _rows(d):
    return sorted(zip(*d.values()), key=repr)


@pytest.mark.parametrize("pos,outer", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_explode_on_the_device_equals_the_reference(pos, outer):
    jdf = JDF(_gen_plan(JL, JE, JC, ARR, pos, outer), JSession())
    pdf = PDF(_gen_plan(PL, PE, PC, PH.from_arrow(ARR), pos, outer),
              PSession(device="cpu"))
    jq, pq = jdf.physical(), pdf.physical()
    assert pq.kind == "device" and "GenerateExec" in pq.physical_tree()
    assert pq.explain() == jq.explain()
    got = pq.collect().to_pydict()
    assert _rows(got) == _rows(jq.collect().to_pydict())
    assert _rows(PDF(pdf._plan, PSession(ORACLE, device="cpu"))
                 .to_pydict()) == \
        _rows(JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict())


def test_generate_keeps_the_cpu_engine_when_the_parent_reads_the_array():
    def plan(Lm, E, C, table):
        g = Lm.LogicalGenerate(C.ExplodeGen(E.ColumnRef("a")),
                               Lm.LogicalScan(table), ["col"])
        return Lm.LogicalProject([E.ColumnRef("col"), C.Size(
            E.ColumnRef("a"))], g, ["col", "n"])
    jq = JDF(plan(JL, JE, JC, ARR), JSession()).physical()
    pq = PDF(plan(PL, PE, PC, PH.from_arrow(ARR)),
             PSession(device="cpu")).physical()
    assert "CpuGenerateExec" in pq.physical_tree()
    assert pq.explain() == jq.explain()
    assert _rows(pq.collect().to_pydict()) == \
        _rows(jq.collect().to_pydict())


def test_fuzz_device_and_cpu_engine_equal_the_reference():
    rng = np.random.default_rng(11)
    n = 5000
    lists = []
    for _ in range(n):
        if rng.random() < 0.05:
            lists.append(None)
        else:
            lists.append([None if rng.random() < 0.1 else
                          int(rng.integers(-100, 100))
                          for _ in range(rng.integers(0, 9))])
    tbl = pa.table({"id": pa.array(range(n), pa.int64()),
                    "a": pa.array(lists, pa.list_(pa.int64()))})
    dev, cpu, ref, oracle, jq, pq = _four(tbl)
    assert pq.kind == "device"
    assert dev == ref
    assert cpu == oracle


def test_sort_array_over_floats_follows_the_oracle():
    # the reference's device sort_array casts a FLOAT element to an
    # unsigned integer (its `_to_unsigned_comparable`), truncating the
    # value, so 0.5 sorts after -0.0 and -2.25 after 0.5 descending; its
    # CPU oracle orders by value, and the port follows the oracle
    # (ROADMAP Queue 3 item 15)
    tbl = pa.table({"a": pa.array([[1.5, -2.25, 0.5, None, -0.0, 3.0],
                                   [2.5, 1.5]], pa.list_(pa.float32()))})
    for asc, want in ((True, [None, -2.25, -0.0, 0.5, 1.5, 3.0]),
                      (False, [3.0, 1.5, 0.5, -0.0, -2.25, None])):
        jdf = JSession().from_arrow(tbl).select(JC.SortArray(
            JE.ColumnRef("a"), asc), names=["s"])
        pdf = PSession(device="cpu").from_arrow(tbl).select(PC.SortArray(
            PE.ColumnRef("a"), asc), names=["s"])
        got = pdf.to_pydict()
        oracle = JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict()
        assert got == oracle == {"s": [want, [1.5, 2.5] if asc
                                       else [2.5, 1.5]]}
        assert PDF(pdf._plan, PSession(ORACLE, device="cpu")) \
            .to_pydict() == got
        assert jdf.collect().to_pydict()["s"][0] != want


def test_a_ragged_batch_spills_to_host_and_disk_and_comes_back():
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.runtime import memory as M
    from spark_rapids_tpu_torch.exec import compiled as PCOMP
    budget = M.MemoryBudget(TpuConf({}), torch.device("cpu"))
    db = PD.to_device(PH.from_arrow(ARR), device="cpu")
    sp = M.Spillable(db, budget)
    assert budget.live == db.nbytes()
    sp.spill()
    assert sp.on_host and budget.live == 0
    sp.to_disk()
    assert sp.on_disk
    back = sp.get()
    c = back.column_by_name("a")
    assert c.offsets.shape == (back.capacity + 1,)
    assert PD.fetch_result_batch(back).to_pydict() == ARR.to_pydict()
    sp.close()
    # the capture's flattened static inputs carry the lanes too
    tensors, spec = PCOMP._flatten_batch(db)
    again, _ = PCOMP._rebuild_batch(tensors, spec, 0)
    assert PD.fetch_result_batch(again).to_pydict() == ARR.to_pydict()


def test_ragged_batches_concatenate_with_one_dictionary():
    from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
    parts = [PH.from_pydict({"s": [["x", "y"], None, ["z"]],
                             "a": [[1], [], None]}),
             PH.from_pydict({"s": [["b"], ["y", None]], "a": [[2, 3], [4]]})]
    out = concat_batches([PD.to_device(p, device="cpu") for p in parts])
    assert out.column_by_name("s").dictionary.tolist() == ["b", "x", "y",
                                                           "z"]
    assert PD.fetch_result_batch(out).to_pydict() == \
        PH.concat_host(parts).to_pydict()
