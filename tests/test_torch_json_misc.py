"""The JSON functions (plan/json_fns.py) and the misc ids (plan/misc.py)
in the port against the JAX package.

Port copies of tests/test_json_fns_extra.py (from_json PERMISSIVE,
to_json, json_tuple as a projection on the device path and as a
generator on the CPU engine, get_json_object's path subset) and of the
parts of tests/test_misc_exprs.py that need no parquet file
(monotonically_increasing_id, spark_partition_id, input_file_name over
an in-memory source, raise_error), each on both engines of the port
and equal to the reference's device path and CPU oracle; the ids also
under whole-plan capture, equal to the eager run.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import json_fns as JJ
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan import misc as JM
from spark_rapids_tpu.plan import strings as JS
from spark_rapids_tpu.plan.overrides import apply_overrides as japply
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import host as PH
from spark_rapids_tpu_torch.exec import compiled as PCOMP
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import json_fns as PJ
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan import misc as PM
from spark_rapids_tpu_torch.plan import strings as PS
from spark_rapids_tpu_torch.plan.overrides import apply_overrides as papply
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}

JS_TABLE = pa.table({"j": pa.array([
    '{"a": 1, "b": "x", "c": [1,2]}',
    '{"a": 2.5, "b": null}',
    'not json',
    None,
    '{"b": "y", "extra": 9}',
])})


def _schema(T, fields):
    return T.StructType([T.StructField(n, dt(T)) for n, dt in fields])


AB = [("a", lambda T: T.LONG), ("b", lambda T: T.STRING)]
C_ARR = [("c", lambda T: T.ArrayType(T.LONG))]


def _both(build, table=JS_TABLE, conf=None):
    """The port's and the reference's DataFrames of one select."""
    def run(E, J, T, S, session):
        pairs = build(E, J, T, S)
        return session.from_arrow(table).select(
            *[e for _n, e in pairs], names=[n for n, _e in pairs])
    return (run(PE, PJ, PT, PS, PSession(conf, device="cpu")),
            run(JE, JJ, JT, JS, JSession(conf)))


def _answers(pdf, jdf):
    got = pdf.collect().to_pydict()
    cpu = PDF(pdf._plan, PSession(ORACLE, device="cpu")).collect() \
        .to_pydict()
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict()
    return got, cpu, ref, oracle


JSON_CASES = {
    "from_json_permissive": (
        lambda E, J, T, S: [("s", J.FromJson(E.ColumnRef("j"),
                                             _schema(T, AB)))],
        "host", [{"a": 1, "b": "x"}, {"a": None, "b": None},
                 {"a": None, "b": None}, None, {"a": None, "b": "y"}]),
    "from_json_nested_array": (
        lambda E, J, T, S: [("s", J.FromJson(E.ColumnRef("j"),
                                             _schema(T, C_ARR)))],
        "host", [{"c": [1, 2]}, {"c": None}, {"c": None}, None,
                 {"c": None}]),
    "to_json_round_trip": (
        lambda E, J, T, S: [("s", J.ToJson(J.FromJson(E.ColumnRef("j"),
                                                      _schema(T, AB))))],
        "host", ['{"a":1,"b":"x"}', "{}", "{}", None, '{"b":"y"}']),
    "json_tuple_projection": (
        lambda E, J, T, S: list(zip(("a", "b"),
                                    J.json_tuple(E.ColumnRef("j"), "a",
                                                 "b"))),
        "device", None),
    "get_json_object_paths": (
        lambda E, J, T, S: [
            ("c1", J.GetJsonObject(E.ColumnRef("j"), "$.c[1]")),
            ("c", J.GetJsonObject(E.ColumnRef("j"), "$['c']")),
            ("neg", J.GetJsonObject(E.ColumnRef("j"), "$.c[-1]")),
            ("bad", J.GetJsonObject(E.ColumnRef("j"), "c")),
            ("x", J.GetJsonObject(E.ColumnRef("j"), "$.extra"))],
        "device", None),
    "get_json_object_wildcard": (
        lambda E, J, T, S: [("w", J.GetJsonObject(E.ColumnRef("j"),
                                                  "$.c[*]"))],
        "host", None),
}


@pytest.mark.parametrize("case", list(JSON_CASES))
def test_the_json_functions_equal_the_reference(case):
    build, kind, want = JSON_CASES[case]
    pdf, jdf = _both(build)
    pq, jq = pdf.physical(), jdf.physical()
    assert pq.kind == jq.kind == kind
    assert pq.explain() == jq.explain()
    got, cpu, ref, oracle = _answers(pdf, jdf)
    assert got == cpu == ref == oracle
    if want is not None:
        assert list(got.values())[0] == want


def test_json_answers_equal_spark():
    got = _answers(*_both(JSON_CASES["json_tuple_projection"][0]))[0]
    assert got == {"a": ["1", "2.5", None, None, None],
                   "b": ["x", None, None, None, "y"]}
    got = _answers(*_both(JSON_CASES["get_json_object_paths"][0]))[0]
    assert got["c1"] == ["2", None, None, None, None]
    assert got["c"] == ["[1,2]", None, None, None, None]
    assert got["neg"] == got["bad"] == [None] * 5
    assert got["x"] == [None, None, None, None, "9"]
    pq = _both(JSON_CASES["from_json_permissive"][0])[0].physical()
    assert "no device lane" in pq.explain()


def test_the_json_path_parser_equals_the_reference():
    for path in ("$", "$.a", "$.a.b", "$['a'][0]", "$.a[2].b", "$..a",
                 "$.*", "$[*]", "a", "$[-1]", "$[x]", "$[", "$a"):
        assert PJ.parse_json_path(path) == JJ.parse_json_path(path), path


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_the_json_tuple_generator_equals_the_reference(engine):
    conf = ORACLE if engine == "cpu" else None
    pplan = PL.LogicalGenerate(PJ.JsonTupleGen(PE.ColumnRef("j"),
                                               ["a", "b"]),
                               PL.LogicalScan(PH.from_arrow(JS_TABLE)),
                               ["a", "b"])
    jplan = JL.LogicalGenerate(JJ.JsonTupleGen(JE.ColumnRef("j"),
                                               ["a", "b"]),
                               JL.LogicalScan(JS_TABLE), ["a", "b"])
    pq = papply(pplan, PSession(conf, device="cpu").conf, device="cpu")
    jq = japply(jplan)
    assert pq.kind == jq.kind == "host"
    assert pq.explain() == jq.explain() or engine == "cpu"
    got = pq.collect().to_pydict()
    assert got == jq.collect().to_pydict()
    assert got["a"] == ["1", "2.5", None, None, None]
    assert got["b"] == ["x", None, None, None, "y"]
    assert got["j"] == JS_TABLE.column("j").to_pylist()


# ---------------------------------------------------------------------------
# monotonically_increasing_id, spark_partition_id, input_file_name
# ---------------------------------------------------------------------------

BATCHED = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}


def _ids_frames(n, conf, build):
    tbl = pa.table({"x": pa.array(np.arange(n), pa.int64())})
    pdf = PSession({**BATCHED, **(conf or {})}, device="cpu") \
        .from_arrow(tbl)
    jdf = JSession({**BATCHED, **(conf or {})}).from_arrow(tbl)
    return build(PE, PM, pdf), build(JE, JM, jdf)


def _mid(E, M, df):
    return df.select(E.ColumnRef("x"), M.MonotonicallyIncreasingID(),
                     M.SparkPartitionID(), names=["x", "id", "p"])


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_the_ids_equal_the_reference(engine):
    n = 5000
    pdf, jdf = _ids_frames(n, ORACLE if engine == "cpu" else None, _mid)
    pq, jq = pdf.physical(), jdf.physical()
    assert pq.kind == jq.kind == ("cpu" if engine == "cpu" else "device") \
        .replace("cpu", "host")
    got = pq.collect().to_pydict()
    assert got == jq.collect().to_pydict()
    ids, pids = got["id"], got["p"]
    assert len(set(ids)) == n and ids == sorted(ids)
    assert ids[0] >> 33 == 0 and ids[-1] >> 33 >= 1
    assert sorted(set(pids)) == list(range(max(pids) + 1))
    assert max(pids) >= 1
    assert ids == [(p << 33) | (x % 1024) for p, x in zip(pids, got["x"])]


def test_the_ids_capture_and_equal_eager():
    PCOMP.clear_caches()
    n = 3000
    eager = _ids_frames(n, None, _mid)[0].collect().to_pydict()
    pdf = _ids_frames(n, {"spark.rapids.tpu.sql.compile.wholePlan": "ON"},
                      _mid)[0]
    q = pdf.physical()
    for _ in range(2):                      # the capture, then a replay
        out = q.collect(ExecContext(q.conf, q.device)).to_pydict()
        assert out == eager
    assert PCOMP.decision(q) == "whole"


def test_input_file_name_is_empty_for_memory_sources():
    pdf, jdf = _both(lambda E, J, T, S: [
        ("f", __import__(E.__name__.rsplit(".", 1)[0] + ".misc",
                         fromlist=["x"]).InputFileName())])
    assert pdf.physical().kind == jdf.physical().kind == "device"
    got, cpu, ref, oracle = _answers(pdf, jdf)
    assert got == cpu == ref == oracle == {"f": [""] * 5}


def test_input_file_name_nested_goes_to_the_cpu_engine():
    def build(E, J, T, S):
        M = PM if E is PE else JM
        return [("f", S.Upper(M.InputFileName()))]
    pdf, jdf = _both(build)
    pq, jq = pdf.physical(), jdf.physical()
    assert "input_file_name nested" in pq.explain()
    assert pq.explain() == jq.explain()
    got, cpu, ref, oracle = _answers(pdf, jdf)
    assert got == cpu == ref == oracle == {"f": [""] * 5}


@pytest.mark.parametrize("conf", [None, ORACLE])
def test_raise_error_raises(conf):
    tbl = pa.table({"x": pa.array([1], pa.int64())})
    df = PSession(conf, device="cpu").from_arrow(tbl).select(
        PE.RaiseError(PE.Literal("boom")), names=["e"])
    with pytest.raises(RuntimeError, match="boom"):
        df.collect()
