"""The port's pandas execs (spark_rapids_tpu_torch/exec/python_exec.py):
port copies of tests/test_pandas_udf.py, each held against the JAX
package on the same seeded table, plus the port's own cases: the dtypes
and values a user function sees for every simple type with nulls (the
same in both packages), a NaN coming back as null, a worker error and a
dead worker, and the group keys of ROADMAP Queue 3 item 16 (NaN and
null are two groups, as in Spark; the reference merges them)."""
import datetime
import decimal
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.exec.python_exec import PythonWorkerError
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan.aggregates import Sum
from spark_rapids_tpu_torch.session import TpuSession, col

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

TBL = pa.table({"x": pa.array(range(20), pa.int64()),
                "g": pa.array(["a", "b"] * 10)})


def _s():
    return TpuSession(device="cpu")


def _js_types():
    from spark_rapids_tpu import types as JT
    return JT


class TestMapInPandas:
    def test_basic_transform(self):
        schema = t.StructType([t.StructField("y", t.LONG)])

        def double(batches):
            for df in batches:
                yield df.assign(y=df.x * 2)[["y"]]

        out = _s().from_arrow(TBL).map_in_pandas(double, schema).collect()
        assert out.to_pydict()["y"] == [i * 2 for i in range(20)]
        JT = _js_types()
        ref = JSession().from_arrow(TBL).map_in_pandas(
            double, JT.StructType([JT.StructField("y", JT.LONG)])).collect()
        assert out.to_pydict() == ref.to_pydict()

    def test_runs_in_separate_process(self):
        schema = t.StructType([t.StructField("pid", t.LONG)])
        me = os.getpid()

        def pids(batches):
            import pandas as pd
            for df in batches:
                yield pd.DataFrame({"pid": [os.getpid()] * len(df)})

        out = _s().from_arrow(TBL).map_in_pandas(pids, schema).collect()
        assert set(out.to_pydict()["pid"]) != {me}

    def test_worker_error_propagates(self):
        schema = t.StructType([t.StructField("y", t.LONG)])

        def boom(batches):
            for df in batches:
                raise ValueError("kaboom")
                yield df

        with pytest.raises(PythonWorkerError, match="kaboom"):
            _s().from_arrow(TBL).map_in_pandas(boom, schema).collect()

    def test_closure_capture_no_pickling_needed(self):
        schema = t.StructType([t.StructField("y", t.LONG)])
        offset = 100
        out = _s().from_arrow(TBL).map_in_pandas(
            lambda it: (df.assign(y=df.x + offset)[["y"]] for df in it),
            schema).collect()
        assert out.to_pydict()["y"] == [i + 100 for i in range(20)]

    def test_after_device_ops_with_transitions(self):
        """Device filter -> pandas map -> device agg round trip."""
        schema = t.StructType([t.StructField("y", t.LONG)])
        df = (_s().from_arrow(TBL)
              .filter(E.GreaterThanOrEqual(col("x"), E.Literal(10)))
              .map_in_pandas(
                  lambda it: (d.assign(y=d.x * 10)[["y"]] for d in it),
                  schema)
              .agg((Sum(col("y")), "s")))
        q = df.physical()
        tree = q.physical_tree()
        assert "MapInPandasExec" in tree
        assert "DeviceToHostExec" in tree and "HostToDeviceExec" in tree
        out = q.collect()
        assert out.to_pydict()["s"] == [sum(i * 10 for i in range(10, 20))]


class TestArrowEvalPython:
    def test_scalar_pandas_udf(self):
        df = _s().from_arrow(TBL).with_pandas_udf(
            "sq", lambda x: x * x, ["x"], t.LONG)
        out = df.collect().to_pydict()
        assert out["sq"] == [i * i for i in range(20)]
        assert out["x"] == list(range(20))
        JT = _js_types()
        ref = JSession().from_arrow(TBL).with_pandas_udf(
            "sq", lambda x: x * x, ["x"], JT.LONG).collect().to_pydict()
        assert out == ref

    def test_explain_reason(self):
        df = _s().from_arrow(TBL).with_pandas_udf(
            "sq", lambda x: x * x, ["x"], t.LONG)
        JT = _js_types()
        jdf = JSession().from_arrow(TBL).with_pandas_udf(
            "sq", lambda x: x * x, ["x"], JT.LONG)
        assert "python worker process" in df.physical().explain()
        assert df.physical().explain() == jdf.physical().explain()


# ---------------------------------------------------------------------------
# Grouped pandas exec family (reference GpuFlatMapGroupsInPandasExec /
# GpuAggregateInPandasExec / GpuWindowInPandasExec)
# ---------------------------------------------------------------------------

def _grouped_table(n=200):
    rng = np.random.default_rng(5)
    return pa.table({
        "g": pa.array(rng.integers(0, 6, n), pa.int64()),
        "x": pa.array(rng.standard_normal(n)),
        "y": pa.array(rng.integers(0, 100, n), pa.int64()),
    })


def _ref_schema(schema):
    JT = _js_types()
    return JT.StructType([JT.StructField(f.name, getattr(
        JT, type(f.data_type).__name__.replace("Type", "").upper()
        .replace("INTEGER", "INT")))
        for f in schema.fields])


def test_apply_in_pandas_matches_pandas_oracle():
    tbl = _grouped_table()

    def center(df):
        out = df.copy()
        out["x"] = df["x"] - df["x"].mean()
        return out

    schema = t.StructType([t.StructField("g", t.LONG),
                           t.StructField("x", t.DOUBLE),
                           t.StructField("y", t.LONG)])
    got = _s().from_arrow(tbl).group_by("g").apply_in_pandas(center, schema) \
        .collect()
    ref = JSession().from_arrow(tbl).group_by("g").apply_in_pandas(
        center, _ref_schema(schema)).collect()
    assert got.to_pydict() == ref.to_pydict()
    import pandas as pd
    got = pd.DataFrame(got.to_pydict()).sort_values(["g", "y", "x"])
    want = tbl.to_pandas().groupby("g", group_keys=False)[["g", "x", "y"]] \
        .apply(center).sort_values(["g", "y", "x"])
    assert np.allclose(got["x"].to_numpy(), want["x"].to_numpy())
    assert got["y"].tolist() == want["y"].tolist()


def test_agg_in_pandas_udaf():
    tbl = _grouped_table()

    def wmean(x, y):
        import numpy as _np
        return float(_np.average(x, weights=y + 1))

    got = _s().from_arrow(tbl).group_by("g").agg_in_pandas(
        (wmean, ["x", "y"], "wm", t.DOUBLE)).collect().to_pydict()
    JT = _js_types()
    ref = JSession().from_arrow(tbl).group_by("g").agg_in_pandas(
        (wmean, ["x", "y"], "wm", JT.DOUBLE)).collect().to_pydict()
    assert got == ref
    df = tbl.to_pandas()
    want = df.groupby("g").apply(
        lambda sub: float(np.average(sub["x"], weights=sub["y"] + 1)),
        include_groups=False).sort_index()
    assert got["g"] == want.index.tolist()
    assert np.allclose(got["wm"], want.to_numpy())


def test_window_in_pandas_rank_and_scalar():
    tbl = _grouped_table()

    def frac_of_max(x):
        return x / x.max()

    got = _s().from_arrow(tbl).with_window_pandas_udf(
        "fr", frac_of_max, ["x"], t.DOUBLE,
        partition_by=["g"], order_by=["y"]).collect().to_pydict()
    JT = _js_types()
    ref = JSession().from_arrow(tbl).with_window_pandas_udf(
        "fr", frac_of_max, ["x"], JT.DOUBLE,
        partition_by=["g"], order_by=["y"]).collect().to_pydict()
    assert got == ref
    import pandas as pd
    df = tbl.to_pandas()
    want = df.sort_values(["g", "y"], kind="stable").reset_index(drop=True)
    want["fr"] = want.groupby("g")["x"].transform(lambda x: x / x.max())
    got = pd.DataFrame(got).sort_values(["g", "y"], kind="stable") \
        .reset_index(drop=True)
    assert np.allclose(got["fr"].to_numpy(), want["fr"].to_numpy())
    assert got["x"].tolist() == want["x"].tolist()


def test_agg_in_pandas_null_keys_grouped():
    tbl = pa.table({
        "g": pa.array([1, None, 1, None, 2], pa.int64()),
        "x": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    })
    got = _s().from_arrow(tbl).group_by("g").agg_in_pandas(
        (lambda x: float(x.sum()), ["x"], "sx", t.DOUBLE)).collect() \
        .to_pydict()
    m = {None if g is None or g != g else int(g): v
         for g, v in zip(got["g"], got["sx"])}
    assert m == {1: 4.0, 2: 5.0, None: 6.0}
    JT = _js_types()
    ref = JSession().from_arrow(tbl).group_by("g").agg_in_pandas(
        (lambda x: float(x.sum()), ["x"], "sx", JT.DOUBLE)).collect() \
        .to_pydict()
    assert got == ref


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------

D = decimal.Decimal
UTC = datetime.timezone.utc
SIMPLE = pa.table({
    "i8": pa.array([1, None, 3], pa.int8()),
    "i32": pa.array([1, 2, 3], pa.int32()),
    "i32n": pa.array([1, None, 3], pa.int32()),
    "i64n": pa.array([None, 5, 6], pa.int64()),
    "b": pa.array([True, False, True]),
    "bn": pa.array([True, None, False]),
    "f": pa.array([1.5, None, -0.0], pa.float32()),
    "d": pa.array([1.5, None, float("nan")]),
    "s": pa.array(["a", None, "ccc"]),
    "dt": pa.array([datetime.date(2020, 1, 1), None,
                    datetime.date(1969, 12, 31)]),
    "dec": pa.array([D("1.20"), None, D("-3.45")], pa.decimal128(10, 2)),
    "ts": pa.array([datetime.datetime(2020, 1, 1, 12, tzinfo=UTC), None,
                    datetime.datetime(1960, 5, 5, tzinfo=UTC)],
                   pa.timestamp("us", tz="UTC")),
})


def _seen(batches):
    """Record, per column, the dtype and the values a function sees."""
    import pandas as pd
    for df in batches:
        rows = [(c, str(df[c].dtype), repr(df[c].tolist()),
                 type(df.index).__name__) for c in df.columns]
        yield pd.DataFrame({"c": [r[0] for r in rows],
                            "dtype": [r[1] for r in rows],
                            "vals": [r[2] for r in rows],
                            "index": [r[3] for r in rows]})


def test_frames_a_function_sees_match_the_reference():
    """Every simple type with nulls reaches the user's function with the
    dtype and the values pyarrow's to_pandas gives the reference."""
    schema = t.StructType([t.StructField(n, t.STRING)
                           for n in ("c", "dtype", "vals", "index")])
    got = _s().from_arrow(SIMPLE).map_in_pandas(_seen, schema).collect()
    JT = _js_types()
    jschema = JT.StructType([JT.StructField(n, JT.STRING)
                             for n in ("c", "dtype", "vals", "index")])
    ref = JSession().from_arrow(SIMPLE).map_in_pandas(_seen, jschema) \
        .collect()
    assert got.to_pydict() == ref.to_pydict()
    d = dict(zip(got.to_pydict()["c"], got.to_pydict()["dtype"]))
    assert d["i8"] == "float64" and d["i32"] == "int32"
    assert d["bn"] == "object" and d["f"] == "float32"
    assert d["ts"] == "datetime64[us, UTC]" and d["dec"] == "object"


def test_values_come_back_by_the_declared_types():
    """Every simple type round-trips through a function that returns
    its frame: NaN in a float column comes back null, as the
    reference's from_pandas makes it."""
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    schema = from_arrow(SIMPLE).schema
    got = _s().from_arrow(SIMPLE).map_in_pandas(
        lambda it: (df for df in it), schema).collect().to_pydict()
    JT = _js_types()
    from spark_rapids_tpu.columnar.host import schema_to_struct
    ref = JSession().from_arrow(SIMPLE).map_in_pandas(
        lambda it: (df for df in it), schema_to_struct(SIMPLE.schema)) \
        .collect().to_pydict()
    assert got == ref
    assert got["d"] == [1.5, None, None]        # NaN -> null
    assert got["dec"] == [D("1.20"), None, D("-3.45")]


def test_nan_returned_by_a_function_is_null():
    df = _s().from_arrow(TBL).with_pandas_udf(
        "h", lambda x: (x - 10) / (x - 10) * 0.5, ["x"], t.DOUBLE)
    out = df.collect().to_pydict()["h"]
    assert out[10] is None and out[0] == 0.5


def test_a_float_truncated_to_an_integer_raises():
    df = _s().from_arrow(TBL).with_pandas_udf(
        "h", lambda x: x / 4, ["x"], t.LONG)
    with pytest.raises(PythonWorkerError, match="truncated"):
        df.collect()


def test_worker_error_in_grouped_exec():
    def bad(df):
        raise KeyError("no such thing")
    df = _s().from_arrow(TBL).group_by("g").apply_in_pandas(
        bad, t.StructType([t.StructField("x", t.LONG)]))
    with pytest.raises(PythonWorkerError, match="no such thing"):
        df.collect()


def test_a_dead_worker_raises():
    def die(batches):
        for _df in batches:
            os._exit(3)
        yield from ()
    df = _s().from_arrow(TBL).map_in_pandas(
        die, t.StructType([t.StructField("x", t.LONG)]))
    with pytest.raises(PythonWorkerError, match="died"):
        df.collect()


def test_a_missing_result_column_raises():
    df = _s().from_arrow(TBL).map_in_pandas(
        lambda it: (d[["x"]] for d in it),
        t.StructType([t.StructField("nope", t.LONG)]))
    with pytest.raises(PythonWorkerError, match="nope"):
        df.collect()


def test_workers_are_counted_and_bounded():
    from spark_rapids_tpu_torch.config import HONOURED_KEYS, \
        PYTHON_WORKER_CONCURRENCY
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    assert PYTHON_WORKER_CONCURRENCY.key in HONOURED_KEYS
    q = _s().from_arrow(TBL).with_pandas_udf(
        "sq", lambda x: x * x, ["x"], t.LONG).physical()
    ctx = ExecContext(q.conf, q.device)
    q.collect(ctx)
    assert ctx.metrics["python_workers_started"] == 1
    assert ctx.metrics["python_wire_out_bytes"] > 0
    assert ctx.metrics["python_wire_in_bytes"] > 0


def test_chained_pandas_execs_share_one_permit(monkeypatch):
    """Two streaming pandas execs, the inner one run by the outer one's
    feeder thread, with one python-worker permit: the query holds one
    permit for both (ROADMAP Queue 3 item 19: the reference takes one a
    worker, so the inner exec waits for the permit its outer exec
    holds, for ever), and gives it back at the end."""
    import threading
    from spark_rapids_tpu_torch.exec import python_exec as PE
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    monkeypatch.setattr(PE, "_WORKER_SEM", None)
    s = TpuSession({"spark.rapids.tpu.python.concurrentPythonWorkers": 1},
                   device="cpu")
    schema = t.StructType([t.StructField("x", t.LONG),
                           t.StructField("z", t.LONG)])
    q = s.from_arrow(TBL).with_pandas_udf(
        "y", lambda x: x + 1, ["x"], t.LONG).with_pandas_udf(
        "sq", lambda y: y * y, ["y"], t.LONG).map_in_pandas(
        lambda it: (d.assign(z=d.sq - d.y)[["x", "z"]] for d in it),
        schema).physical()
    ctx = ExecContext(q.conf, q.device)
    out = {}
    runner = threading.Thread(target=lambda: out.update(
        got=q.collect(ctx).to_pydict()), daemon=True)
    runner.start()
    runner.join(timeout=60)
    assert not runner.is_alive(), "the chained pandas execs deadlocked"
    assert out["got"] == {"x": list(range(20)),
                          "z": [(i + 1) * i for i in range(20)]}
    assert ctx.metrics["python_workers_started"] == 3
    assert ctx.python_permit_depth == 0
    sem = PE._WORKER_SEM
    assert sem.acquire(blocking=False)
    sem.release()


NAN_NULL = pa.table({"g": pa.array([1.0, None, float("nan"), None,
                                    float("nan")]),
                     "x": pa.array([1, 2, 3, 4, 5], pa.int64())})


def test_nan_and_null_keys_are_separate_groups():
    """ROADMAP Queue 3 item 16: Spark groups in the JVM, where NaN is one
    key and null another: three groups.  The reference groups with
    pandas after to_pandas, where a null DOUBLE is NaN: two."""
    got = _s().from_arrow(NAN_NULL).group_by("g").agg_in_pandas(
        (lambda x: float(x.sum()), ["x"], "sx", t.DOUBLE)).collect() \
        .to_pydict()
    rows = list(zip(got["g"], got["sx"]))
    assert len(rows) == 3
    assert rows[0] == (1.0, 1.0)
    assert rows[1][0] != rows[1][0] and rows[1][1] == 8.0    # NaN
    assert rows[2] == (None, 6.0)
    JT = _js_types()
    ref = JSession().from_arrow(NAN_NULL).group_by("g").agg_in_pandas(
        (lambda x: float(x.sum()), ["x"], "sx", JT.DOUBLE)).collect() \
        .to_pydict()
    assert list(zip(ref["g"], ref["sx"])) == [(1.0, 1.0), (None, 14.0)]


def test_nan_and_null_rows_reach_apply_in_pandas_as_two_frames():
    import pandas as pd

    def sizes(df):
        return pd.DataFrame({"n": [len(df)], "xs": [int(df["x"].sum())]})

    got = _s().from_arrow(NAN_NULL).group_by("g").apply_in_pandas(
        sizes, t.StructType([t.StructField("n", t.LONG),
                             t.StructField("xs", t.LONG)])).collect()
    assert got.to_pydict() == {"n": [1, 2, 2], "xs": [1, 8, 6]}


def test_negative_zero_groups_with_zero():
    tbl = pa.table({"g": pa.array([0.0, -0.0, 1.0]),
                    "x": pa.array([1, 2, 3], pa.int64())})
    got = _s().from_arrow(tbl).group_by("g").agg_in_pandas(
        (lambda x: int(x.sum()), ["x"], "sx", t.LONG)).collect().to_pydict()
    assert got["sx"] == [3, 3]


def test_cogroup_pairs_nan_and_null_apart():
    import pandas as pd
    left = pa.table({"k": pa.array([1.0, float("nan"), None]),
                     "v": pa.array([1, 2, 3], pa.int64())})
    right = pa.table({"k": pa.array([None, float("nan"), 2.0]),
                      "w": pa.array([10, 20, 30], pa.int64())})

    def pair(l, r):
        return pd.DataFrame({"v": [int(l["v"].sum())],
                             "w": [int(r["w"].sum())]})

    s = _s()
    out = (s.from_arrow(left).group_by("k")
           .cogroup(s.from_arrow(right).group_by("k"))
           .apply_in_pandas(pair, t.StructType([t.StructField("v", t.LONG),
                                                t.StructField("w", t.LONG)]))
           .collect().to_pydict())
    # keys 1.0, 2.0, NaN, null: numbers first, then NaN, then null
    assert list(zip(out["v"], out["w"])) == [(1, 0), (0, 30), (2, 20),
                                              (3, 10)]
