"""Encoded execution in the port (ops/encodings.py, `sql.encoded.*`)
against the JAX package.

Ports of tests/test_encodings.py's cases: the policy and its
discriminant, the dictionary helpers, the narrowed upload, the narrow
dtype and exact-width rules, the code-space predicate sweep (ordered and
unordered dictionaries, null codes, all-null columns, a computed
dictionary with repeats), narrow comparisons and arithmetic at the
dtypes' edges, dictionary-key joins of every type, the legality pass,
the remap cache and the off switch.  Each query runs the port (CPU
tensors) with encoded execution on and off, and both must equal the
JAX package's device path and its CPU oracle as sorted row sets, as the
reference's tests compare them.

Waiting for other slices: the reference's
`test_scan_upload_cache_keys_by_encoding` and the program half of
`test_off_switch_programs_and_results_identical` read whole-plan
compiled programs (ROADMAP Queue 1 item 5), and
`test_metrics_families_populate` the metrics registry (item 10); here
the policy's discriminant, the narrowed-lane cache and the `ctx.metrics`
counters (`encoded_dispatch.<site>.<outcome>`,
`encoded_decode_bytes.<site>`) stand in for them.

Added: the narrow-lane sweep.  Every binary arithmetic, comparison, IN,
CASE / IF / COALESCE, cast and DECIMAL rescale class over narrowed
int8, int16 and int32 lanes whose values sit at their dtypes' edges,
against Python literals outside those ranges, must be bit-equal to the
same plan with `encoded.narrow.lanes=OFF`; and three PyTorch behaviours
that would wrap a narrow lane are pinned, beside the port's answer.
"""
import datetime as pydt
import decimal as pydec
import threading
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import encodings as JENC
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan.strings import Substring as JSubstring
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import device as PD
from spark_rapids_tpu_torch.columnar.host import (HostBatch, HostColumn,
                                                  from_arrow)
from spark_rapids_tpu_torch.exec.plan import ExecContext, HostScanExec
from spark_rapids_tpu_torch.ops import encodings as ENC
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan.strings import Substring as PSubstring
from spark_rapids_tpu_torch.session import TpuSession as PSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

OFF = {"spark.rapids.tpu.sql.encoded.execution.enabled": "false"}
NARROW_OFF = {"spark.rapids.tpu.sql.encoded.narrow.lanes": "OFF"}
CPU = {"spark.rapids.tpu.sql.enabled": "false"}


def _cell(x):
    if x is None:
        return (2, "")
    if isinstance(x, float) and x != x:
        return (1, "nan")
    return (0, repr(x))


def _rows(d: dict):
    names = sorted(d)
    return sorted(zip(*(tuple(_cell(x) for x in d[n]) for n in names))) \
        if names else []


def _port_run(build, conf):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = PSession(conf, device="cpu")
    q = build(s, PE, PA).physical()
    ctx = ExecContext(q.conf, q.device)
    return q.collect(ctx), ctx


def run_three_ways(build, extra_on=None):
    """port (encoded on) == port (encoded off) == the reference's device
    path == its CPU oracle; -> the port's on-run ExecContext."""
    jdf = build(JSession(), JE, JA)
    want = _rows(jdf.collect().to_pydict())
    oracle = _rows(JDF(jdf._plan, JSession(CPU)).collect().to_pydict())
    got_on, ctx = _port_run(build, dict(extra_on or {}))
    got_off, _ = _port_run(build, OFF)
    assert _rows(got_on.to_pydict()) == want, "encoded-on vs reference"
    assert _rows(got_off.to_pydict()) == want, "encoded-off vs reference"
    assert want == oracle, "the reference's device path vs its oracle"
    return ctx


def str_table(n=3000, seed=11, with_nulls=True):
    rng = np.random.default_rng(seed)
    words = ["apple", "pear", "zed", "banana", "kiwi", "melon", "apple2",
             "", "a", "zz"]
    vals = [words[i] for i in rng.integers(0, len(words), n)]
    if with_nulls:
        for i in rng.integers(0, n, n // 10):
            vals[i] = None
    return pa.table({
        "s": pa.array(vals, pa.string()),
        "x": pa.array(rng.integers(-120, 120, n), pa.int64()),
        "y": pa.array(rng.integers(0, 60, n), pa.int32()),
        "d": pa.array(rng.integers(8000, 11000, n).astype(np.int32),
                      pa.date32()),
    })


# ---------------------------------------------------------------------------
# the policy and the host-side helpers
# ---------------------------------------------------------------------------

def test_policy_resolution_and_discriminant():
    on = PSession(device="cpu").conf
    off = PSession(OFF, device="cpu").conf
    pol = ENC.encoding_policy(on)
    assert pol.enabled and pol.dict_predicates and pol.dict_sort_scan \
        and pol.narrow_lanes and pol.in_max_codes == 16
    assert ENC.encoding_discriminant(on) == JENC.encoding_discriminant(
        JSession().conf) is not None
    assert ENC.encoding_policy(off) is ENC.NO_ENCODING
    assert ENC.encoding_discriminant(off) is None
    narrow_off = PSession(NARROW_OFF, device="cpu").conf
    assert not ENC.encoding_policy(narrow_off).narrow_lanes
    # two resolved policies that differ never share a discriminant
    assert ENC.encoding_discriminant(narrow_off) != \
        ENC.encoding_discriminant(on)


@pytest.mark.parametrize("entries,ordered,unique", [
    (["a", "b", "d", "z"], True, True), (["d", "a", "z", "b"], False, True),
    (["a", "a", "b"], False, False), ([], True, True)])
def test_ordered_unique_literal_code_rank_bounds(entries, ordered, unique):
    d = np.array(entries, str)
    ref = pa.array(entries, pa.string())
    assert ENC.is_ordered_dict(d) == JENC.is_ordered_dict(ref) == ordered
    assert ENC.is_unique_dict(d) == JENC.is_unique_dict(ref) == unique
    for v in ("a", "b", "c", "d", "z", "zz", ""):
        if unique:
            assert ENC.literal_code(d, v) == JENC.literal_code(ref, v)
        assert ENC.rank_bounds(d, v) == JENC.rank_bounds(ref, v)
    if unique:
        assert list(ENC.rank_table(d)) == list(JENC.rank_table(ref))


def test_literal_code_and_rank_bounds_values():
    d = np.array(["a", "b", "d", "z"], str)
    assert ENC.literal_code(d, "d") == 2
    assert ENC.literal_code(d, "c") == ENC.ABSENT_CODE
    assert ENC.rank_bounds(d, "c") == (2, 2)
    assert ENC.rank_bounds(d, "b") == (1, 2)
    assert list(ENC.rank_table(np.array(["d", "a", "z", "b"], str))) == \
        [2, 0, 3, 1]


def test_sorted_dictionary_upload_is_order_preserving():
    values = ["pear", "apple", None, "zed", "apple"]
    arr = pa.array(values, pa.string())
    codes, d = ENC.sort_dictionary_encode(
        np.array([v or "" for v in values], str),
        np.array([v is not None for v in values]))
    jcodes, jd, _ = JENC.sort_dictionary_encode(arr)
    assert list(d) == jd.to_pylist() == ["apple", "pear", "zed"]
    valid = np.array([v is not None for v in values])
    assert codes[valid].tolist() == jcodes[valid].tolist()
    # the port's host columns carry sorted dictionaries already: the
    # upload keeps them, and the codes are ranks
    hb = from_arrow(pa.table({"s": arr}))
    db = PD.to_device(hb, device="cpu")
    c = db.columns[0]
    assert ENC.is_ordered_dict(c.dictionary)
    assert PD.to_host(db, db.num_rows).to_pydict()["s"] == values


def test_narrow_upload_value_preserving_and_negotiated():
    hb = from_arrow(pa.table({"x": pa.array([5, -3, None, 120],
                                            pa.int64())}))
    db = PD.to_device(hb, device="cpu")                  # un-negotiated
    assert db.columns[0].data.dtype == torch.int64
    lane = PD.narrowed_lane(hb, "x", 0, 4)
    assert lane[0].dtype == np.int8 and lane[1:] == (-3, 120)
    assert PD.narrowed_lane(hb, "x", 0, 4) is lane        # cached
    PD.reset_upload_counts()
    db_n = PD.to_device(hb, device="cpu", narrowed={0: lane})
    c = db_n.columns[0]
    assert isinstance(c, PD.NarrowColumn) and c.lane.dtype == torch.int8
    assert c.enc == ("for", -3, 120)
    assert PD.UPLOADS["bytes"] == 4 + 4          # int8 values, validity
    # readers see the logical storage dtype, values exact
    assert c.data.dtype == torch.int64 and c.data_dtype == torch.int64
    assert PD.to_host(db_n, 4).to_pydict()["x"] == [5, -3, None, 120]
    assert db_n.nbytes() < db.nbytes()


@pytest.mark.parametrize("lo,hi,base,want", [
    (-3, 120, np.int64, np.int8), (0, 300, np.int64, np.int16),
    (-2 ** 40, 5, np.int64, None), (0, 5, np.float64, None),
    (-40000, 40000, np.int64, np.int32), (0, 70, np.int32, np.int8),
    (0, 300, np.int16, None), (-128, 127, np.int16, np.int8)])
def test_narrow_dtype_rule(lo, hi, base, want):
    got = ENC.narrow_np_dtype(lo, hi, np.dtype(base))
    ref = JENC.narrow_np_dtype(lo, hi, np.dtype(base))
    assert got == ref and (got is None if want is None else got == want)


@pytest.mark.parametrize("a,b,op,logical", [
    ("int16", "int16", "add", "int64"), ("int32", "int32", "mul", "int64"),
    ("int8", "int16", "mul", "int64"), ("int8", "int8", "mul", "int32"),
    ("int16", "int16", "mul", "int32"), ("int8", "int8", "add", "int16"),
    ("int32", "int8", "add", "int64")])
def test_exact_arith_rule(a, b, op, logical):
    got = ENC.exact_arith_dtype(getattr(torch, a), getattr(torch, b), op,
                                getattr(torch, logical))
    ref = JENC.exact_arith_dtype(np.dtype(a), np.dtype(b), op,
                                 np.dtype(logical))
    assert (got is None) == (ref is None)
    if got is not None:
        assert str(got).replace("torch.", "") == np.dtype(ref).name


# ---------------------------------------------------------------------------
# code-space dictionary predicates
# ---------------------------------------------------------------------------

PREDICATES = [
    lambda E, c: E.EqualTo(c("s"), E.Literal("pear")),
    lambda E, c: E.EqualTo(E.Literal("apple"), c("s")),
    lambda E, c: E.NotEqual(c("s"), E.Literal("kiwi")),
    lambda E, c: E.EqualNullSafe(c("s"), E.Literal("zed")),
    lambda E, c: E.EqualTo(c("s"), E.Literal("missing")),
    lambda E, c: E.In(c("s"), ["pear", "zed", "missing"]),
    lambda E, c: E.In(c("s"), ["pear", None]),
    lambda E, c: E.LessThan(c("s"), E.Literal("kiwi")),
    lambda E, c: E.LessThanOrEqual(c("s"), E.Literal("kiwi")),
    lambda E, c: E.GreaterThan(c("s"), E.Literal("b")),
    lambda E, c: E.GreaterThanOrEqual(E.Literal("melon"), c("s")),
    lambda E, c: E.LessThan(c("s"), E.Literal("")),
    lambda E, c: E.GreaterThan(c("s"), E.Literal("zzzz")),
]


def _filter(table, mk):
    def build(s, E, _A):
        return s.from_arrow(table).filter(mk(E, E.ColumnRef))
    return build


@pytest.mark.parametrize("i", range(len(PREDICATES)))
def test_dict_predicates_oracle(i):
    ctx = run_three_ways(_filter(str_table(), PREDICATES[i]))
    m = ctx.metrics
    assert any(k.startswith("encoded_dispatch.") and k.endswith(".encoded")
               for k in m), m


@pytest.mark.parametrize("i", [0, 5, 7, 10])
def test_dict_predicates_off_take_the_decode_rung(i):
    """`dict.predicates=OFF`: the per-entry tables gathered by code,
    counted as decode bytes; the rows are the same."""
    ctx = run_three_ways(_filter(str_table(), PREDICATES[i]),
                         {"spark.rapids.tpu.sql.encoded.dict.predicates":
                          "OFF"})
    assert any(k.startswith("encoded_decode_bytes.")
               for k in ctx.metrics), ctx.metrics


def _unordered_host_table():
    """str_table's strings over an unsorted dictionary (a mid-plan
    dictionary's order), with the same values."""
    t = str_table()
    vals = t.column("s").to_pylist()
    d = np.array(["zed", "apple", "pear", "", "kiwi", "banana", "zz",
                  "melon", "a", "apple2"], str)
    pos = {v: i for i, v in enumerate(d)}
    codes = np.array([pos[v] if v is not None else 0 for v in vals],
                     np.int32)
    valid = np.array([v is not None for v in vals])
    hb = from_arrow(t.drop(["s"]))
    return t, HostBatch([HostColumn(codes, valid, PT.STRING, d)] +
                        hb.columns, ["s"] + hb.names)


@pytest.mark.parametrize("i", [0, 2, 6, 7, 8, 9, 10, 11])
def test_dict_predicates_unordered_dictionary(i):
    """An unordered dictionary takes the rank-table rung for ranges and
    code equality for = and IN: the rows equal the reference's over the
    same values."""
    table, hb = _unordered_host_table()
    assert not ENC.is_ordered_dict(hb.columns[0].dictionary)
    jdf = _filter(table, PREDICATES[i])(JSession(), JE, JA)
    want = _rows(jdf.collect().to_pydict())
    for conf in ({}, OFF):
        def build(s, E, _A):
            return s.from_host(hb).filter(PREDICATES[i](E, E.ColumnRef))
        got, ctx = _port_run(build, conf)
        assert _rows(got.to_pydict()) == want
        if not conf and i >= 7:
            assert ctx.metrics.get(
                "encoded_decode_bytes.predicate_range", 0) > 0


def test_dict_predicates_all_null_column():
    tbl = pa.table({"s": pa.array([None, None, None], pa.string()),
                    "x": pa.array([1, 2, 3], pa.int64())})
    for mk in (lambda E, c: E.EqualTo(c("s"), E.Literal("a")),
               lambda E, c: E.LessThan(c("s"), E.Literal("a")),
               lambda E, c: E.In(c("s"), ["a", "b"])):
        run_three_ways(_filter(tbl, mk))


@pytest.mark.parametrize("pred", ["in", "eq"])
def test_duplicate_value_dictionary_falls_back(pred):
    """A computed dictionary can repeat values (a substring prefix):
    code equality must not engage, and the rows stay exact."""
    tbl = str_table(with_nulls=False)

    def build(s, E, _A):
        sub = PSubstring if E is PE else JSubstring
        c = E.ColumnRef
        df = s.from_arrow(tbl).select(E.Alias(sub(c("s"), 1, 1), "p"),
                                      c("x"), names=["p", "x"])
        cond = E.In(c("p"), ["a", "z"]) if pred == "in" \
            else E.EqualTo(c("p"), E.Literal("a"))
        return df.filter(cond)
    run_three_ways(build)


# ---------------------------------------------------------------------------
# FOR-narrowed lanes: comparisons and arithmetic at the edges
# ---------------------------------------------------------------------------

def narrow_edge_table():
    xs = [127, -128, 126, -127, 0, 1, -1, 100, -100, None] * 20
    ys = [32767, -32768, 1000, -1000, 0, 7, -7, 32000, -32000, None] * 20
    return pa.table({"a": pa.array(xs, pa.int64()),
                     "b": pa.array(ys, pa.int64())})


NARROW_PREDICATES = [
    lambda E, c: E.LessThan(c("a"), E.Literal(5)),
    lambda E, c: E.LessThan(c("a"), E.Literal(1000)),     # above int8
    lambda E, c: E.GreaterThan(c("a"), E.Literal(-1000)),  # below int8
    lambda E, c: E.EqualTo(c("a"), E.Literal(-128)),
    lambda E, c: E.GreaterThanOrEqual(c("b"), E.Literal(32767)),
    lambda E, c: E.NotEqual(c("b"), E.Literal(123456)),   # out of range
    lambda E, c: E.LessThan(c("a"), c("b")),              # narrow/narrow
    lambda E, c: E.In(c("a"), [127, -128, 5000]),
]


@pytest.mark.parametrize("i", range(len(NARROW_PREDICATES)))
def test_narrow_compare_oracle(i):
    ctx = run_three_ways(_filter(narrow_edge_table(), NARROW_PREDICATES[i]))
    m = ctx.metrics
    assert m.get("encoded_dispatch.narrow_upload.encoded", 0) > 0
    assert m.get("encoded_dispatch.predicate_narrow.encoded", 0) + \
        m.get("encoded_dispatch.in_narrow.encoded", 0) > 0


def test_narrow_arith_overflow_edge_oracle():
    """int8 + int8, int8 - int16 and int8 x int16 at the dtypes'
    extremes: the exact-width narrow arithmetic equals the wide path and
    the oracle exactly."""
    def build(s, E, _A):
        c = E.ColumnRef
        return s.from_arrow(narrow_edge_table()).select(
            E.Alias(E.Add(c("a"), c("a")), "aa"),
            E.Alias(E.Subtract(c("a"), c("b")), "ab"),
            E.Alias(E.Multiply(c("a"), c("b")), "m"),
            names=["aa", "ab", "m"])
    ctx = run_three_ways(build)
    assert ctx.metrics.get("encoded_dispatch.arith_narrow.encoded", 0) > 0


def test_narrow_date_predicate_oracle():
    run_three_ways(_filter(str_table(), lambda E, c: E.LessThanOrEqual(
        c("d"), E.Literal(pydt.date(1995, 6, 1)))))


# ---------------------------------------------------------------------------
# dictionary-key joins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ("inner", "left_outer", "right_outer",
                                 "full_outer", "left_semi", "left_anti"))
def test_dict_key_joins_oracle(how):
    rng = np.random.default_rng(31)
    keys = ["k%02d" % i for i in range(40)]
    left = pa.table({
        "lk": pa.array([keys[i] for i in rng.integers(0, 40, 500)]
                       + [None] * 10, pa.string()),
        "lv": pa.array(rng.integers(0, 1000, 510), pa.int64())})
    # the build side misses some keys, adds strangers and duplicates
    rk = [keys[i] for i in rng.integers(0, 30, 60)] + ["zzz", None]
    right = pa.table({
        "rk": pa.array(rk, pa.string()),
        "rv": pa.array(rng.integers(0, 1000, len(rk)), pa.int64())})
    run_three_ways(lambda s, E, A: s.from_arrow(left).join(
        s.from_arrow(right), left_on=["lk"], right_on=["rk"], how=how))


def test_dict_key_join_with_code_space_predicate():
    rng = np.random.default_rng(37)
    keys = ["k%02d" % i for i in range(25)]
    fact = pa.table({
        "fk": pa.array([keys[i] for i in rng.integers(0, 25, 800)],
                       pa.string()),
        "v": pa.array(rng.integers(0, 100, 800), pa.int64())})
    dim = pa.table({
        "k": pa.array(keys, pa.string()),
        "name": pa.array(["n_" + k for k in keys], pa.string())})

    def build(s, E, A):
        c = E.ColumnRef
        return (s.from_arrow(fact)
                .filter(E.GreaterThanOrEqual(c("fk"), E.Literal("k05")))
                .join(s.from_arrow(dim), left_on=["fk"], right_on=["k"],
                      how="inner")
                .group_by("name")
                .agg((A.Count(None), "n"), (A.Sum(c("v")), "sv"))
                .sort("name"))
    run_three_ways(build)


# ---------------------------------------------------------------------------
# the legality pass, the cache, the off switch and the counters
# ---------------------------------------------------------------------------

def _scans(node, out=None):
    out = [] if out is None else out
    if isinstance(node, HostScanExec):
        out.append(node)
    for c in node.children:
        _scans(c, out)
    return out


def test_negotiate_encoded_marks_scans():
    from spark_rapids_tpu_torch.plan.window import RowNumber
    tbl = pa.table({"x": pa.array(list(range(100)), pa.int64()),
                    "g": pa.array(["a", "b"] * 50, pa.string())})
    s = PSession(device="cpu")
    q = s.from_arrow(tbl).filter(
        PE.GreaterThan(PE.ColumnRef("x"), PE.Literal(5))).physical()
    assert all(sc.encoded_cols for sc in _scans(q.root))
    # a window is outside the list: its scan stays full width
    qw = s.from_arrow(tbl).window(
        [(RowNumber(), "rn")], partition_by=["g"],
        order_by=[("x", True, True)]).physical()
    assert all(sc.encoded_cols is None for sc in _scans(qw.root))
    for conf in (OFF, NARROW_OFF):
        q = PSession(conf, device="cpu").from_arrow(tbl).filter(
            PE.GreaterThan(PE.ColumnRef("x"), PE.Literal(5))).physical()
        assert all(sc.encoded_cols is None for sc in _scans(q.root))


def test_narrowed_lanes_are_computed_once_a_slice():
    """The scan's narrowed host lanes are cached beside the table's
    statistics, per (column, slice): a warm query narrows nothing."""
    tbl = from_arrow(narrow_edge_table())
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "1024",
            "spark.rapids.tpu.sql.shape.minBucketRows": "64"}
    s = PSession(conf, device="cpu")

    def run():
        return s.from_host(tbl).filter(PE.LessThan(
            PE.ColumnRef("a"), PE.Literal(5))).collect()
    first = run()
    keys = [k for k in tbl._stats if k[0] == "narrowed"]
    assert {k[1] for k in keys} == {"a", "b"}
    cached = {k: tbl._stats[k] for k in keys}
    PD.reset_upload_counts()
    second = run()
    assert PD.UPLOADS["narrow_ns"] == 0
    assert all(tbl._stats[k] is v for k, v in cached.items())
    assert first.to_pydict() == second.to_pydict()


def test_remap_codes_into_identity_fast_path_and_threads():
    from spark_rapids_tpu_torch.ops.batch_ops import (ensure_unique_dict,
                                                      remap_codes_into)
    hb = from_arrow(pa.table({"s": pa.array(["a", "b", "c"] * 10)}))
    c = PD.to_device(hb, device="cpu").columns[0]
    assert remap_codes_into(c, c.dictionary) is c
    target = np.array(["a", "c"], str)      # a build's sorted dictionary
    errs, outs = [], []

    def worker():
        try:
            for _ in range(50):
                out = remap_codes_into(c, target)
                outs.append(out.data[:3].tolist())
                ensure_unique_dict(c)
        except Exception as e:               # noqa: BLE001
            errs.append(e)
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    # 'a', 'b', 'c' -> codes into ["a", "c"]: a -> 0, b -> -1, c -> 1
    assert len(outs) == 400 and all(o == [0, -1, 1] for o in outs)


def test_off_switch_results_identical_and_nothing_encoded():
    """encoded.execution.enabled=false: no scan narrows, no encoded
    dispatch is counted, and TPC-H q3 returns the same rows."""
    from spark_rapids_tpu_torch import tpch
    tables = tpch.gen_tables(0.001)
    got = {}
    for label, conf in (("on", {}), ("off", OFF)):
        s = PSession(conf, device="cpu")
        q = tpch.QUERIES["q3"](s, tables).physical()
        ctx = ExecContext(q.conf, q.device)
        got[label] = q.collect(ctx).to_pydict()
        counted = [k for k in ctx.metrics if k.startswith("encoded_")]
        if label == "off":
            assert not any(sc.encoded_cols for sc in _scans(q.root))
            assert counted == []
        else:
            assert any(sc.encoded_cols for sc in _scans(q.root))
            assert ctx.metrics.get(
                "encoded_dispatch.predicate_code.encoded", 0) > 0
    assert got["on"] == got["off"]


def test_encoded_elections_shed_on_an_injected_oom():
    """`kernel:oom` at an encoded dispatch sheds it onto the decoded
    tier (`oom_shed`), bit-identically."""
    tbl = str_table(500)
    build = _filter(tbl, PREDICATES[0])
    clean, _ = _port_run(build, {})
    got, ctx = _port_run(build, {"spark.rapids.tpu.test.faults":
                                 "kernel:oom:nth=1"})
    assert got.to_pydict() == clean.to_pydict()
    assert ctx.metrics.get("encoded_dispatch.predicate_code.oom_shed") == 1


def test_sort_orders_by_codes_over_an_ordered_dictionary():
    tbl = str_table(400)

    def build(s, E, _A):
        return s.from_arrow(tbl).sort(("s", True, True), ("x", True, True))
    got, ctx = _port_run(build, {})
    assert ctx.metrics.get("encoded_dispatch.sort_codes.encoded", 0) > 0
    jdf = build(JSession(), JE, JA)
    assert got.to_pydict() == jdf.collect().to_pydict()
    off, ctx_off = _port_run(build, OFF)
    assert off.to_pydict() == got.to_pydict()
    assert not [k for k in ctx_off.metrics if k.startswith("encoded_")]


# ---------------------------------------------------------------------------
# the narrow-lane sweep and the PyTorch wrap pins
# ---------------------------------------------------------------------------

def sweep_table():
    """Columns whose batch values sit at the edges of int8 (a8, i8),
    int16 (a16) and int32 (a32) and narrow to them, a DATE lane and a
    DECIMAL(10, 2) lane that narrows to int16."""
    a8 = [127, -128, 126, -127, 0, 1, -1, 100, -100, None]
    a16 = [32767, -32768, 128, -129, 0, 300, -300, 32000, -32000, None]
    a32 = [2 ** 31 - 1, -2 ** 31, 32768, -32769, 0, 70000, -70000,
           2 ** 30, -2 ** 30, None]
    dec = ["327.67", "-327.68", "1.28", "-1.29", "0", "3.00", "-3.00",
           "320.00", "-320.00", None]
    n = 20
    return pa.table({
        "a8": pa.array(a8 * n, pa.int64()),
        "a16": pa.array(a16 * n, pa.int64()),
        "a32": pa.array(a32 * n, pa.int64()),
        "i8": pa.array(a8 * n, pa.int32()),
        "d": pa.array([None if v is None else 10000 + v for v in a8] * n,
                      pa.date32()),
        "dec": pa.array([None if v is None else pydec.Decimal(v)
                         for v in dec] * n, pa.decimal128(10, 2)),
    })


BIG = [300, -300, 40000, -40000, 1 << 40, -(1 << 40)]


def _sweep_exprs():
    E, c, L = PE, PE.ColumnRef, PE.Literal
    cols = ("a8", "a16", "a32", "i8")
    out = []
    for a in cols:
        for b in cols:
            for cls in (E.Add, E.Subtract, E.Multiply, E.Divide,
                        E.IntegralDivide, E.Remainder):
                out.append(cls(c(a), c(b)))
            for cls in (E.EqualTo, E.NotEqual, E.LessThan,
                        E.LessThanOrEqual, E.GreaterThan,
                        E.GreaterThanOrEqual, E.EqualNullSafe):
                out.append(cls(c(a), c(b)))
        for v in BIG + [5, -128, 127]:
            lit = L(v)
            for cls in (E.Add, E.Subtract, E.Multiply, E.IntegralDivide,
                        E.Remainder):
                out.append(cls(c(a), lit))
                out.append(cls(lit, c(a)))
            for cls in (E.EqualTo, E.NotEqual, E.LessThan,
                        E.LessThanOrEqual, E.GreaterThan,
                        E.GreaterThanOrEqual):
                out.append(cls(c(a), lit))
                out.append(cls(lit, c(a)))
            out.append(E.If(E.GreaterThan(c(a), L(0)), c(a), lit))
            out.append(E.CaseWhen([(E.LessThan(c(a), L(0)), lit)], c(a)))
            out.append(E.Coalesce(c(a), lit))
            wide = c(a) if a != "i8" else E.Cast(c(a), PT.LONG)
            out.append(E.Greatest(wide, L(v, PT.LONG)))
            out.append(E.Least(wide, L(v, PT.LONG)))
        # an INT column's items stay in INT (Spark casts the column up)
        out.append(E.In(c(a), (BIG if a != "i8" else BIG[:4]) +
                        [127, -128, 0]))
        out.append(E.In(c(a), [32767, None]))
        for dt in (PT.BYTE, PT.SHORT, PT.INT, PT.LONG, PT.DOUBLE,
                   PT.DecimalType(20, 2)):
            out.append(E.Cast(c(a), dt))
        out.append(E.UnaryMinus(c(a)))
        out.append(E.Abs(c(a)))
        out.append(E.BitwiseAnd(c(a), L(0xFF)))
        out.append(E.ShiftLeft(c(a), L(3)))
    d = pydec.Decimal
    for lit in (L(d("1.005")), L(d("99999999.99")), L(d("-0.5")), L(3)):
        out.append(E.Add(c("dec"), lit))
        out.append(E.Multiply(c("dec"), lit))
        out.append(E.LessThan(c("dec"), lit))
        out.append(E.EqualTo(c("dec"), lit))
    out.append(E.Multiply(c("dec"), c("dec")))
    out.append(E.Cast(c("dec"), PT.DecimalType(5, 0)))
    out.append(E.Cast(c("dec"), PT.DecimalType(18, 6)))
    out.append(E.LessThan(c("d"), L(pydt.date(1997, 5, 1))))
    out.append(E.GreaterThanOrEqual(c("d"), L(pydt.date(2300, 1, 1))))
    return out


def _sweep(conf):
    exprs = _sweep_exprs()
    names = [f"e{i}" for i in range(len(exprs))]

    def build(s, E, _A):
        return s.from_arrow(sweep_table()).select(
            *[E.Alias(e, n) for e, n in zip(exprs, names)], names=names)
    got, ctx = _port_run(build, conf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q = build(PSession(conf, device="cpu"), PE, PA).physical()
    assert q.kind == "device" and not q.fallback_reasons(), \
        q.fallback_reasons()
    return got, ctx


def test_narrow_lane_sweep_is_bit_equal_to_wide_lanes():
    on, ctx = _sweep({})
    off, ctx_off = _sweep(NARROW_OFF)
    m = ctx.metrics
    # the lanes really narrowed, and the guarded sites ran on them
    assert m.get("encoded_dispatch.narrow_upload.encoded", 0) >= 5
    for site in ("predicate_narrow", "arith_narrow", "in_narrow"):
        assert m.get(f"encoded_dispatch.{site}.encoded", 0) > 0, site
    assert "encoded_dispatch.narrow_upload.encoded" not in ctx_off.metrics
    assert on.names == off.names
    for name, a, b in zip(on.names, on.columns, off.columns):
        assert a.dtype == b.dtype and a.data.dtype == b.data.dtype, name
        va = np.ones(len(a.data), bool) if a.validity is None else a.validity
        vb = np.ones(len(b.data), bool) if b.validity is None else b.validity
        assert np.array_equal(va, vb), name
        assert np.array_equal(a.data[va].view(np.uint8),
                              b.data[vb].view(np.uint8)), name
        if a.hi is not None or b.hi is not None:
            assert np.array_equal(a.hi_lane()[va], b.hi_lane()[vb]), name


def test_pytorch_wraps_narrow_lanes_and_the_port_does_not():
    """Three PyTorch behaviours a narrow lane must never meet, pinned,
    and the port's answer over the same values."""
    lane = torch.tensor([100, -100, 5], dtype=torch.int8)
    # a Python scalar does not promote the lane: 300 wraps to 44
    assert (lane < 300).tolist() == [False, True, True]
    assert ENC.narrow_compare("<", lane, torch.tensor(300)).tolist() == \
        [True, True, True]
    # an int16 product wraps
    assert (torch.tensor([9000], dtype=torch.int16) * 100).tolist() == \
        [-17504]
    # torch.where keeps the lane's dtype against a wide 0-d tensor
    picked = torch.where(torch.tensor([True, False]),
                         torch.tensor([1, 2], dtype=torch.int8),
                         torch.tensor(1 << 40))
    assert picked.dtype == torch.int8
    # the port over narrowed lanes: the same three shapes, exact
    tbl = pa.table({"x": pa.array([100, -100, 5], pa.int64()),
                    "y": pa.array([9000, -9000, 7], pa.int64())})

    def build(s, E, _A):
        c, L = E.ColumnRef, E.Literal
        return s.from_arrow(tbl).select(
            E.Alias(E.LessThan(c("x"), L(300)), "lt"),
            E.Alias(E.Multiply(c("y"), L(100)), "m"),
            E.Alias(E.If(E.GreaterThan(c("x"), L(0)), c("x"),
                         L(1 << 40)), "w"),
            names=["lt", "m", "w"])
    got, ctx = _port_run(build, {})
    assert ctx.metrics.get("encoded_dispatch.narrow_upload.encoded", 0) == 2
    assert got.to_pydict() == {"lt": [True, True, True],
                               "m": [900000, -900000, 700],
                               "w": [100, 1 << 40, 5]}
