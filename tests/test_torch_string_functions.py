"""The port's device string functions (plan/strings.py, the STRING casts
and string-vs-literal ordering of plan/expressions.py, ops/strings.py)
against the JAX package.

Every case of chip_smoke_strings.EDGE_CASES runs over the reference's
tests/test_strings.py VALUES plus the edge texts (nulls, '', white-space
runs, %, _ and \\, non-ASCII text, the casts' numeric and date texts).
The port (CPU tensors), with its dictionary transforms on the host loop
and forced onto the device rewrite (`transformDeviceMinUnique=1`), must
equal the reference's device path (`TpuSession()`) and its CPU oracle
(sql.enabled=false) exactly.  Where the reference itself runs a case on
its CPU engine (STRING -> BOOLEAN) or its device path is wrong by its own
oracle (`REFERENCE_DEVICE_FAULTS`), the port is held to the oracle and
the fault is pinned.
"""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch
from test_strings import VALUES

import chip_smoke_strings as CS

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops import strings as JOS
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import strings as JS
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.ops import strings as POS
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import strings as PS
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
DEVICE_MIN = "spark.rapids.tpu.sql.string.transformDeviceMinUnique"
ROWS = VALUES + [None] + CS.EDGE_TEXTS
#: cases the reference runs on its CPU engine only
REFERENCE_ON_CPU = {"cast_boolean"}
#: cases where the reference's device path disagrees with its oracle:
#: its compile_like reads an escaped '%' chunk as the wildcard, so
#: LIKE '%\\%' matches every string
REFERENCE_DEVICE_FAULTS = {"like_escaped_percent"}


@pytest.fixture(scope="module")
def table():
    return pa.table({"s": pa.array(ROWS, pa.string()),
                     "i": pa.array(range(len(ROWS)), pa.int64())})


@pytest.fixture(scope="module")
def reference(table):
    """{case: (device-path values or None, oracle values)}: one select
    of every case the reference's device path runs, one of every case
    through its oracle."""
    def frame(session, names):
        return session.from_arrow(table).select(
            jcol("i"), *[JE.Alias(CS.EDGE_CASES[n](JE, JS, jcol, JT), n)
                         for n in names])
    on_device = [n for n in CS.EDGE_CASES if n not in REFERENCE_ON_CPU]
    q = frame(JSession(), on_device).physical()
    assert q.kind == "device", q.explain()
    dev = q.collect().sort_by("i").to_pydict()
    jdf = frame(JSession(), list(CS.EDGE_CASES))
    oracle = JDF(jdf._plan, JSession(ORACLE)).collect().sort_by("i") \
        .to_pydict()
    return {n: (dev.get(n), oracle[n]) for n in CS.EDGE_CASES}


def _port(table, names, conf=None):
    return PSession(conf, device="cpu").from_arrow(table).select(
        pcol("i"), *[PE.Alias(CS.EDGE_CASES[n](PE, PS, pcol, PT), n)
                     for n in names]).to_pydict()


@pytest.fixture(scope="module")
def port(table):
    names = list(CS.EDGE_CASES)
    return _port(table, names), _port(table, names, {DEVICE_MIN: "1"})


def _same(a, b) -> bool:
    """Equal lists, NaN equal to NaN, -0.0 apart from 0.0, bool apart
    from int."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float):
            if not (math.isnan(x) and math.isnan(y)) and (
                    x != y or math.copysign(1, x) != math.copysign(1, y)):
                return False
        elif type(x) is not type(y) or x != y:
            return False
    return True


@pytest.mark.parametrize("case", list(CS.EDGE_CASES))
def test_string_function_equals_reference_and_oracle(case, reference, port):
    dev, oracle = reference[case]
    host_loop, forced = (p[case] for p in port)
    assert _same(host_loop, oracle), case
    assert _same(forced, oracle), case
    if case in REFERENCE_DEVICE_FAULTS:
        assert not _same(dev, oracle)
    elif case not in REFERENCE_ON_CPU:
        assert _same(dev, oracle), case


def test_the_reference_runs_string_to_boolean_on_its_cpu_engine(table):
    jdf = JSession().from_arrow(table).select(
        JE.Alias(JE.Cast(jcol("s"), JT.BOOLEAN), "b"))
    assert jdf.physical().kind == "host"


def test_the_reference_compile_like_takes_an_escaped_percent_as_wildcard():
    # the fault REFERENCE_DEVICE_FAULTS pins; the port keeps the chunk
    assert JOS.compile_like(r"%\%").kind == "contains"
    assert JOS.compile_like(r"%\%").parts == [b""]
    plan = POS.compile_like(r"%\%")
    assert (plan.kind, plan.parts) == ("suffix", [b"%"])


LIKE_PATTERNS = ["", "%", "%%", "abc", "abc%", "%abc", "%abc%", "a%c",
                 "a%%c", "a_c", "a%b%c", r"a\%b", r"a\_b", "%é%", "😀%",
                 "\\", "a\\"]


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_compile_like_and_regex_equal_reference(pattern):
    ours, theirs = POS.compile_like(pattern), JOS.compile_like(pattern)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert (ours.kind, ours.parts) == (theirs.kind, theirs.parts)
    assert POS.like_to_regex(pattern) == JOS.like_to_regex(pattern)


# ---------------------------------------------------------------------------
# The device dictionary transforms against the host loop
# ---------------------------------------------------------------------------

ALPHABET = list("aAbZz %_\\\t\n\x0b\x1c\x1f") + [
    "é", "ß", "ﬆ", "\u0301", "ǅ", "İ", "日", "😀", "\u00a0"]
HOST = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
        "ltrim": str.lstrip, "rtrim": str.rstrip}


def _dictionary(seed: int, n: int = 400) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = {"", " ", "ß", "ﬆ", "  x  ", "\x1fa\x1c"}
    for k in rng.integers(0, 9, n).tolist():
        words.add("".join(ALPHABET[i] for i in rng.integers(
            0, len(ALPHABET), k)))
    return np.array(sorted(words), str)


@pytest.mark.parametrize("seed", [31, 32])
@pytest.mark.parametrize("kind", list(HOST))
def test_device_transform_equals_the_host_loop(kind, seed):
    d = _dictionary(seed)
    out, remap = POS.transform_dict_device(d, kind, (), "cpu")
    want = [HOST[kind](s) for s in d.tolist()]
    assert out[remap.numpy()].tolist() == want
    assert out.tolist() == sorted(set(want))
    assert remap.dtype == torch.int32


def test_device_transforms_change_lengths_past_ascii():
    d = np.array(["ß", "straße", "ﬆop", "ǅ"], str)
    out, remap = POS.transform_dict_device(d, "upper", (), "cpu")
    assert out[remap.numpy()].tolist() == ["SS", "STRASSE", "STOP", "Ǆ"]
    out, remap = POS.transform_dict_device(d, "lower", (), "cpu")
    assert out[remap.numpy()].tolist() == ["ß", "straße", "ﬆop", "ǆ"]


def test_the_reference_device_trim_keeps_information_separators():
    # the reference's device trim strips six ASCII white-space bytes, its
    # host loop and oracle Python's str.strip (\x1c-\x1f too); the port's
    # device trim strips what str.strip strips
    d = np.array(["\x1fa\x1c", " b "], str)
    ref = JOS.transform_dict_device(pa.array(list(d)), "trim", ())
    assert ref.to_pylist() == ["\x1fa\x1c", "b"]
    out, remap = POS.transform_dict_device(d, "trim", (), "cpu")
    assert out[remap.numpy()].tolist() == ["a", "b"]


@pytest.mark.parametrize("case", ["upper", "lower", "trim", "ltrim", "rtrim"])
def test_a_failing_device_transform_raises(case, monkeypatch):
    # (substring's: tests/test_torch_strings.py)
    def broken(*a, **k):
        raise RuntimeError("device transform failed")
    monkeypatch.setattr(POS, "transform_dict_device", broken)
    s = PSession({DEVICE_MIN: "1"}, device="cpu").from_arrow(
        pa.table({"s": ["ab", "cd"]}))
    with pytest.raises(RuntimeError, match="device transform failed"):
        s.select(PE.Alias(CS.EDGE_CASES[case](PE, PS, pcol, PT), "r")) \
            .collect()


# ---------------------------------------------------------------------------
# Null entries, ConcatWs, ordering over any dictionary, casts
# ---------------------------------------------------------------------------

def _three(table, build, conf=None):
    """(port, reference device path, oracle) of `build(E, S, A, col, df)`
    as pydicts."""
    jdf = build(JE, JS, JA, jcol, JSession(conf).from_arrow(table))
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession({**(conf or {}), **ORACLE})) \
        .collect().to_pydict()
    got = build(PE, PS, PA, pcol, PSession(conf, device="cpu").from_arrow(
        table)).to_pydict()
    return got, ref, oracle


def test_a_null_transform_result_is_a_null_row_not_the_string_none():
    table = pa.table({"s": ["%%", "aGVsbG8=", None, "%%", "None"],
                      "i": [0, 1, 2, 3, 4]})

    def build(E, S, A, c, df):
        return df.select(c("i"), E.Alias(S.UnBase64(c("s")), "u"))
    got, ref, oracle = _three(table, build)
    assert got["u"] == [None, "hello", None, None, None]
    assert got == ref == oracle
    hb = PSession(device="cpu").from_arrow(table).select(
        PE.Alias(PS.UnBase64(pcol("s")), "u")).collect()
    assert "None" not in hb.column_by_name("u").dictionary.tolist()

    def grouped(E, S, A, c, df):
        return (df.select(E.Alias(S.UnBase64(c("s")), "u"))
                .group_by("u").agg((A.Count(None), "n")).sort("u"))
    got, ref, oracle = _three(table, grouped)
    assert got == oracle
    assert dict(zip(got["u"], got["n"])) == {None: 4, "hello": 1}
    # the reference's device path groups by the codes of a dictionary
    # that holds null entries, and miscounts: the port follows its oracle
    assert dict(zip(ref["u"], ref["n"])) == {None: 1, "hello": 4}


def test_concat_ws_skips_a_null_operand():
    table = pa.table({"s": [None, "x", "", None], "i": [0, 1, 2, 3]})

    def build(E, S, A, c, df):
        return df.select(c("i"), E.Alias(S.ConcatWs(
            "-", E.Literal("a"), c("s"), E.Literal("z")), "w"),
            E.Alias(S.ConcatWs(",", c("s")), "alone"))
    got, ref, oracle = _three(table, build)
    assert got["w"] == ["a-z", "a-x-z", "a--z", "a-z"]
    assert got["alone"] == ["", "x", "", ""]
    assert got == ref == oracle


@pytest.mark.parametrize("op", ["LessThan", "LessThanOrEqual", "GreaterThan",
                                "GreaterThanOrEqual"])
def test_string_ordering_over_an_unsorted_dictionary(op):
    # a computed dictionary may be unsorted and repeat entries: the
    # comparison masks its entries instead of bounding the codes
    d = np.array(["b", "a", "é", "a", ""], str)
    codes = np.array([0, 1, 2, 3, 4, 0, 2], np.int32)
    valid = np.array([True, True, True, True, True, False, True])
    hb = HostBatch([HostColumn(codes, valid, PT.STRING, d)], ["s"])
    s = PSession(device="cpu").from_host(hb)
    fn = {"LessThan": lambda a, b: a < b, "LessThanOrEqual": lambda a, b:
          a <= b, "GreaterThan": lambda a, b: a > b,
          "GreaterThanOrEqual": lambda a, b: a >= b}[op]
    for lit in ("a", "b", "c", "", "é", "z"):
        got = s.select(PE.Alias(getattr(PE, op)(pcol("s"), PE.Literal(lit)),
                                "r")).to_pydict()["r"]
        want = [fn(str(d[c]), lit) if v else None
                for c, v in zip(codes, valid)]
        assert got == want, lit


def test_string_ordering_through_an_alias_and_in_a_filter():
    table = pa.table({"s": ["b", "a", None, "é", "ab"], "i": [0, 1, 2, 3, 4]})

    def build(E, S, A, c, df):
        return (df.select(c("i"), E.Alias(c("s"), "t"))
                .filter(E.LessThanOrEqual(E.Literal("ab"), c("t")))
                .sort("i"))
    got, ref, oracle = _three(table, build)
    assert got["t"] == ["b", "é", "ab"]
    assert got == ref == oracle


#: the casts' pinned edges (README deviations from Spark: '1e3' and
#: '1_000' parse as numbers, '2020' and '2020-01' are no DATE, in the
#: reference and its oracle as here)
CAST_EDGES = [
    ("LONG", " 12 ", 12), ("LONG", "1e3", 1000), ("LONG", "1_000", 1000),
    ("LONG", "-0", 0), ("LONG", "9223372036854775808", None),
    ("LONG", "-12.7", -12), ("INT", "NaN", None), ("INT", "Infinity", None),
    ("DOUBLE", "Infinity", math.inf), ("DOUBLE", "1_000", 1000.0),
    ("DOUBLE", "-0", -0.0), ("BOOLEAN", "yes", True),
    ("BOOLEAN", "0", False), ("BOOLEAN", "maybe", None),
    ("DATE", "2020-1-5", "2020-01-05"),
    ("DATE", "2020-01-05T10:00", "2020-01-05"), ("DATE", "2020", None),
    ("DATE", "2020-01", None),
    ("DATE", "2020-02-30", None)]


@pytest.mark.parametrize("to,text,want", CAST_EDGES)
def test_cast_edges_are_pinned(to, text, want):
    import datetime as pydt
    table = pa.table({"s": [text]})
    got = PSession(device="cpu").from_arrow(table).select(PE.Alias(
        PE.Cast(pcol("s"), getattr(PT, to)), "v")).to_pydict()["v"][0]
    if to == "DATE" and want is not None:
        want = pydt.date.fromisoformat(want)
    assert _same([got], [want])
    assert PE.Cast._parse_entry(text, getattr(PT, to)) == \
        JE.Cast._parse_entry(text, getattr(JT, to))


def test_a_cast_key_packs_into_the_segmented_group_by():
    from spark_rapids_tpu_torch.exec.aggregate import GROUPBY_TIERS, \
        reset_groupby_tiers
    rng = np.random.default_rng(41)
    table = pa.table({"s": [f"{k}-x" for k in rng.integers(10, 35, 500)],
                      "v": rng.integers(0, 100, 500)})

    def build(E, S, A, c, df):
        return (df.group_by(E.Alias(E.Cast(S.SplitPart(c("s"), "-", 1),
                                           PT.INT if E is PE else JT.INT),
                                    "k"))
                .agg((A.Sum(c("v")), "sv"), (A.Max(c("v")), "mv"))
                .sort("k"))
    reset_groupby_tiers()
    got, ref, oracle = _three(table, build)
    assert GROUPBY_TIERS["segagg"] > 0 and GROUPBY_TIERS["sort"] == 0
    assert got == ref == oracle


# ---------------------------------------------------------------------------
# The families the reference runs on its CPU engine, and what stays
# refused, naming its slice
# ---------------------------------------------------------------------------

#: the families the reference's tagging puts on its CPU engine: each runs
#: on the port's CPU engine with the reference's reason
CPU_ENGINE = {
    "string_coalesce": lambda E, S, T, c: E.Coalesce(c("s"), E.Literal("x")),
    "string_if": lambda E, S, T, c: E.If(E.IsNull(c("s")), E.Literal("x"),
                                         c("s")),
    "column_ordering": lambda E, S, T, c: E.LessThan(c("s"), c("t")),
    "cast_to_string": lambda E, S, T, c: E.Cast(c("i"), T.STRING),
    "format_number": lambda E, S, T, c: S.FormatNumber(c("i"), 2),
    "bin": lambda E, S, T, c: S.Bin(c("i")),
    "concat_two_columns": lambda E, S, T, c: S.Concat(c("s"), c("t")),
    "concat_ws_two_columns": lambda E, S, T, c: S.ConcatWs("-", c("s"),
                                                           c("t")),
}
#: where the reference's CPU engine is wrong by Spark's rules (it joins
#: only its first non-literal operand) the port gives Spark's answer
SPARK_NOT_REFERENCE = {"concat_ws_two_columns": ["a-b", "c", "-e", "f"]}
REFUSED = {
    "rlike": (lambda c: PS.RLike(c("s"), "a+"), "ops/regex.py"),
    "regexp_extract": (lambda c: PS.RegexpExtract(c("s"), "(a)", 1),
                       "ops/regex.py"),
    "regexp_replace": (lambda c: PS.RegexpReplace(c("s"), "a", "b"),
                       "ops/regex.py"),
}
SMALL = {"s": ["a", None, "", "f"], "t": ["b", "c", "e", None],
         "i": [1, 2, None, -3]}


@pytest.mark.parametrize("family", list(CPU_ENGINE))
def test_the_cpu_engine_families_fall_back_with_the_reference_reason(
        family):
    build = CPU_ENGINE[family]
    table = pa.table(SMALL)
    jq = JSession().from_arrow(table).select(
        JE.Alias(build(JE, JS, JT, jcol), "r")).physical()
    pq = PSession(device="cpu").from_arrow(table).select(
        PE.Alias(build(PE, PS, PT, pcol), "r")).physical()
    assert jq.kind == pq.kind == "host"
    assert pq.fallback_reasons() == jq.fallback_reasons()
    assert pq.explain().startswith("!Exec <Project> cannot run on TPU "
                                   "because ")
    got = pq.collect().to_pydict()["r"]
    ref = jq.collect().to_pydict()["r"]
    oracle = JSession(ORACLE).from_arrow(table).select(
        JE.Alias(build(JE, JS, JT, jcol), "r")).collect().to_pydict()["r"]
    if family in SPARK_NOT_REFERENCE:
        assert ref == oracle != got == SPARK_NOT_REFERENCE[family]
    else:
        assert _same(got, ref) and _same(got, oracle)


@pytest.mark.parametrize("family", list(REFUSED))
def test_the_families_of_other_slices_refuse_naming_them(family):
    # their slice (ops/regex.py) has ported: each now places on the
    # device, as the reference does, and equals the CPU engine
    build, where = REFUSED[family]
    table = pa.table({"s": ["a", None], "t": ["b", "c"], "i": [1, 2]})
    q = PSession(device="cpu").from_arrow(table).select(
        PE.Alias(build(pcol), "r")).physical()
    assert q.kind == "device" and where == "ops/regex.py"
    assert q.collect().to_pydict() == PSession(
        ORACLE, device="cpu").from_arrow(table).select(
        PE.Alias(build(pcol), "r")).to_pydict()


@pytest.mark.parametrize("family", list(REFUSED))
def test_the_regexp_family_runs_the_cpu_engine_with_sql_disabled(family):
    # the reference's tagging keeps these on its device; only with
    # sql.enabled=false does the CPU engine take them
    build, _where = REFUSED[family]
    table = pa.table({"s": ["aa", None, "ba", "c"], "i": [1, 2, 3, 4]})
    jbuild = {"rlike": lambda c: JS.RLike(c("s"), "a+"),
              "regexp_extract": lambda c: JS.RegexpExtract(c("s"), "(a)", 1),
              "regexp_replace": lambda c: JS.RegexpReplace(c("s"), "a", "b")
              }[family]
    got = PSession(ORACLE, device="cpu").from_arrow(table).select(
        PE.Alias(build(pcol), "r")).to_pydict()
    oracle = JSession(ORACLE).from_arrow(table).select(
        JE.Alias(jbuild(jcol), "r")).collect().to_pydict()
    assert got == oracle


@pytest.mark.parametrize("agg", ["Min", "Max"])
def test_string_min_max_fall_back_to_the_cpu_engine(agg):
    table = pa.table({"s": ["b", None, "a", "c", None], "k": [1, 1, 1, 2, 3]})
    jq = JSession().from_arrow(table).group_by("k").agg(
        (getattr(JA, agg)(jcol("s")), "m")).physical()
    pq = PSession(device="cpu").from_arrow(table).group_by("k").agg(
        (getattr(PA, agg)(pcol("s")), "m")).physical()
    assert jq.kind == pq.kind == "host"
    assert pq.fallback_reasons() == jq.fallback_reasons() == [
        f"aggregate {agg}: string min/max not yet on device"]
    assert pq.collect().to_pydict() == jq.collect().to_pydict() == {
        "k": [1, 2, 3], "m": ["a" if agg == "Min" else "b", "c", None]}


def test_every_case_on_the_cpu_engine_equals_the_oracle(table, reference):
    # sql.enabled=false: every class's eval_cpu, per dictionary entry
    names = list(CS.EDGE_CASES)
    got = _port(table, names, ORACLE)
    assert [n for n in names if not _same(got[n], reference[n][1])] == []


def test_every_case_over_an_all_null_column_equals_the_oracle():
    # an all-null batch carries an empty dictionary
    table = pa.table({"s": pa.array([None, None, None], pa.string()),
                      "i": pa.array([0, 1, 2], pa.int64())})
    names = list(CS.EDGE_CASES)
    jdf = JSession(ORACLE).from_arrow(table).select(
        jcol("i"), *[JE.Alias(CS.EDGE_CASES[n](JE, JS, jcol, JT), n)
                     for n in names])
    oracle = jdf.collect().sort_by("i").to_pydict()
    for conf in (None, {DEVICE_MIN: "1"}):
        got = _port(table, names, conf)
        assert [n for n in names if not _same(got[n], oracle[n])] == []


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("length", ["literal", "column"])
def test_a_pad_length_of_zero_or_less_gives_the_empty_string(engine,
                                                             length):
    # ROADMAP Queue 3 item 14: s[:length] sliced from the end for a
    # negative length ('Straße' -> 'Straß'); Spark gives '' for any
    # length <= 0, on both engines, for a literal or a column length
    table = pa.table({"s": ["Straße", "ab", None, "xyz", "Straße"],
                      "n": pa.array([-1, 0, 3, -7, 8], pa.int64())})
    conf = ORACLE if engine == "cpu" else None
    df = PSession(conf, device="cpu").from_arrow(table)
    if length == "literal":
        got = df.select(PE.Alias(PS.Lpad(pcol("s"), -1, "*"), "l"),
                        PE.Alias(PS.Rpad(pcol("s"), 0, "*"), "r"))
        want = {"l": ["", "", None, "", ""], "r": ["", "", None, "", ""]}
    else:
        got = df.select(PE.Alias(PS.Lpad(pcol("s"), pcol("n"), "*"), "l"),
                        PE.Alias(PS.Rpad(pcol("s"), pcol("n"), "*"), "r"))
        want = {"l": ["", "", None, "", "**Straße"],
                "r": ["", "", None, "", "Straße**"]}
    assert got.to_pydict() == want
