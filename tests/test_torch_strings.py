"""The port's string predicates and Substring (ops/strings.py,
plan/strings.py) against the JAX package.

The byte work is held against the reference's ops/strings.py functions
on the same dictionaries, and the expressions against the reference's
device path and its CPU oracle (sql.enabled=false) on the same Arrow
tables; the port runs on CPU tensors.  Everything compares exactly.
Dictionaries come from a numpy seed and mix 1- to 4-byte UTF-8
characters with empty strings.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import strings as JS
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import strings as JPS
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.columnar.device import to_device
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.evaluator import evaluate_projection
from spark_rapids_tpu_torch.ops import strings as PS
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import strings as PPS
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
DEVICE_MIN = "spark.rapids.tpu.sql.string.transformDeviceMinUnique"
#: one, two, three and four UTF-8 bytes a character
ALPHABET = list("abcgren ") + ["é", "ß", "日", "本", "😀"]


def _words(seed: int, n: int, most: int = 8) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, most + 1))
        out.append("".join(ALPHABET[i] for i in rng.integers(
            0, len(ALPHABET), k)))
    return out


def _dictionary(seed: int, n: int = 300) -> np.ndarray:
    """A sorted duplicate-free dictionary (the port's host form) with the
    empty string."""
    return np.unique(np.array(_words(seed, n) + [""], str))


def _reference_tensors(d):
    offsets, bytes_ = JS.dict_byte_tensors(pa.array(list(d), pa.string()))
    return jnp.asarray(offsets), jnp.asarray(bytes_)


def test_byte_tensors_and_lengths_equal_reference():
    d = _dictionary(1)
    n = len(d)
    offsets, bytes_ = PS.dict_byte_tensors(d, "cpu")
    joffs, jbytes = _reference_tensors(d)
    total = int(offsets[-1])
    assert offsets.dtype == torch.int32 and bytes_.dtype == torch.uint8
    assert offsets.tolist() == np.asarray(joffs)[:n + 1].tolist()
    assert bytes_[:total].tolist() == np.asarray(jbytes)[:total].tolist()
    assert bytes(bytes_[:total].tolist()) == "".join(d).encode("utf-8")
    assert PS.byte_lengths(offsets).tolist() == \
        np.asarray(JS.byte_lengths(joffs))[:n].tolist()
    assert PS.char_lengths(offsets, bytes_).tolist() == \
        np.asarray(JS.char_lengths(joffs, jbytes))[:n].tolist()
    assert PS.char_lengths(offsets, bytes_).tolist() == [len(s) for s in d]


def test_byte_tensors_of_an_empty_dictionary_stay_indexable():
    offsets, bytes_ = PS.dict_byte_tensors(np.array([], str), "cpu")
    assert offsets.tolist() == [0] and bytes_.numel() == 1
    offsets, bytes_ = PS.dict_byte_tensors(np.array(["", ""], str), "cpu")
    assert offsets.tolist() == [0, 0, 0] and bytes_.numel() == 1


MATCHERS = [(PS.match_prefix, JS.match_prefix),
            (PS.match_suffix, JS.match_suffix),
            (PS.match_contains, JS.match_contains),
            (PS.match_equals, JS.match_equals)]
PATTERNS = ["", "a", "ab", "ré", "日本", "😀", "é😀", " ", "abcgrenabcgren",
            "no such pattern longer than any entry"]


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("ours,theirs", MATCHERS,
                         ids=["prefix", "suffix", "contains", "equals"])
def test_matchers_equal_reference(seed, ours, theirs):
    d = _dictionary(seed)
    offsets, bytes_ = PS.dict_byte_tensors(d, "cpu")
    joffs, jbytes = _reference_tensors(d)
    for pat in PATTERNS + [s for s in d[::37]]:
        raw = pat.encode("utf-8")
        got = ours(offsets, bytes_, raw).tolist()
        want = np.asarray(theirs(joffs, jbytes, raw))[:len(d)].tolist()
        assert got == want, pat


def test_matchers_on_the_reference_null_entry():
    # the reference encodes a null dictionary entry as ""; the port's
    # dictionaries hold no null entry (a null is the row's validity), so
    # its "" entry answers as the reference's null one
    ref = pa.array(["ab", None, "b", "cab"], pa.string())
    joffs, jbytes = (jnp.asarray(a) for a in JS.dict_byte_tensors(ref))
    offsets, bytes_ = PS.dict_byte_tensors(np.array(["ab", "", "b", "cab"],
                                                    str), "cpu")
    for ours, theirs in MATCHERS:
        for pat in (b"", b"b", b"ab"):
            assert ours(offsets, bytes_, pat).tolist() == \
                np.asarray(theirs(joffs, jbytes, pat))[:4].tolist()


SUBSTRINGS = [(1, 2), (0, 3), (2, None), (-2, None), (-3, 2), (-100, 2),
              (3, 0), (2, -1), (1, 100), (7, 1), (100, None)]


@pytest.mark.parametrize("pos,length", SUBSTRINGS)
def test_substring_equals_reference_on_both_sides_of_the_device_gate(
        pos, length):
    d = _dictionary(4)
    ref = pa.array(list(d), pa.string())
    want_device = JS.transform_dict_device(ref, "substr",
                                           (pos, length)).to_pylist()
    want_host = [JPS._spark_substring(s, pos, length) for s in d]
    assert want_device == want_host
    out, remap = PS.transform_dict_device(d, "substr", (pos, length), "cpu")
    assert out[remap.numpy()].tolist() == want_host
    # sorted, duplicate-free
    assert np.all(out[:-1] < out[1:])
    assert [PPS._spark_substring(s, pos, length) for s in d] == want_host


def test_decode_inverts_the_byte_tensors():
    d = _dictionary(5)
    offsets, bytes_ = PS.dict_byte_tensors(d, "cpu")
    assert PS.as_str_array(PS.decode_code_points(offsets, bytes_)).tolist() \
        == d.tolist()


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

def _table(seed: int, n: int = 400) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = _words(seed, n)
    null = rng.random(n) < 0.1
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n), pa.int64()),
        "s": pa.array([None if z else w for w, z in zip(words, null)],
                      pa.string())})


def _run(table, build, conf=None):
    """(port, reference, oracle) of `build(E, S, col, A, df)`."""
    jdf = build(JE, JPS, jcol, JA, JSession(conf).from_arrow(table))
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession({**(conf or {}), **ORACLE})) \
        .collect().to_pydict()
    got = build(PE, PPS, pcol, PA, PSession(conf, device="cpu").from_arrow(
        table)).to_pydict()
    return got, ref, oracle


PREDICATES = {
    "starts": lambda E, S, c: S.StartsWith(c("s"), "a"),
    "starts_multibyte": lambda E, S, c: S.StartsWith(c("s"), "日"),
    "ends": lambda E, S, c: S.EndsWith(c("s"), "é"),
    "contains": lambda E, S, c: S.Contains(c("s"), "ab"),
    "contains_4_byte": lambda E, S, c: S.Contains(c("s"), "😀"),
    "empty_pattern": lambda E, S, c: S.Contains(c("s"), ""),
    "longer_than_any": lambda E, S, c: S.StartsWith(c("s"), "a" * 20),
    "null_pattern": lambda E, S, c: S.EndsWith(c("s"), E.Literal(None)),
    # q13's and q16's shape: NOT of a Kleene AND keeps null rows null
    "not_and": lambda E, S, c: E.Not(E.And(S.Contains(c("s"), "a"),
                                           S.Contains(c("s"), "b"))),
}


@pytest.mark.parametrize("name", PREDICATES)
def test_string_predicates_equal_reference_and_cpu_oracle(name):
    fn = PREDICATES[name]
    got, ref, oracle = _run(_table(6), lambda E, S, c, A, df: df.select(
        E.Alias(fn(E, S, c), "r")))
    assert got == ref == oracle


def test_string_predicate_filter_over_several_batches(monkeypatch):
    # 64-row batches share one dictionary: its byte tensors are built once
    built = []
    real = PS.dict_byte_tensors
    monkeypatch.setattr(PS, "dict_byte_tensors",
                        lambda d, dev: built.append(len(d)) or real(d, dev))
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "64"}
    got, ref, oracle = _run(_table(7), lambda E, S, c, A, df: df.filter(
        S.Contains(c("s"), "e")).group_by("k").agg(
            (A.Count(None), "n")).sort("k"), conf)
    assert got == ref == oracle
    assert len(built) == 1


@pytest.mark.parametrize("device_min", ["1", "8192"])
@pytest.mark.parametrize("pos,length", SUBSTRINGS)
def test_substring_equals_reference_and_cpu_oracle(device_min, pos,
                                                   length):
    conf = {DEVICE_MIN: device_min}
    got, ref, oracle = _run(_table(8), lambda E, S, c, A, df: df.select(
        c("k"), E.Alias(S.Substring(c("s"), pos, length), "r")), conf)
    assert got == ref == oracle


@pytest.mark.parametrize("device_min", ["1", "8192"])
def test_substring_codes_group_sort_and_compare_as_strings(device_min):
    # q22's use: the prefix is a group key, an IN operand and a sort key;
    # with duplicates in its dictionary any of these would go wrong
    conf = {DEVICE_MIN: device_min}

    def build(E, S, c, A, df):
        pre = df.select(E.Alias(S.Substring(c("s"), 1, 1), "p"), c("k"))
        return (pre.filter(E.Or(E.In(c("p"), ["a", "é", "😀"]),
                                E.EqualTo(c("p"), E.Literal("g"))))
                .group_by("p").agg((A.Count(None), "n"),
                                   (A.Sum(c("k")), "sk"))
                .sort("p"))
    got, ref, oracle = _run(_table(9, 2000), build, conf)
    assert got == ref == oracle
    assert len(got["p"]) == 4


@pytest.mark.parametrize("device_min", [1, 8192])
def test_substring_dictionary_is_sorted_unique_and_codes_remapped(
        device_min):
    table = _table(10)
    hb = from_arrow(table)
    conf = TpuConf({DEVICE_MIN: str(device_min)})
    db = to_device(hb, conf, device="cpu")
    sub = PPS.Substring(pcol("s"), 2, 2).bind(hb.schema)
    out = evaluate_projection([sub], ["r"], db, conf).column(0)
    d = out.dictionary
    assert len(d) < len(hb.column_by_name("s").dictionary)
    assert np.all(d[:-1] < d[1:])
    valid = out.validity[:hb.num_rows].numpy()
    got = d[out.data[:hb.num_rows].numpy()[valid]].tolist()
    want = [s[1:3] for s in table.column("s").to_pylist() if s is not None]
    assert got == want


def test_string_expressions_refuse_a_pattern_that_is_not_a_literal():
    # the device refuses them with the reference's reasons, so they run
    # on the CPU engine, row by row; the reference's CPU engine reads the
    # missing literal as null (README "Deviations"), the port gives
    # Spark's answer
    table = pa.table({"s": ["ab", "cd", None], "t": ["a", "d", "x"],
                      "i": [2, -1, 1]})
    s = PSession(device="cpu").from_arrow(table)
    j = JSession().from_arrow(table)
    for pe, je, reason, spark in (
            (PPS.StartsWith(pcol("s"), pcol("t")),
             JPS.StartsWith(jcol("s"), jcol("t")),
             "expression StartsWith: search pattern must be a literal",
             [True, False, None]),
            (PPS.Substring(pcol("s"), pcol("i")),
             JPS.Substring(jcol("s"), jcol("i")),
             "expression Substring: argument 1 must be a literal",
             ["b", "d", None])):
        q = s.select(PE.Alias(pe, "r")).physical()
        jq = j.select(JE.Alias(je, "r")).physical()
        assert q.kind == jq.kind == "host"
        assert q.fallback_reasons() == jq.fallback_reasons() == [reason]
        assert q.collect().to_pydict() == {"r": spark}
        assert jq.collect().to_pydict() == {"r": [None, None, None]}


def test_a_failing_device_transform_raises(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("device transform failed")
    monkeypatch.setattr(PS, "transform_dict_device", broken)
    s = PSession({DEVICE_MIN: "1"}, device="cpu").from_arrow(_table(11))
    with pytest.raises(RuntimeError, match="device transform failed"):
        s.select(PE.Alias(PPS.Substring(pcol("s"), 1, 2), "r")).collect()
