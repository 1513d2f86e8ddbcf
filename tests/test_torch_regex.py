"""The regex transpiler and its automaton in the port (ops/regex.py,
RLike / RegexpExtract / RegexpReplace of plan/strings.py) against the
JAX package.

The transpiler is a copy: its DFA tables and accepting sets equal the
reference's element for element over tests/test_regex.py's patterns and
its fuzz, and it rejects what the reference rejects.  The runner is the
port's own (the entries by length, one table lookup a byte): it equals
the reference's `dfa_matches_lanes` run on the CPU, over the same
dictionaries and a seeded fuzz.  Port copies of the rest of the
reference's file hold RLIKE, regexp_extract and regexp_replace on both
engines of the port to the reference's device path and its CPU oracle,
with the reference's placement, the `sql.regexp.maxStates` retry and
the Java replacement syntax.
"""
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops import regex as JR
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import strings as JS
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch.ops import regex as PR
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import strings as PS
from spark_rapids_tpu_torch.session import DataFrame as PDF
from spark_rapids_tpu_torch.session import TpuSession as PSession

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}

#: tests/test_regex.py's patterns and strings
CASES = [
    (r"abc", ["abc", "xxabcxx", "ab", "ABC", ""]),
    (r"^abc$", ["abc", "xabc", "abcx", ""]),
    (r"a+b*c?", ["a", "aab", "bc", "aaabbbc", ""]),
    (r"[a-f0-9]+", ["deadbeef", "xyz", "a1", ""]),
    (r"[^0-9]+", ["abc", "123", "a1", "日本"]),
    (r"(foo|bar)+baz", ["foobaz", "barfoobaz", "baz", "fooba"]),
    (r"\d{3}-\d{4}", ["555-1234", "5551234", "x555-1234y"]),
    (r"a.c", ["abc", "a日c", "ac", "a\nc"]),
    (r"\w+@\w+\.(com|org)", ["x@y.com", "a_b@c.org", "x@y.net", "@.com"]),
    (r"колбаса", ["колбаса", "не колбаса нет", "kolbasa"]),
    (r"^$", ["", "x"]),
    (r"a{2,3}", ["a", "aa", "aaa", "aaaa", "baab"]),
    (r"^(ab|cd)*$", ["", "ab", "abcd", "abc", "cdab"]),
    (r"\s+", [" ", "ab", "a b"]),
    (r"x\.y", ["x.y", "xzy"]),
]
FUZZ_PATTERNS = [r"a+", r"(a|b)+", r"a.b", r"[ab]+[01]+", r"(a0|b1)*$",
                 r"\d+", r"\s"]
REJECTED = [r"(?=x)a", r"(?!x)a", r"(?<=x)a", r"a*?", r"a+?", r"a??",
            r"\bword\b", r"(a)\1", r"a(?i)b", r"x{1000}", r"a$b", r"a^b",
            r"\p{Alpha}", r"[[:digit:]]"]
#: 2^7 subsets of the last seven bytes: past the default 96 states
BLOWUP = r"(a|b)*a(a|b){6}"


def _fuzz_strings(n=200, seed=17):
    rng = np.random.default_rng(seed)
    alphabet = "ab01. "
    return ["".join(rng.choice(list(alphabet), rng.integers(0, 12)))
            for _ in range(n)]


def _lanes(strings):
    data = b"".join(s.encode("utf-8") for s in strings)
    offs = np.zeros(len(strings) + 1, np.int32)
    for i, s in enumerate(strings):
        offs[i + 1] = offs[i] + len(s.encode("utf-8"))
    arr = np.frombuffer(data, np.uint8).copy() if data \
        else np.zeros(0, np.uint8)
    return offs, arr


#: the reference runner's one compiled shape: every call pads its
#: dictionary to these entries and bytes and its DFA to MAX_DFA_STATES
#: (padded states are unreachable, padded entries empty)
REF_ENTRIES, REF_BYTES = 256, 8192
_REF_JIT = []


def _reference_run(dfa, strings):
    import jax
    import jax.numpy as jnp
    if not _REF_JIT:
        _REF_JIT.append(jax.jit(JR.dfa_matches_lanes))
    n = len(strings)
    offs, arr = _lanes(strings)
    assert n <= REF_ENTRIES and len(arr) <= REF_BYTES
    table = np.zeros((JR.MAX_DFA_STATES, 256), np.int16)
    table[:dfa.num_states] = dfa.table
    acc = np.zeros(JR.MAX_DFA_STATES, bool)
    acc[:dfa.num_states] = dfa.accepting
    po = np.full(REF_ENTRIES + 1, offs[-1], np.int32)
    po[:n + 1] = offs
    pb = np.zeros(REF_BYTES, np.uint8)
    pb[:len(arr)] = arr
    out = _REF_JIT[0](jnp.asarray(table.T), jnp.asarray(acc),
                      jnp.asarray(po), jnp.asarray(pb))
    return np.asarray(out)[:n].tolist()


def _port_run(dfa, strings):
    offs, arr = _lanes(strings)
    return PR.dfa_matches(dfa, torch.from_numpy(offs),
                          torch.from_numpy(arr)).tolist()


ALL_PATTERNS = [p for p, _s in CASES] + FUZZ_PATTERNS + [BLOWUP]


@pytest.mark.parametrize("pattern", ALL_PATTERNS)
def test_the_transpiler_builds_the_reference_tables(pattern):
    for search in (True, False):
        kw = {"max_states": 512} if pattern == BLOWUP else {}
        j = JR.compile_dfa(pattern, search=search, **kw)
        p = PR.compile_dfa(pattern, search=search, **kw)
        assert p.table.dtype == j.table.dtype
        np.testing.assert_array_equal(p.table, j.table)
        np.testing.assert_array_equal(p.accepting, j.accepting)
    assert PR.MAX_DFA_STATES == JR.MAX_DFA_STATES == 96
    assert PR.MAX_NFA_STATES == JR.MAX_NFA_STATES
    assert PR.MAX_REPEAT == JR.MAX_REPEAT


@pytest.mark.parametrize("pattern", REJECTED + [BLOWUP])
def test_the_rejections_equal_the_reference(pattern):
    with pytest.raises(JR.RegexUnsupported) as jerr:
        JR.compile_dfa(pattern)
    with pytest.raises(PR.RegexUnsupported) as perr:
        PR.compile_dfa(pattern)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("pattern,strings", CASES)
def test_the_runner_equals_the_reference_and_python(pattern, strings):
    dfa = PR.compile_dfa(pattern)
    got = _port_run(dfa, strings)
    assert got == _reference_run(JR.compile_dfa(pattern), strings)
    assert got == [bool(re.search(pattern, s)) for s in strings]


@pytest.mark.parametrize("pattern", FUZZ_PATTERNS)
def test_the_runner_fuzz_equals_the_reference_and_python(pattern):
    strings = _fuzz_strings()
    dfa = PR.compile_dfa(pattern)
    got = _port_run(dfa, strings)
    assert got == [bool(re.search(pattern, s)) for s in strings]
    assert got == _reference_run(JR.compile_dfa(pattern), strings)


def test_the_runner_over_p_name_like_entries():
    # TPC-H p_name: five of 92 colour words; sorted, duplicate free, with
    # the runner's plan built from the host dictionary
    rng = np.random.default_rng(5)
    words = ["almond", "antique", "green", "forest", "navy", "smoke",
             "spring", "thistle", "lace", "ghost", "日本"]
    d = np.unique(np.array([" ".join(rng.choice(words, 5))
                            for _ in range(200)] + [""], str))
    for pattern in (r"green", r"^forest", r"(lace|ghost)$", r"日本",
                    r"sm.ke sp"):
        dfa = PR.compile_dfa(pattern)
        lengths = PR.utf8_lengths(d)
        assert lengths.tolist() == [len(v.encode("utf-8")) for v in d]
        offs, arr = _lanes(d.tolist())
        order = PR.entry_order(lengths, "cpu")
        assert order.live[0] == int((lengths > 0).sum())
        got = PR.dfa_matches_lanes(
            torch.from_numpy(dfa.table.T.astype(np.int16).copy()),
            torch.from_numpy(dfa.accepting.copy()), torch.from_numpy(offs),
            torch.from_numpy(arr), order).tolist()
        assert got == [bool(re.search(pattern, v)) for v in d.tolist()]
        assert got == _reference_run(JR.compile_dfa(pattern), d.tolist())


# ---------------------------------------------------------------------------
# RLIKE and the regexp functions
# ---------------------------------------------------------------------------

def _project_both(build, data):
    """(port device, port CPU engine, reference device, reference
    oracle) pydicts and the two physical queries, of a projection of
    `build(E, S, col)`'s named expressions over `data`."""
    tbl = pa.table(data)

    def run(E, S, session, frame):
        pairs = build(E, S, E.ColumnRef)
        return session.from_arrow(tbl).select(
            *[e for _n, e in pairs], names=[n for n, _e in pairs])
    pdf = run(PE, PS, PSession(device="cpu"), PDF)
    jdf = run(JE, JS, JSession(), JDF)
    pq, jq = pdf.physical(), jdf.physical()
    return (pq, jq, pdf.collect().to_pydict(),
            PDF(pdf._plan, PSession(ORACLE, device="cpu")).collect()
            .to_pydict(), jq.collect().to_pydict(),
            JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict())


RLIKE_DATA = {"s": ["abc", "abbbc", "ab", None, "xabcx", ""]}


def test_rlike_uses_the_dfa_where_the_transpiler_accepts():
    r = PS.RLike(PE.ColumnRef("s"), r"^ab+c$")
    assert r._dfa is not None
    r2 = PS.RLike(PE.ColumnRef("s"), r"a*?")
    assert r2._dfa is None and "lazy" in r2._reject


@pytest.mark.parametrize("build", [
    lambda E, S, c: [("a", S.RLike(c("s"), r"^ab+c$")),
                     ("b", S.RLike(c("s"), r"b+")),
                     ("lazy", S.RLike(c("s"), r"a*?"))],
    lambda E, S, c: [("e1", S.RegexpExtract(c("s"), r"(\d+)", 1)),
                     ("e2", S.RegexpExtract(c("s"), r"([a-z])(\d+)", 2)),
                     ("none", S.RegexpExtract(c("s"), r"z(\d+)", 1))],
    lambda E, S, c: [("r1", S.RegexpReplace(c("s"), r"\d", "#")),
                     ("r2", S.RegexpReplace(c("s"), r"(\d)", "<$1>")),
                     ("bs", S.RegexpReplace(c("s"), r"\d", "\\\\"))],
], ids=["rlike", "regexp_extract", "regexp_replace"])
def test_the_regexp_family_equals_the_reference(build):
    data = {"s": ["a123b", "xy", None, "c7d88", "abbbc", "a1b2", ""]}
    pq, jq, got, cpu, ref, oracle = _project_both(build, data)
    assert pq.kind == jq.kind == "device"
    assert pq.explain() == jq.explain()
    assert got == cpu == ref == oracle


def test_the_regexp_answers_equal_spark():
    def build(E, S, c):
        return [("e", S.RegexpExtract(c("s"), r"(\d+)", 1)),
                ("r", S.RegexpReplace(c("s"), r"(\d)", "<$1>")),
                ("b", S.RegexpReplace(c("s"), r"\d", "\\\\"))]
    got = _project_both(build, {"s": ["a123b", "xy", None, "a1b"]})[2]
    assert got == {"e": ["123", "", None, "1"],
                   "r": ["a<1><2><3>b", "xy", None, "a<1>b"],
                   "b": ["a\\\\\\b", "xy", None, "a\\b"]}


def test_the_java_replacement_translation_equals_the_reference():
    for rep in ("\\\\", "$1x", "\\$", "a\\nb", "x\\", "$$"):
        assert PS._java_replacement_to_python(rep) == \
            JS._java_replacement_to_python(rep)
    assert PS._java_replacement_to_python("\\$") == "$"


def test_an_invalid_pattern_raises_and_a_rejected_one_is_tagged():
    with pytest.raises(ValueError):
        PS.RegexpExtract(PE.ColumnRef("s"), r"(unclosed", 1)
    pq, jq, got, cpu, ref, oracle = _project_both(
        lambda E, S, c: [("r", S.RegexpReplace(c("s"), r"a*?", "x"))],
        {"s": ["aa", None, "ba"]})
    assert pq.kind == jq.kind == "host"
    assert pq.fallback_reasons() == jq.fallback_reasons()
    assert any("Java-regex subset" in r for r in pq.fallback_reasons())
    assert got == cpu == ref == oracle
    tbl = pa.table({"s": ["a"]})
    pq = PSession(device="cpu").from_arrow(tbl).select(
        PE.Alias(PS.RegexpExtract(PE.ColumnRef("s"), r"(a)", 3), "g")) \
        .physical()
    jq = JSession().from_arrow(tbl).select(
        JE.Alias(JS.RegexpExtract(JE.ColumnRef("s"), r"(a)", 3), "g")) \
        .physical()
    assert pq.kind == jq.kind == "host"
    assert pq.fallback_reasons() == jq.fallback_reasons()


def test_the_state_budget_retries_under_max_states():
    conf = {"spark.rapids.tpu.sql.regexp.maxStates": "512"}
    data = {"s": ["ab" * 5 + "aaaaaaa", "bbbbbbbbb", None, "abbbbbba"]}
    for c in (None, conf):
        r = PS.RLike(PE.ColumnRef("s"), BLOWUP)
        assert r._dfa is None and "state blowup" in r._reject
        tbl = pa.table(data)
        df = PSession(c, device="cpu").from_arrow(tbl).select(
            PE.Alias(r, "m"))
        q = df.physical()
        assert q.kind == "device"
        got = q.collect().to_pydict()["m"]
        assert got == [None if v is None else bool(re.search(BLOWUP, v))
                       for v in data["s"]]
        jr = JS.RLike(JE.ColumnRef("s"), BLOWUP)
        jdf = JSession(c).from_arrow(tbl).select(JE.Alias(jr, "m"))
        assert jdf.collect().to_pydict()["m"] == got
        bound = q.meta.expr_metas[0].expr.children[0]
        # the budget admitted the pattern on the device: no host mask
        assert (bound._dfa is not None) == (c is not None)
