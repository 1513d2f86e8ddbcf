"""The port's joins, string-literal predicates, limits and top-N against
the JAX package.

Every equi-join type (inner, left/right/full outer, left semi, left
anti) over unique and duplicate-heavy build sides, on one key column and
on a range-packed composite key, with the adaptive join on and off, plus
empty build sides, all-null probe keys and filters fused on both sides,
runs through the port (CPU tensors, the kernels' plain versions) and
through the JAX package with its kernel tier on and `denseReplace: ON`,
so it takes the same hash-table tier, and through its CPU oracle.  The
port must equal the JAX package row for row in the engines' own order
(results are left unsorted), and the CPU oracle row for row once both
are sorted (its pyarrow engine orders join output otherwise).  Every
join the port does not run raises NotImplementedError naming the slice
that ports it; with the kernel tier off the sorted tier runs the join,
and composite keys that do not pack run the multi-lane sorted tier.
"""
import warnings

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import config as PCONF
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON",
             "spark.rapids.tpu.sql.kernels.pallas.join.denseReplace": "ON"}
SMALL = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}


def _typed(arr, key_type):
    return arr.cast(pa.int32()).cast(key_type) \
        if pa.types.is_date(key_type) else arr.cast(key_type)


def _fact(n, seed, key_type=pa.int64()):
    rng = np.random.default_rng(seed)
    fk = rng.integers(-20, 420, n)               # some keys miss the dim
    return pa.table({
        "fk": _typed(pa.array(fk, mask=rng.random(n) < 0.05), key_type),
        "x": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "f": pa.array(rng.standard_normal(n)),
        "tag": pa.array(rng.choice(["p", "q", "r"], n))})


def _dim(n=400, seed=0, key_type=pa.int64()):
    rng = np.random.default_rng(seed)
    return pa.table({
        "dk": _typed(pa.array(rng.permutation(n)), key_type),
        "attr": pa.array(rng.choice(["a", "b", "c", "BUILDING"], n)),
        "w": pa.array(rng.integers(0, 10 ** 6, n), pa.int64())})


def _rows(d):
    return {k: [repr(v) for v in vs] for k, vs in d.items()}


def _run(build, jconf=None, pconf=None):
    """(port, reference, CPU oracle) results of one query function."""
    jconf = {**PALLAS_ON, **(jconf or {})}
    want = build(JE, jcol, JSession(jconf)).collect().to_pydict()
    cpu = JDF(build(JE, jcol, JSession(jconf))._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # denseReplace: resolved
        got = build(PE, pcol, PSession({**jconf, **(pconf or {})},
                                       device="cpu")).to_pydict()
    return _rows(got), _rows(want), _rows(cpu)


# without adaptivity the right side builds, so only fact ⋈ dim runs there
@pytest.mark.parametrize("fact_left,conf", [
    (True, {}), (False, {}), (True, SMALL), (False, SMALL),
    (True, {"spark.rapids.tpu.sql.adaptive.enabled": "false"})])
def test_fact_dim_inner_join_with_fused_filters_matches_reference(
        fact_left, conf):
    fact, dim = _fact(3000, 1), _dim()

    def build(e, c, s):
        f = s.from_arrow(fact).filter(e.GreaterThan(c("x"), e.Literal(-50)))
        d = s.from_arrow(dim).filter(e.NotEqual(c("attr"), e.Literal("c")))
        if fact_left:
            return f.join(d, left_on=["fk"], right_on=["dk"])
        return d.join(f, left_on=["dk"], right_on=["fk"])
    got, want, cpu = _run(build, conf)
    assert got == want
    assert sorted(zip(*got.values())) == sorted(zip(*cpu.values()))


@pytest.mark.parametrize("key_type", [pa.int32(), pa.date32(), pa.int16()])
def test_join_on_narrow_and_date_keys_matches_reference(key_type):
    fact, dim = _fact(2000, 3, key_type), _dim(400, 4, key_type)

    def build(e, c, s):
        return (s.from_arrow(fact).join(s.from_arrow(dim), left_on=["fk"],
                                        right_on=["dk"])
                .select(c("fk"), c("x"), c("w")))
    got, want, cpu = _run(build)
    assert got == want
    assert sorted(zip(*got.values())) == sorted(zip(*cpu.values()))


def test_join_on_double_keys_folds_signed_zero_and_nan():
    left = pa.table({"k": pa.array([0.0, -0.0, float("nan"), 1.5, None, 2.0]),
                     "i": pa.array(range(6), pa.int64())})
    right = pa.table({"d": pa.array([-0.0, float("nan"), 1.5, 7.0]),
                      "j": pa.array(range(4), pa.int64())})

    def build(e, c, s):
        return s.from_arrow(left).join(s.from_arrow(right), left_on=["k"],
                                       right_on=["d"]).select(c("i"), c("j"))
    got, want, _cpu = _run(build)
    assert got == want
    assert got["i"] == ["0", "1", "2", "3"]


def test_q3_shaped_join_chain_then_aggregate_top_n():
    # a join whose unique side gives no output column: both engines
    # rewrite it into a left semi join of the other side
    fact, dim = _fact(5000, 7), _dim(400, 8)

    def build(e, a_mod, c, s):
        j = (s.from_arrow(dim).filter(e.EqualTo(c("attr"),
                                                e.Literal("BUILDING")))
             .join(s.from_arrow(fact), left_on=["dk"], right_on=["fk"]))
        return (j.group_by("fk").agg((a_mod.Sum(c("x")), "sx"))
                .sort(("sx", False, False), "fk").limit(7))
    from spark_rapids_tpu.plan import aggregates as JA
    from spark_rapids_tpu_torch.plan import aggregates as PA
    got, want, cpu = _run(lambda e, c, s: build(
        e, JA if e is JE else PA, c, s), SMALL)
    assert got == want == cpu


def test_string_ordering_and_if_between_columns_fall_back():
    # a string ordering against a literal runs on the device; between two
    # columns, and a string-valued IF, the reference's tagging puts them
    # on its CPU engine, and the port's runs them
    fact, dim = _fact(3000, 1), _dim()
    cases = [
        (lambda e, c: e.LessThan(c("tag"), c("attr")),
         "string ordering comparison not yet on device"),
        (lambda e, c: e.GreaterThanOrEqual(c("attr"), c("tag")),
         "string ordering comparison not yet on device"),
        (lambda e, c: e.If(e.IsNull(c("fk")), c("attr"), c("tag")),
         "string-valued if not yet on device")]
    for make, reason in cases:
        def build(e, c, s):
            j = s.from_arrow(fact).join(s.from_arrow(dim), left_on=["fk"],
                                        right_on=["dk"], how="left_outer")
            return j.select(c("x"), e.Alias(make(e, c), "r")).sort("x")
        got, want, cpu = _run(build)
        assert sorted(zip(*got.values())) == sorted(zip(*want.values())) \
            == sorted(zip(*cpu.values()))
        q = build(PE, pcol, PSession(device="cpu")).physical()
        # the projection under the sort carries the reference's reason
        name = type(make(PE, pcol)).__name__
        assert q.meta.children[0].reasons == [f"expression {name}: {reason}"]


def test_string_literal_equality_matches_reference():
    t = pa.table({"s": pa.array(["a", None, "b", "a", "zz", None, "b"]),
                  "i": pa.array(range(7), pa.int64())})
    null_str = (lambda e: e.Literal(None, None))

    def build(e, c, s):
        return s.from_arrow(t).select(
            e.Alias(e.EqualTo(c("s"), e.Literal("a")), "eq"),
            e.Alias(e.NotEqual(c("s"), e.Literal("b")), "ne"),
            e.Alias(e.EqualTo(e.Literal("zz"), c("s")), "eq_flipped"),
            e.Alias(e.EqualTo(c("s"), e.Literal("absent")), "absent"),
            e.Alias(e.NotEqual(c("s"), e.Literal("absent")), "ne_absent"),
            e.Alias(e.EqualTo(c("s"), null_str(e)), "null_lit"),
            c("i"))
    got, want, cpu = _run(build)
    assert got == want == cpu


def test_unported_joins_and_predicates_refuse_naming_their_slice():
    fact, dim = _fact(3000, 1), _dim()
    s = PSession(device="cpu")
    f, d = s.from_arrow(fact), s.from_arrow(dim)
    with pytest.raises(NotImplementedError, match="unsupported join type"):
        f.join(d, how="right_semi", left_on=["fk"],
               right_on=["dk"]).collect()
    # composite keys that do not pack (computed keys without an exact
    # range, a string beside an integer, a DOUBLE) run the multi-lane
    # sorted tier, with the reference's rows in its order
    dim = dim.append_column("tag2", pa.array(
        np.array(["p", "q", "r"])[np.arange(dim.num_rows) % 3]))
    cases = [
        lambda e, c: ([e.Cast(c("fk"), PT.DOUBLE if e is PE else
                              JT.DOUBLE), c("x")],
                      [e.Cast(c("dk"), PT.DOUBLE if e is PE else JT.DOUBLE),
                       c("w")]),
        lambda e, c: (["tag", "fk"], ["tag2", "dk"]),
        lambda e, c: (["fk", "f"],
                      ["dk", e.Cast(c("w"), PT.DOUBLE if e is PE else
                                    JT.DOUBLE)]),
    ]
    for keys in cases:
        def build(e, c, s, keys=keys):
            lk, rk = keys(e, c)
            return s.from_arrow(fact).join(s.from_arrow(dim), left_on=lk,
                                           right_on=rk)
        got, want, cpu = _run(build)
        assert got == want
        assert sorted(zip(*got.values())) == sorted(zip(*cpu.values()))
    got, want, _cpu = _run(lambda e, c, s: s.from_arrow(fact).join(
        s.from_arrow(dim), left_on=["tag", "fk"], right_on=["tag2", "dk"]))
    assert got == want and len(got["fk"]) > 0
    # the kernel tier off, or a build over join.maxBuildRows, no longer
    # refuses: the sorted tier takes the join, with the hash-table
    # tier's rows in its order
    hashed = PSession(device="cpu").from_arrow(fact).join(
        PSession(device="cpu").from_arrow(dim), left_on=["fk"],
        right_on=["dk"]).to_pydict()
    off = PSession({"spark.rapids.tpu.sql.kernels.pallas.enabled": "false"},
                   device="cpu")
    tiny = PSession({"spark.rapids.tpu.sql.kernels.pallas.join.maxBuildRows":
                     "16"}, device="cpu")
    for sess in (off, tiny):
        got = sess.from_arrow(fact).join(sess.from_arrow(dim), left_on=["fk"],
                                         right_on=["dk"]).to_pydict()
        assert _rows(got) == _rows(hashed) and len(got["fk"]) > 0
    # a build over 2 x sql.batchSizeRows no longer refuses: it runs the
    # sub-partition join, in the reference's bucket order
    got, want, cpu = _run(lambda e, c, s: s.from_arrow(fact).join(
        s.from_arrow(_dim(3000)), left_on=["fk"], right_on=["dk"]), SMALL)
    assert got == want and len(got["fk"]) > 0
    assert sorted(zip(*got.values())) == sorted(zip(*cpu.values()))


HOWS = ["inner", "left_outer", "right_outer", "full_outer", "left_semi",
        "left_anti"]
NO_ADAPTIVE = {"spark.rapids.tpu.sql.adaptive.enabled": "false"}


def _probe_side(n=700, seed=21, null_keys=False):
    rng = np.random.default_rng(seed)
    fk = rng.integers(-5, 45, n)                 # some keys miss the build
    mask = np.ones(n, bool) if null_keys else rng.random(n) < 0.05
    return pa.table({
        "fk": pa.array(fk, pa.int64(), mask=mask),
        "g": pa.array(rng.integers(0, 3, n), pa.int64()),
        "x": pa.array(np.arange(n), pa.int64()),
        "tag": pa.array(rng.choice(["p", "q", "r"], n))})


def _build_side(kind, seed=22):
    """`unique`: 40 distinct keys, unique alone and with `h`; `dups`:
    1,200 rows over 30 keys (about 40 rows a key) — more bytes than the
    700-row probe side, so the adaptive join swaps the inner and outer
    joins."""
    rng = np.random.default_rng(seed)
    if kind == "unique":
        dk, n = rng.permutation(40), 40
    elif kind == "dups":
        n = 1200
        dk = rng.integers(0, 30, n)
    else:                                        # empty
        dk, n = np.zeros(0, np.int64), 0
    return pa.table({
        "dk": pa.array(dk, pa.int64()),
        "h": pa.array(rng.integers(0, 3, n), pa.int64()),
        "y": pa.array(np.arange(n) * 7, pa.int64()),
        "attr": pa.array(rng.choice(["a", "b"], n) if n else [], pa.string())})


KEYS = {"single": (["fk"], ["dk"]), "packed": (["fk", "g"], ["dk", "h"])}


def _check_join(probe, build, how, keys, conf=None, fuse=False):
    lk, rk = KEYS[keys]

    def q(e, c, s):
        p, b = s.from_arrow(probe), s.from_arrow(build)
        if fuse:
            p = p.filter(e.GreaterThan(c("x"), e.Literal(1800)))
            b = b.filter(e.NotEqual(c("attr"), e.Literal("b")))
        return p.join(b, left_on=lk, right_on=rk, how=how)
    got, want, cpu = _run(q, conf)
    assert got == want
    assert sorted(zip(*got.values())) == sorted(zip(*cpu.values()))
    return got


@pytest.mark.parametrize("keys", ["single", "packed"])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("build", ["unique", "dups"])
@pytest.mark.parametrize("how", HOWS)
def test_join_type_matches_reference_and_cpu_oracle(how, build, adaptive,
                                                    keys):
    got = _check_join(_probe_side(), _build_side(build), how, keys,
                      None if adaptive else NO_ADAPTIVE)
    assert len(got["x"]) > 0


@pytest.mark.parametrize("how", HOWS)
def test_join_with_an_empty_build_side_matches_reference(how):
    got = _check_join(_probe_side(300), _build_side("empty"), how, "single")
    keeps_probe = how in ("left_outer", "full_outer", "left_anti")
    assert len(got["x"]) == (300 if keeps_probe else 0)


@pytest.mark.parametrize("how", HOWS)
def test_join_with_all_null_probe_keys_matches_reference(how):
    got = _check_join(_probe_side(300, null_keys=True), _build_side("dups"),
                      how, "single")
    # null keys match nothing: no row pairs a probe row with a build row
    if how in ("inner", "left_semi"):
        assert not got["x"]
    elif how == "left_anti":
        assert len(got["x"]) == 300
    else:
        assert all("None" in (x, y) for x, y in zip(got["x"], got["y"]))


@pytest.mark.parametrize("how", HOWS)
def test_join_with_filters_fused_on_both_sides_matches_reference(how):
    # 1,024-row batches: three probe batches and a concatenated build
    _check_join(_probe_side(2500), _build_side("dups"), how, "packed",
                SMALL, fuse=True)


@pytest.mark.parametrize("conf", [{}, SMALL])
def test_limit_and_top_n_match_reference(conf):
    fact = _fact(4000, 12)

    def limit(e, c, s):
        return s.from_arrow(fact).filter(
            e.GreaterThan(c("x"), e.Literal(10))).limit(37)

    def top(e, c, s):
        # many ties on x: the stable sorts keep input order among them
        return s.from_arrow(fact).sort(("x", False, False)).limit(25)
    for build in (limit, top):
        got, want, cpu = _run(build, conf)
        assert got == want == cpu


def test_conf_warns_once_for_keys_the_port_does_not_honour():
    # the mesh SPMD path (ROADMAP Queue 1 item 9) is not ported
    key = "spark.rapids.tpu.sql.mesh.enabled"
    assert key not in PCONF.HONOURED_KEYS
    PCONF._WARNED.discard(key)
    with pytest.warns(UserWarning, match="not honoured"):
        PCONF.TpuConf({key: "OFF"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        PCONF.TpuConf({key: "OFF"})                   # once per key
        PCONF.TpuConf({"spark.rapids.tpu.sql.batchSizeRows": "1024",
                       "spark.rapids.tpu.sql.adaptive.enabled": "false"})
    assert PCONF.RESOLVED.keys() <= PCONF._REGISTRY.keys()
    assert PCONF.HONOURED_KEYS.isdisjoint(PCONF.RESOLVED)
