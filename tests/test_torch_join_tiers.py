"""The port's join tiers against the JAX package: the multi-lane sorted
tier (composite keys that do not pack, strings among them), the dense
direct-address tier and the `denseReplace` election.

Each composite key set (two strings, a string and an integer, integers
whose spans do not pack, a DOUBLE with NaN and -0.0 beside an integer,
all with nulls) runs every join type through the reference with its
kernel tier on and through its CPU oracle once, and through the port
under `denseReplace` AUTO, ON and OFF with the join family on and off:
the port must equal the reference row for row in the engines' order and
the oracle once both are sorted (the oracle's pyarrow join equates
neither NaNs nor -0.0 with 0.0, as Spark's joins do, so a DOUBLE key is
held to the reference's device path alone).  The sub-partition join takes composite
keys at a small `sql.batchSizeRows`; the dense tier runs unique and
duplicate builds, a string dictionary's domain, the presence bitmap of
semi and anti joins and both forms of `join.denseBuildViaSort` and
`join.matchedViaMerge`; a hash that collides on purpose must be
verified away.
"""
import warnings

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.ops import join as PJ
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

DENSE = "spark.rapids.tpu.sql.kernels.pallas.join.denseReplace"
JOIN_FAMILY = "spark.rapids.tpu.sql.kernels.pallas.join"
PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON",
             DENSE: "ON"}
HOWS = ["inner", "left_outer", "right_outer", "full_outer", "left_semi",
        "left_anti"]
#: the port's confs each case runs under: the election's three modes with
#: the join family on, and the family off (where no mode elects a table)
PORT_CONFS = [{DENSE: m} for m in ("AUTO", "ON", "OFF")] + \
    [{JOIN_FAMILY: "OFF"}]
_BIG = np.array([-(2 ** 62), -(2 ** 40) + 3, -7, 0, 5, 2 ** 33, 2 ** 61,
                 2 ** 62 + 11], np.int64)
_DOUBLES = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 1e300, np.inf])


def _side(n: int, seed: int, strings, null_rate=0.06) -> pa.Table:
    rng = np.random.default_rng(seed)

    def m():
        return rng.random(n) < null_rate
    d = rng.choice(_DOUBLES, n)
    # a NaN with another payload must equal the canonical one
    other_nan = np.array([0x7FF8000000000001], np.int64).view(np.float64)
    d = np.where(np.isnan(d) & (rng.random(n) < 0.5), other_nan[0], d)
    return pa.table({
        "s1": pa.array(rng.choice(strings, n), mask=m()),
        "s2": pa.array(rng.choice(["x", "yy", "zzz"], n), mask=m()),
        "i": pa.array(rng.integers(0, 6, n), pa.int64(), mask=m()),
        "big": pa.array(rng.choice(_BIG, n), mask=m()),
        "d": pa.array(d, mask=m()),
        "v": pa.array(np.arange(n) + seed * 100_000, pa.int64())})


PROBE = _side(900, 1, ["a", "b", "c", "dd", "e"])
BUILD = _side(160, 2, ["a", "b", "c", "dd", "zz"])
KEYS = {"str2": (["s1", "s2"], ["s1", "s2"]),
        "str_int": (["s1", "i"], ["s1", "i"]),
        "wide_ints": (["big", "i"], ["big", "i"]),
        "double_int": (["d", "i"], ["d", "i"])}


def _rows(d):
    return {k: [repr(v) for v in vs] for k, vs in d.items()}


def _sorted(d):
    return sorted(zip(*d.values()))


def _port(build, conf=None):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = PSession({**PALLAS_ON, **(conf or {})}, device="cpu")
    return _rows(build(PE, pcol, s).to_pydict())


def _reference(build, conf=None):
    conf = {**PALLAS_ON, **(conf or {})}
    want = build(JE, jcol, JSession(conf)).collect().to_pydict()
    cpu = JDF(build(JE, jcol, JSession(conf))._plan, JSession(
        {"spark.rapids.tpu.sql.enabled": "false"})).collect().to_pydict()
    return _rows(want), _rows(cpu)


def _metrics(build, conf=None):
    q = build(PE, pcol, PSession({**PALLAS_ON, **(conf or {})},
                                 device="cpu")).physical()
    ctx = PCtx(q.conf, q.device)
    q.collect(ctx)
    return ctx.metrics


def _join(probe, build_t, how, keys):
    lk, rk = keys

    def build(e, c, s):
        return s.from_arrow(probe).join(s.from_arrow(build_t), how=how,
                                        left_on=lk, right_on=rk)
    return build


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("key", sorted(KEYS))
def test_composite_keys_every_type_and_tier_match_reference(key, how):
    build = _join(PROBE, BUILD, how, KEYS[key])
    want, cpu = _reference(build)
    assert len(next(iter(want.values()))) > 0 or how == "left_semi"
    for conf in PORT_CONFS:
        got = _port(build, conf)
        assert got == want, (key, how, conf)
    if key != "double_int":
        # the oracle's pyarrow join equates neither NaNs nor -0.0 with
        # 0.0, which Spark's joins do: DOUBLE keys are held to the
        # reference's device path
        assert _sorted(got) == _sorted(cpu)
    if how in ("inner", "left_outer"):
        # the multi-lane tier ran: the kernel election found several lanes
        m = _metrics(build)
        assert m.get("kernel_fallback.hash_probe_join.multi_lane", 0) >= 1


@pytest.mark.parametrize("key", ["str2", "wide_ints"])
def test_composite_keys_sub_partition_join_matches_reference(key):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "128"}
    big_build = _side(600, 3, ["a", "b", "c", "dd", "zz"])
    for how in ("inner", "full_outer"):
        build = _join(PROBE, big_build, how, KEYS[key])
        want, cpu = _reference(build, conf)
        got = _port(build, conf)
        assert got == want, how
        assert _sorted(got) == _sorted(cpu)
        m = _metrics(build, {**conf,
                             "spark.rapids.tpu.sql.adaptive.enabled": "false"})
        assert m.get("join_subpartition_fallbacks", 0) >= 1


def test_forced_hash_collisions_are_verified_away(monkeypatch):
    real = PJ.composite_hash
    # four buckets for every key: almost every candidate is a collision
    monkeypatch.setattr(PJ, "composite_hash",
                        lambda lanes: real(lanes) & 3 if len(lanes) > 1
                        else real(lanes))
    for key in ("str_int", "wide_ints"):
        for how in ("inner", "right_outer", "left_semi", "left_anti"):
            build = _join(PROBE, BUILD, how, KEYS[key])
            want, _cpu = _reference(build)
            assert _port(build, {DENSE: "OFF"}) == want, (key, how)


# ---------------------------------------------------------------------------
# the dense direct-address tier
# ---------------------------------------------------------------------------

def _dense_tables(unique: bool):
    rng = np.random.default_rng(7)
    n = 1200
    fk = rng.integers(-30, 530, n)
    dk = rng.permutation(500) if unique else rng.integers(0, 500, 700)
    nb = len(dk)
    return (pa.table({"fk": pa.array(fk, mask=rng.random(n) < 0.05),
                      "tag": pa.array(rng.choice(["p", "q", "r", "s"], n)),
                      "x": pa.array(np.arange(n), pa.int64())}),
            pa.table({"dk": pa.array(dk, pa.int64(),
                                     mask=rng.random(nb) < 0.03),
                      "attr": pa.array(rng.choice(["p", "q", "zz"], nb)),
                      "w": pa.array(np.arange(nb) * 3, pa.int64())}))


DENSE_FORMS = [{}, {"spark.rapids.tpu.sql.join.denseBuildViaSort": "false"},
               {"spark.rapids.tpu.sql.join.matchedViaMerge": "false"},
               {"spark.rapids.tpu.sql.join.matchedViaPresence": "false"}]


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("how", HOWS)
def test_dense_tier_matches_reference(unique, how):
    fact, dim = _dense_tables(unique)
    no_aqe = {"spark.rapids.tpu.sql.adaptive.enabled": "false"}
    build = _join(fact, dim, how, (["fk"], ["dk"]))
    want, cpu = _reference(build, no_aqe)
    assert _sorted(want) == _sorted(cpu)
    for form in DENSE_FORMS:
        for mode in ("AUTO", "OFF"):
            conf = {**no_aqe, **form, DENSE: mode}
            assert _port(build, conf) == want, (form, mode)
    m = _metrics(build, {**no_aqe, DENSE: "AUTO"})
    assert m.get("join_dense_domain", 0) == 1
    assert "join_pallas_hash" not in m
    if how in ("left_semi", "left_anti"):
        assert m.get("kernel_fallback.hash_probe_join.dense_matched") == 1
    else:
        assert m.get("kernel_fallback.hash_probe_join.dense_domain") == 1
    # ON keeps the hash table (the port's default)
    m = _metrics(build, no_aqe)
    assert m.get("join_pallas_hash") == 1 and "join_dense_domain" not in m


@pytest.mark.parametrize("how", ["inner", "left_outer", "full_outer",
                                 "left_semi", "left_anti"])
def test_dense_tier_over_a_string_dictionary_matches_reference(how):
    fact, dim = _dense_tables(False)
    build = _join(fact, dim, how, (["tag"], ["attr"]))
    want, cpu = _reference(build)
    assert _sorted(want) == _sorted(cpu)
    for mode in ("AUTO", "ON", "OFF"):
        assert _port(build, {DENSE: mode}) == want, mode
    assert _metrics(build, {DENSE: "OFF"}).get("join_dense_domain") == 1


def test_auto_replaces_a_wide_span_and_off_never_does():
    rng = np.random.default_rng(3)
    fact = pa.table({"fk": pa.array(rng.integers(0, 220, 2000) * 5000)})
    dim = pa.table({"dk": pa.array(np.arange(0, 1_000_000, 5000),
                                   pa.int64()),
                    "w": pa.array(np.arange(200), pa.int64())})
    no_aqe = {"spark.rapids.tpu.sql.adaptive.enabled": "false"}
    build = _join(fact, dim, "inner", (["fk"], ["dk"]))
    want, _cpu = _reference(build, no_aqe)
    # a span of 995,001 keys over a 1,024-row build: past 4x, AUTO elects
    m = _metrics(build, {**no_aqe, DENSE: "AUTO"})
    assert m.get("join_pallas_hash") == 1 and "join_dense_domain" not in m
    m = _metrics(build, {**no_aqe, DENSE: "OFF"})
    assert m.get("join_dense_domain") == 1
    for mode in ("AUTO", "OFF"):
        assert _port(build, {**no_aqe, DENSE: mode}) == want
