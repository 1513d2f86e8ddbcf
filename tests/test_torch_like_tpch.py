"""TPC-H's LIKE text and the strings phase's group-by through the port,
against the JAX package.

The six LIKE forms (`tpch.LIKE_QUERIES`: q2, q9, q13, q14, q16 and q20
with each string predicate as TPC-H v3.0.1 writes it) at scale 0.001 (q2
and q20 at 0.01, where they carry rows) must equal the port's Contains /
StartsWith / EndsWith form of the same query, and the reference's query
on its device path (kernel tier on) and through its CPU oracle.
chip_smoke_strings' `strings_groupby` (customer above the middle name ⋈
orders, grouped by lower(c_mktsegment) and a cast of the phone's country
code) at scale 0.01 must equal the reference's device path, its oracle
and the numpy result the card's run is held to, through the segmented
group-by.  Each
query's kernel wrappers must run chip_smoke.PATH_KERNELS.
"""
import decimal as pydec

import numpy as np
import pytest

import chip_smoke
import chip_smoke_strings as CS

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan import strings as JS
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.session import TpuSession as PSession
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON"}
ORACLE = {"spark.rapids.tpu.sql.enabled": "false"}
LIKE = ("q2", "q9", "q13", "q14", "q16", "q20")
AT_0_01 = ("q2", "q20")
#: q14's DOUBLE ratio, within rtol 1e-12 of the reference's (its decimal
#: -> DOUBLE cast is 1 ulp off for some values, ROADMAP Queue 3 item 1)
DOUBLES = {"q14": ("promo_revenue",)}


@pytest.fixture(scope="module")
def tables():
    return {0.001: (JTPCH.gen_tables(0.001), PTPCH.gen_tables(0.001)),
            0.01: (JTPCH.gen_tables(0.01), PTPCH.gen_tables(0.01))}


def _unscaled(d: dict) -> dict:
    return {k: [int(v.scaleb(-v.as_tuple().exponent))
                if isinstance(v, pydec.Decimal) else v for v in vs]
            for k, vs in d.items()}


def _assert_same(got: dict, want: dict, doubles=()) -> None:
    got, want = _unscaled(got), _unscaled(want)
    assert list(got) == list(want)
    for k in got:
        if k in doubles:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("query", LIKE)
def test_like_form_equals_contains_form_reference_and_oracle(query, tables):
    jt, pt = tables[0.01 if query in AT_0_01 else 0.001]
    jdf = JTPCH.QUERIES[query](JSession(PALLAS_ON), jt)
    dev = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict()
    s = PSession(device="cpu")
    got = PTPCH.LIKE_QUERIES[f"like_{query}"](s, pt).to_pydict()
    plain = PTPCH.QUERIES[query](s, pt).to_pydict()
    doubles = DOUBLES.get(query, ())
    assert got == plain
    _assert_same(got, dev, doubles)
    _assert_same(got, oracle, doubles)
    assert len(next(iter(got.values()))) > 0


def test_strings_groupby_equals_reference_oracle_and_numpy(tables):
    from spark_rapids_tpu_torch.exec.aggregate import GROUPBY_TIERS, \
        reset_groupby_tiers
    jt, pt = tables[0.01]
    jdf = CS.groupby_frame(JE, JS, JA, JT, jcol,
                           JSession(PALLAS_ON).from_arrow(jt["customer"]),
                           JSession(PALLAS_ON).from_arrow(jt["orders"]),
                           jt["customer"].num_rows)
    dev = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession(ORACLE)).collect().to_pydict()
    reset_groupby_tiers()
    got = CS.strings_groupby(PSession(device="cpu"), pt).to_pydict()
    assert GROUPBY_TIERS["segagg"] > 0 and GROUPBY_TIERS["sort"] == 0
    _assert_same(got, dev)
    _assert_same(got, oracle)
    assert _unscaled(got) == CS.expected_groupby(pt)
    assert len(got["segment"]) > 100           # of 5 x 25 buckets


@pytest.mark.parametrize("query", [f"like_{q}" for q in LIKE] +
                         ["strings_groupby"])
def test_strings_query_runs_its_path_kernels(query, tables, monkeypatch):
    from spark_rapids_tpu_torch.ops.hopper import compact as PC
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as PHJ
    from spark_rapids_tpu_torch.ops.hopper import segagg as PSA
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for name in ("build_table", "probe_first", "probe_counts",
                 "expand_pairs"):
        spy(PHJ, name)
    spy(PC, "compaction_order")
    spy(PSA, "seg_sums")
    spy(PSA, "seg_reduce")
    _jt, pt = tables[0.01 if query[5:] in AT_0_01 else 0.001]
    build = CS.strings_groupby if query == "strings_groupby" \
        else CS.like_query(query)
    build(PSession(device="cpu"), pt).collect()
    want = chip_smoke.PATH_KERNELS[query]
    assert want and set(want) <= set(calls), (want, calls)


def test_like_q20_runs_for_the_nation_the_card_holds_to_q20_us(tables):
    _jt, pt = tables[0.01]
    s = PSession(device="cpu")
    got = CS.like_query("like_q20")(s, pt).to_pydict()
    assert got == PTPCH.q20(s, pt, nation="UNITED STATES").to_pydict()
    assert CS.LIKE_OF["like_q20"] == "q20_us"
