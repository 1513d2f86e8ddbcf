"""The dense no-sort group-by tier (ops/groupby.dense_groupby_trace)
against the JAX package's, and TPC-DS q7, q26, q56 and q60 at scale 0.1,
where it runs.

A group-by whose keys are all dictionary codes or booleans, with a
bucket product between `segagg.maxDomain` (1,024) and
`sql.agg.denseDomainMax` (4,096), runs the dense tier in the reference
(`exec/aggregate._run_groupby`).  Here the keys are a 1,800-entry
dictionary (TPC-DS i_item_id's count at scale 0.1) alone (1,801
buckets) and a 1,300-entry one beside a boolean (1,301 x 3 = 3,903
buckets: 1,800 x a boolean would be 5,403, past the dense window, and
sort in both packages), over 20,000 rows made from a numpy seed, in one
batch and in several.  The port (CPU tensors) must equal the reference's device path
exactly, group order and DOUBLE sums included (both add each bucket's
rows in row order on the CPU), and its CPU oracle with DOUBLE columns
within rtol 1e-12 after sorting by the keys.
"""
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest

import torch_tpcds_parity as TP

from spark_rapids_tpu import tpcds as JDS
from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import tpcds as PDS
from spark_rapids_tpu_torch.exec import aggregate as PAGG
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ROWS = 20_000
NAMES = 1_800


def _table(seed: int = 13, n_names: int = NAMES) -> pa.Table:
    rng = np.random.default_rng(seed)
    names = np.array([f"AAAAAAAA{i:08d}" for i in range(n_names)])
    k = names[rng.integers(0, n_names, ROWS)].astype(object)
    k[rng.random(ROWS) < 0.02] = None
    f = rng.standard_normal(ROWS) * 100.0
    f[rng.random(ROWS) < 0.01] = np.nan
    f[rng.random(ROWS) < 0.01] = 0.0
    f[rng.random(ROWS) < 0.01] = -0.0
    f[rng.random(ROWS) < 0.002] = np.inf
    return pa.table({
        "k": pa.array(k.tolist(), pa.string()),
        "b": pa.array(rng.random(ROWS) < 0.5, mask=rng.random(ROWS) < 0.05),
        "x": pa.array(rng.integers(-10 ** 12, 10 ** 12, ROWS), pa.int64(),
                      mask=rng.random(ROWS) < 0.05),
        "i": pa.array(rng.integers(-1000, 1000, ROWS).astype(np.int32),
                      pa.int32()),
        "f": pa.array(f, mask=rng.random(ROWS) < 0.05),
        "d": pa.array([pydec.Decimal(int(v)).scaleb(-2) for v in
                       rng.integers(-10 ** 9, 10 ** 9, ROWS)],
                      pa.decimal128(12, 2)),
    })


def _aggs(A, c):
    return [(A.Sum(c("x")), "sx"), (A.Sum(c("f")), "sf"),
            (A.Sum(c("d")), "sd"), (A.Count(None), "n"),
            (A.Count(c("f")), "nf"), (A.Average(c("i")), "ai"),
            (A.Min(c("f")), "minf"), (A.Max(c("f")), "maxf"),
            (A.Min(c("x")), "minx"), (A.Max(c("i")), "maxi"),
            (A.Min(c("b")), "minb"), (A.Max(c("d")), "maxd"),
            (A.First(c("i")), "fi"), (A.Last(c("x")), "lx"),
            (A.First(c("f"), ignore_nulls=True), "ff"),
            (A.Last(c("f"), ignore_nulls=True), "lf"),
            (A.BoolOr(c("b")), "any"), (A.BoolAnd(c("b")), "every")]


#: keys -> (key columns, dictionary entries)
KEYS = {"dict1800": (("k",), NAMES), "dict1300_x_bool": (("k", "b"), 1300)}


def _sorted(d: dict, keys) -> dict:
    rows = list(zip(*d.values()))
    idx = {n: i for i, n in enumerate(d)}
    rows.sort(key=lambda r: tuple((r[idx[k]] is None, r[idx[k]])
                                  for k in keys))
    return {n: [r[i] for r in rows] for n, i in idx.items()}


@pytest.mark.parametrize("batch_rows", [None, "4096"])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_dense_tier_equals_reference_and_cpu_oracle(keys, batch_rows):
    ks, n_names = KEYS[keys]
    table = _table(n_names=n_names)
    conf = dict(TP.PALLAS_ON)
    if batch_rows:
        conf["spark.rapids.tpu.sql.batchSizeRows"] = batch_rows
    jdf = JSession(conf).from_arrow(table).group_by(*ks).agg(
        *_aggs(JA, jcol))
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession(
        {**conf, "spark.rapids.tpu.sql.enabled": "false"})) \
        .collect().to_pydict()
    PAGG.reset_groupby_tiers()
    got = PSession(conf, device="cpu").from_arrow(table).group_by(*ks) \
        .agg(*_aggs(PA, pcol)).to_pydict()
    assert PAGG.GROUPBY_TIERS["dense"] > 0
    assert PAGG.GROUPBY_TIERS["sort"] == PAGG.GROUPBY_TIERS["segagg"] == 0
    # FIRST/LAST ignoring nulls of a group with no non-null value: the
    # reference keeps the clamped row (the batch's last for FIRST, its
    # first for LAST) and that row's validity (ROADMAP Queue 3 item 9);
    # the port follows the oracle, below
    skip = ("ff", "lf")
    mine = {n: v for n, v in got.items() if n not in skip}
    theirs = {n: v for n, v in ref.items() if n not in skip}
    # the same groups in the same order in one batch; DOUBLE bits equal
    # (ulps=0).  Over several batches the merge regroups codes of unified
    # dictionaries, which the port keeps sorted and the reference in
    # first-seen order: the same groups, ordered by key
    if batch_rows:
        TP.assert_same(_sorted(mine, ks), _sorted(theirs, ks), ulps=0)
    else:
        TP.assert_same(mine, theirs, ulps=0)
    # LAST over nulls: the oracle skips them, the reference and the port
    # keep the last row's null (ROADMAP: held to the reference)
    TP.assert_same(_sorted({n: v for n, v in got.items() if n != "lx"}, ks),
                   _sorted({n: v for n, v in oracle.items() if n != "lx"},
                           ks))
    assert len(got["n"]) > n_names // 2


def test_dense_domain_via_sort_gives_the_same_groups():
    """`sql.agg.denseDomainViaSort=true` sorts the same keys through the
    packed lane: the same groups (a null key sorts first there and
    comes after its key's values in the dense tier, in both packages)."""
    table = _table(5, 1300)
    conf = {**TP.PALLAS_ON,
            "spark.rapids.tpu.sql.agg.denseDomainViaSort": "true"}
    aggs = [(PA.Sum(pcol("x")), "sx"), (PA.Count(None), "n"),
            (PA.Max(pcol("f")), "maxf")]
    PAGG.reset_groupby_tiers()
    sort = PSession(conf, device="cpu").from_arrow(table) \
        .group_by("k", "b").agg(*aggs).to_pydict()
    assert PAGG.GROUPBY_TIERS["sort"] > 0 and \
        PAGG.GROUPBY_TIERS["dense"] == 0
    dense = PSession(TP.PALLAS_ON, device="cpu").from_arrow(table) \
        .group_by("k", "b").agg(*aggs).to_pydict()
    TP.assert_same(_sorted(dense, ("k", "b")), _sorted(sort, ("k", "b")),
                   ulps=0)


DS_SCALE = 0.1
DENSE_QUERIES = ("q7", "q26", "q56", "q60")


@pytest.fixture(scope="module")
def ds_tables():
    return JDS.gen_tables(DS_SCALE), PDS.gen_tables(DS_SCALE)


@pytest.mark.parametrize("query", DENSE_QUERIES)
def test_tpcds_at_scale_0_1_runs_the_dense_tier(ds_tables, query):
    """At scale 0.1 i_item_id has 1,800 values: these four queries group
    by it in the dense window (they raised NotImplementedError before
    the tier was ported)."""
    jt, pt = ds_tables
    dev, cpu = TP.reference_results([query], jt)[query]
    PAGG.reset_groupby_tiers()
    got = PDS.QUERIES[query](PSession(device="cpu"), pt).to_pydict()
    assert PAGG.GROUPBY_TIERS["dense"] > 0
    TP.assert_same(got, dev, ulps=TP.DEVICE_ULPS)
    TP.assert_same(got, cpu)
    assert len(next(iter(got.values()))) > 0
