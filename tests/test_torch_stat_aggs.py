"""The seven statistical aggregates (var_pop, var_samp, stddev_pop,
stddev_samp, covar_pop, covar_samp, corr) against the JAX package,
grouped on each group-by tier and global.

They lower to COUNT and SUM over projected moments and a final
expression, as the reference composes them, so the tiers run them
unchanged: a 6-value dictionary key elects the segmented-aggregation
kernels (their plain versions on CPU tensors), `segagg OFF` the dense
tier, `segagg OFF` with `denseDomainViaSort` the sorted group-by.  The
input (a numpy seed) has a group with no non-null value (n = 0: null),
one with a single row (n = 1: null for the sample forms and corr's
zero variance: NaN, as Spark) and a constant one (variance 0, corr NaN).

Tolerances: the port equals the reference's device path within rtol
1e-12 (both add the same moments; the order of the float64 sums may
differ by tier), and the CPU oracle within rtol 1e-9 (the oracle sums
squared deviations from the mean in two passes, the moment form
ss - s^2/n loses digits to cancellation); both with an absolute 1e-9,
for a constant column's covariance, exactly 0 in the oracle and a
cancellation residue (about 1e-13) in the moment form of either package.
"""
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.exec import aggregate as PAGG
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

ROWS = 3000
ATOL = 1e-9


def _table(seed: int = 21) -> pa.Table:
    rng = np.random.default_rng(seed)
    k = rng.choice(np.array(["a", "b", "c", "d"]), ROWS).astype(object)
    x = rng.standard_normal(ROWS) * 10.0 + 3.0
    xm = rng.random(ROWS) < 0.1
    y = rng.integers(-1000, 1000, ROWS)
    ym = rng.random(ROWS) < 0.1
    k[:7] = "one"              # n = 1: one complete row
    xm[1:7] = True
    k[7:12] = "none"           # n = 0: every x null
    xm[7:12] = True
    k[12:40] = "const"         # a constant x and y
    x[12:40], y[12:40] = 2.5, 4
    xm[12:40] = ym[12:40] = False
    k[40:45] = None
    d = [pydec.Decimal(int(v)).scaleb(-2)
         for v in rng.integers(-10 ** 6, 10 ** 6, ROWS)]
    return pa.table({"k": pa.array(k.tolist(), pa.string()),
                     "x": pa.array(x, mask=xm),
                     "y": pa.array(y, pa.int64(), mask=ym),
                     "d": pa.array(d, pa.decimal128(9, 2))})


def _aggs(A, c):
    return [(A.VariancePop(c("x")), "var_pop"),
            (A.VarianceSamp(c("x")), "var_samp"),
            (A.StddevPop(c("x")), "sd_pop"),
            (A.StddevSamp(c("y")), "sd_samp_y"),
            (A.StddevSamp(c("d")), "sd_samp_d"),
            (A.CovarPop(c("x"), c("y")), "covar_pop"),
            (A.CovarSamp(c("x"), c("d")), "covar_samp"),
            (A.Corr(c("x"), c("y")), "corr"),
            (A.Count(None), "n")]


TIERS = {
    "segagg": ({}, "segagg"),
    "dense": ({"spark.rapids.tpu.sql.kernels.pallas.segagg": "OFF"},
              "dense"),
    "sort": ({"spark.rapids.tpu.sql.kernels.pallas.segagg": "OFF",
              "spark.rapids.tpu.sql.agg.denseDomainViaSort": "true"},
             "sort")}


def _close(got: dict, want: dict, rtol: float):
    assert list(got) == list(want)
    for name in got:
        g, w = got[name], want[name]
        assert [v is None for v in g] == [v is None for v in w], name
        if not any(isinstance(v, float) for v in g + w):
            assert g == w, name
            continue
        gv = np.array([np.nan if v is None else v for v in g], float)
        wv = np.array([np.nan if v is None else v for v in w], float)
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=ATOL,
                                   err_msg=name)


def _run(build, conf):
    table = _table()
    jdf = build(JA, jcol, JSession(conf).from_arrow(table))
    ref = jdf.collect().to_pydict()
    oracle = JDF(jdf._plan, JSession(
        {**conf, "spark.rapids.tpu.sql.enabled": "false"})) \
        .collect().to_pydict()
    got = build(PA, pcol, PSession(conf, device="cpu").from_arrow(table)) \
        .to_pydict()
    return got, ref, oracle


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_grouped_statistics_equal_reference_and_oracle(tier):
    conf, name = TIERS[tier]
    PAGG.reset_groupby_tiers()
    got, ref, oracle = _run(
        lambda A, c, df: df.group_by("k").agg(*_aggs(A, c)).sort("k"), conf)
    assert PAGG.GROUPBY_TIERS[name] > 0
    assert sum(PAGG.GROUPBY_TIERS.values()) == PAGG.GROUPBY_TIERS[name]
    _close(got, ref, 1e-12)
    _close(got, oracle, 1e-9)
    row = {k: i for i, k in enumerate(got["k"])}
    assert all(got[c][row["none"]] is None for c in got
               if c not in ("k", "n", "sd_samp_y", "sd_samp_d"))
    one = row["one"]
    assert got["var_pop"][one] == 0.0 and got["var_samp"][one] is None
    assert got["covar_samp"][one] is None and np.isnan(got["corr"][one])
    const = row["const"]
    assert got["var_pop"][const] == 0.0 and np.isnan(got["corr"][const])


@pytest.mark.parametrize("rows", [None, 0, 1])
def test_global_statistics_equal_reference_and_oracle(rows):
    def build(A, c, df):
        if rows is not None:
            df = df.limit(rows)
        return df.agg(*_aggs(A, c))
    got, ref, oracle = _run(build, {})
    _close(got, ref, 1e-12)
    _close(got, oracle, 1e-9)
    if rows == 0:
        assert got["n"] == [0] and all(
            got[c] == [None] for c in got if c != "n")
    if rows == 1:
        assert got["var_samp"] == [None] and got["var_pop"] == [0.0]


def test_statistics_over_several_batches_merge_the_moments():
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "1024"}
    got, ref, oracle = _run(
        lambda A, c, df: df.group_by("k").agg(*_aggs(A, c)).sort("k"), conf)
    _close(got, ref, 1e-12)
    _close(got, oracle, 1e-9)
