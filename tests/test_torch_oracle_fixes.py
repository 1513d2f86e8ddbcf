"""Where the port follows the CPU oracle over the JAX package.

Three inputs on which the JAX package's device path is wrong or fails
by Spark's rules, each held here to the reference's CPU oracle
(`spark.rapids.tpu.sql.enabled=false`); README lists each deviation:

  * FIRST/LAST of a STRING keep their input's dictionary, grouped and
    global (the reference's device path raises);
  * a global AVG of a DECIMAL finishes on the host in exact integers,
    so a sum whose upscale leaves int64 still averages;
  * a null sort key ties with every other null, whatever its storage
    lane holds (the reference orders null rows by their hidden value).
"""
import decimal as pydec

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.plan import aggregates as JA
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch.plan import aggregates as PA
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.session import TpuSession as PSession
from spark_rapids_tpu_torch.session import col as pcol
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)


def _oracle(build, table, conf=None):
    s = JSession({"spark.rapids.tpu.sql.enabled": "false", **(conf or {})})
    df = build(JA, JE, jcol, s, table)
    return JDF(df._plan, s).collect().to_pydict()


def _port(build, table, conf=None):
    return build(PA, PE, pcol, PSession(conf, device="cpu"),
                 table).to_pydict()


FIRST_LAST = pa.table({
    "k": pa.array([1, 2, 1, None, 2, 3, 1, 3], pa.int64()),
    "s": pa.array(["b", "a", None, "é", "B", "a", "", "zz"])})


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_first_and_last_of_a_string_keep_the_dictionary(grouped):
    def build(a, e, c, s, table):
        df = s.from_arrow(table)
        if grouped:
            return (df.group_by("k").agg((a.First(c("s")), "f"),
                                         (a.Last(c("s")), "l"))
                    .sort("k"))
        return df.agg((a.First(c("s")), "f"), (a.Last(c("s")), "l"))
    want = _oracle(build, FIRST_LAST)
    if grouped:
        assert want["f"] == ["é", "b", "a", "a"]
    assert _port(build, FIRST_LAST) == want


def test_global_decimal_average_is_exact_past_the_int64_upscale():
    # 1,000 x 9999999999.99: the unscaled sum 999999999999000 times 10^4
    # (the average's scale 6) leaves int64, the Python quotient does not
    table = pa.table({"d": pa.array([pydec.Decimal("9999999999.99")] * 1000,
                                    pa.decimal128(12, 2))})

    def build(a, e, c, s, tbl):
        return s.from_arrow(tbl).agg((a.Average(c("d")), "avg"))
    want = _oracle(build, table)
    assert want == {"avg": [pydec.Decimal("9999999999.990000")]}
    assert _port(build, table) == want


NULL_SUMS = pa.table({
    "a": pa.array([None, None, None, 1, None, 2], pa.int64()),
    "b": pa.array([30, 10, 20, 5, 40, 6], pa.int64()),
    "i": pa.array([1, 2, 3, 4, 5, 6], pa.int64())})


@pytest.mark.parametrize("limit", [None, 3], ids=["sort", "top_n"])
def test_null_sort_keys_tie_whatever_their_hidden_value(limit):
    # a + b is null in four rows whose storage holds 30, 10, 20 and 40:
    # the nulls tie, so i (descending) orders them
    def build(a, e, c, s, tbl):
        df = (s.from_arrow(tbl)
              .select(e.Alias(e.Add(c("a"), c("b")), "e"), c("i"))
              .sort("e", ("i", False)))
        return df if limit is None else df.limit(limit)
    want = _oracle(build, NULL_SUMS)
    assert want["i"] == [5, 3, 2, 1, 4, 6][:limit]
    assert _port(build, NULL_SUMS) == want


def test_null_string_sort_keys_tie_over_several_batches():
    table = pa.table({
        "s": pa.array(["b", None, "a", None, None, "a"]),
        "i": pa.array([1, 3, 2, 1, 2, 0], pa.int64())})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "2"}

    def build(a, e, c, s, tbl):
        return s.from_arrow(tbl).sort(("s", False), "i")
    want = _oracle(build, table, conf)
    got = _port(build, table, conf)
    assert got == want
    assert [i for s, i in zip(got["s"], got["i"]) if s is None] == [1, 2, 3]


# two full batches of four rows: in the first, key "c" has no non-null
# value, and the batch's last row, in key order too, (key "d") has one
ALL_NULL_IN_A_BATCH = pa.table({
    "k": pa.array(["a", "c", "a", "d", "c", "a", "c", "d"]),
    "f": pa.array([1.0, None, 2.0, 3.0, 7.0, 4.0, None, 5.0])})
TIERS = {
    "segagg": {},
    "dense": {"spark.rapids.tpu.sql.kernels.pallas.segagg": "OFF"},
    "sort": {"spark.rapids.tpu.sql.kernels.pallas.segagg": "OFF",
             "spark.rapids.tpu.sql.agg.denseDomainViaSort": "true"}}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_first_last_ignore_nulls_of_a_group_null_in_a_batch(tier):
    # the reference's partial picks the clamped row of a group with no
    # non-null value, and keeps that row's validity: "c" gets the first
    # batch's last value 3.0 (the sorted tier: the last row in key order)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": "4",
            "spark.rapids.tpu.sql.shape.minBucketRows": "4", **TIERS[tier]}

    def build(a, e, c, s, tbl):
        return (s.from_arrow(tbl)
                .group_by("k").agg((a.First(c("f"), ignore_nulls=True),
                                    "first"),
                                   (a.Last(c("f"), ignore_nulls=True),
                                    "last"))
                .sort("k"))
    want = _oracle(build, ALL_NULL_IN_A_BATCH, conf)
    assert want == {"k": ["a", "c", "d"], "first": [1.0, 7.0, 3.0],
                    "last": [4.0, 7.0, 5.0]}
    assert _port(build, ALL_NULL_IN_A_BATCH, conf) == want


LONG_EDGES = pa.table({"x": pa.array(
    [-2 ** 63, -2 ** 63 + 1, 2 ** 63 - 1, 0, -5, 123, None], pa.int64())})


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("precision,scale", [(10, 2), (18, 0), (19, 0),
                                             (20, 0), (28, 9)])
def test_long_min_value_cast_to_decimal_is_null_past_the_precision(
        engine, precision, scale):
    # ROADMAP Queue 3 item 12: the overflow checks took abs(u), which
    # stays negative at Long.MIN_VALUE, so CAST(Long.MIN_VALUE AS
    # DECIMAL(10,2)) gave 0.00 and AS DECIMAL(18,0) a 19-digit value;
    # both bounds are compared now, on both engines, as the oracle does
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu_torch import types as PT

    def build(a, e, c, s, tbl):
        typ = (JT if e is JE else PT).DecimalType(precision, scale)
        return s.from_arrow(tbl).select(e.Alias(e.Cast(c("x"), typ), "d"))
    want = _oracle(build, LONG_EDGES)
    if precision <= 18:
        assert want["d"][0] is None
    elif engine == "device":
        # the device keeps one int64 lane with overflow to null (README):
        # a value whose unscaled form leaves int64 is null there, where
        # the CPU engine and the oracle are exact
        want = {"d": [None if v is not None and
                      not -2 ** 63 <= int(v.scaleb(scale)) < 2 ** 63
                      else v for v in want["d"]]}
    conf = {"spark.rapids.tpu.sql.enabled": "false"} \
        if engine == "cpu" else None
    assert _port(build, LONG_EDGES, conf) == want
