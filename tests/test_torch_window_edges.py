"""Edge cases of the port's window operator against the JAX package's
WindowExec on the CPU: NaN and ±0.0 in a DOUBLE order key, DESC order
with nulls last, RANGE offsets near the int64 extremes, one-row
partitions, no partition keys, string partition keys whose batches carry
different dictionaries, and the analysis error of a ranking function
without an order.  The comparison is tests/test_torch_window.py's.
"""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.exec.plan import HostScanExec as PScan
from spark_rapids_tpu_torch.exec.window import WindowExec as PWindow
from spark_rapids_tpu_torch.plan import expressions as PE
from spark_rapids_tpu_torch.plan import window as PW
from spark_rapids_tpu_torch.plan.window import WindowAnalysisError
from test_torch_window import (FRAMED, ORDERS, RANKING, _dec, _run,
                               assert_window_equal, make_table)
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)


@pytest.mark.parametrize("frame", [None, ("rows", -2, 2),
                                   ("range", -4, 3)])
def test_desc_order_with_nulls_last(frame):
    names = (RANKING if frame is None else []) + FRAMED
    assert_window_equal(*_run(make_table(seed=11), names, ["g"],
                              [("o", False, False)], frame))


def test_nan_and_signed_zero_in_a_double_order_key_and_values():
    n = 300
    rng = np.random.default_rng(3)
    d = rng.choice([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf, -np.inf], n)
    v = rng.choice([np.nan, -0.0, 0.0, 3.0, -1.0], n)
    t = pa.table({"g": pa.array(rng.integers(0, 3, n), pa.int32()),
                  "o": pa.array(d, pa.float64(), mask=rng.random(n) < 0.1),
                  "v": pa.array(v, pa.float64(), mask=rng.random(n) < 0.1),
                  "i": pa.array(rng.integers(0, 9, n), pa.int64()),
                  "m": _dec(rng.integers(0, 9, n)),
                  "s": pa.array(["x"] * n)})
    for orders in ([("o", True, True)], [("o", False, True)]):
        assert_window_equal(*_run(t, ["rank", "dense_rank", "cume_dist",
                                      "percent_rank"] + FRAMED, ["g"],
                                  orders))
    for frame in (("rows", -2, 2), ("rows", None, 0), ("rows", 0, None)):
        assert_window_equal(*_run(t, FRAMED, ["g"], [("o", True, True)],
                                  frame))


@pytest.mark.parametrize("frame", [
    ("range", -(2 ** 62), 2 ** 62), ("range", -(2 ** 63 - 5), None),
    ("range", None, 2 ** 63 - 2), ("range", 1, 2 ** 62),
    ("range", -(2 ** 62), -1)])
@pytest.mark.parametrize("asc", [True, False])
def test_range_offsets_near_the_int64_extremes(frame, asc):
    rng = np.random.default_rng(5)
    n = 200
    big = np.array([-(2 ** 63) + 1, -(2 ** 62), -5, 0, 7, 2 ** 62,
                    2 ** 63 - 1], np.int64)
    t = pa.table({"g": pa.array(rng.integers(0, 2, n), pa.int32()),
                  "o": pa.array(rng.choice(big, n), pa.int64(),
                                mask=rng.random(n) < 0.05),
                  "v": pa.array(rng.normal(size=n), pa.float64()),
                  "i": pa.array(rng.integers(-9, 9, n), pa.int64()),
                  "m": _dec(rng.integers(0, 99, n)),
                  "s": pa.array(["y"] * n)})
    assert_window_equal(*_run(t, ["sum_i", "count_all", "min_i", "max_m",
                                  "first_v", "last_i"], ["g"],
                              [("o", asc, asc)], frame))


def test_one_row_partitions_and_no_partition_keys():
    t = make_table(n=40, seed=2)
    # g unique per row: every partition is one row
    t = t.set_column(0, "g", pa.array(np.arange(40), pa.int32()))
    assert_window_equal(*_run(t, RANKING + FRAMED, ["g"], ORDERS))
    for frame in (None, ("rows", -1, 1), ("range", -3, 3)):
        assert_window_equal(*_run(t, FRAMED, ["g"], [("o", True, True)],
                                  frame))
    # no partition keys: one partition over every row
    t = make_table(seed=9)
    assert_window_equal(*_run(t, RANKING + FRAMED, [], ORDERS))
    assert_window_equal(*_run(t, FRAMED, [], [("o", True, True)],
                              ("range", -2, 6)))


def test_string_partition_keys_with_a_dictionary_per_batch():
    # two scans (a union), each with its own dictionary for s, split into
    # 64-row batches: the window concatenates and unifies them
    a = make_table(n=300, seed=4)
    b = make_table(n=250, seed=5)
    b = b.set_column(5, "s", pa.array(
        [f"t{k % 5}" if k % 3 else f"s{k % 4}" for k in range(250)]))
    for frame in (None, ("rows", -1, 2)):
        assert_window_equal(*_run([a, b], RANKING + FRAMED, ["s"], ORDERS,
                                  frame, max_rows=64))


def test_ranking_without_order_is_an_analysis_error():
    with pytest.raises(WindowAnalysisError, match="ORDER BY"):
        PWindow([(PW.Rank(), "r")], [PE.ColumnRef("g")], [],
                PScan(from_arrow(make_table(n=10)), 8))
