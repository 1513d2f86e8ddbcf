"""The second half of the port's 23 TPC-DS queries (q52 .. q98: the
channel unions q56, q60 and q76, the window queries q70, q86 and q98)
against the JAX package's device path and its CPU oracle at the
reference's test scale; the first half and the generator are
tests/test_torch_tpcds.py, the comparison tests/torch_tpcds_parity.py.
"""
import pytest

import torch_tpcds_parity as TP

from spark_rapids_tpu import tpcds as JDS
from spark_rapids_tpu_torch import tpcds as PDS
from spark_rapids_tpu_torch.exec.plan import UnionExec
from spark_rapids_tpu_torch.exec.window import WindowExec
from spark_rapids_tpu_torch.session import TpuSession as PSession
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

QUERIES = ("q52", "q55", "q56", "q60", "q65", "q70", "q73", "q76", "q86",
           "q93", "q96", "q98")


@pytest.fixture(scope="module")
def jtables():
    return JDS.gen_tables(scale=TP.SCALE)


@pytest.fixture(scope="module")
def ptables():
    return PDS.gen_tables(scale=TP.SCALE)


@pytest.fixture(scope="module")
def reference(jtables):
    return TP.reference_results(QUERIES, jtables)


@pytest.mark.parametrize("query", QUERIES)
def test_query_equals_reference_and_cpu_oracle(reference, ptables, query):
    got = PDS.QUERIES[query](PSession(device="cpu"), ptables).to_pydict()
    dev, cpu = reference[query]
    TP.assert_same(got, dev, ulps=TP.DEVICE_ULPS)
    TP.assert_same(got, cpu)
    assert len(next(iter(got.values()))) > 0


@pytest.mark.parametrize("query,node", [(q, UnionExec) for q in TP.CHANNELS]
                         + [(q, WindowExec) for q in TP.WINDOWS])
def test_channel_and_window_queries_run_their_operator(ptables, query, node):
    q = PDS.QUERIES[query](PSession(device="cpu"), ptables).physical()
    assert any(isinstance(n, node) for n in TP.plan_nodes(q.root))
