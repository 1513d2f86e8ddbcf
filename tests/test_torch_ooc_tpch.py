"""The 22 TPC-H queries at the sub-partition join's gate, against the
JAX package.

At scale 0.01 with 4,096-row batches a query meets the sub-partition
join's 2 x sql.batchSizeRows gate as at SF10 with the default batch: the
seven whose build exceeds it (q4, q7, q8, q9, q12, q21 and q22), and
q18, whose adaptive join builds on orders once its group-by runs out of
core, sub-partition; the other fourteen run their joins resident, and
under this conf q20's group-by and every multi-batch ORDER BY run
through the out-of-core aggregation and sort.  Both packages
sub-partition the same joins into the same buckets (bit-equal bucket
ids); the port (CPU tensors) must equal the reference, decimals as
unscaled integers and DOUBLE columns within rtol 1e-12, and count the
same sub-partitioned joins.
"""
import numpy as np
import pytest

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.exec.plan import ExecContext as PCtx
from spark_rapids_tpu_torch.session import TpuSession as PSession
import torch

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jtables_01():
    return JTPCH.gen_tables(0.01)


@pytest.fixture(scope="module")
def ptables_01():
    return PTPCH.gen_tables(0.01)


def _unscaled(d):
    return {k: [int(v.scaleb(-v.as_tuple().exponent))
                if hasattr(v, "as_tuple") else v for v in vs]
            for k, vs in d.items()}


#: the queries that sub-partition a join under the gate conf
SUB_PARTITIONED = ("q4", "q7", "q8", "q9", "q12", "q18", "q21", "q22")


@pytest.mark.parametrize("query", sorted(PTPCH.QUERIES))
def test_sub_partitioned_tpch_query_equals_the_reference(
        jtables_01, ptables_01, query):
    # scale 0.01 with 4,096-row batches meets the 2 x sql.batchSizeRows
    # gate as SF10 does with the default batch: both packages
    # sub-partition the same joins into the same buckets
    gate = {"spark.rapids.tpu.sql.batchSizeRows": "4096"}
    jdf = JTPCH.QUERIES[query](JSession(gate), jtables_01)
    want = jdf.collect().to_pydict()
    q = PTPCH.QUERIES[query](PSession(gate, device="cpu"),
                             ptables_01).physical()
    ctx = PCtx(q.conf, q.device)
    got = q.collect(ctx).to_pydict()
    assert list(got) == list(want)
    got, want = _unscaled(got), _unscaled(want)
    for k in got:
        if got[k] and isinstance(got[k][0], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
        else:
            assert got[k] == want[k], k
    fallbacks = ctx.metrics.get("join_subpartition_fallbacks", 0)
    assert fallbacks == jdf.metrics().get("join_subpartition_fallbacks", 0)
    assert (fallbacks > 0) == (query in SUB_PARTITIONED), fallbacks
