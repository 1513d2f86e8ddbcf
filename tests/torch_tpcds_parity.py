"""Shared helpers of the port's TPC-DS parity tests
(tests/test_torch_tpcds*.py): the reference's results of a set of
queries, computed once per test module, and the comparison.

At the reference's own test scale 0.0005 the port (CPU tensors, the
kernels' plain versions) must equal the JAX package's CPU oracle
(sql.enabled=false) and its device path (kernel tier on, Pallas in
interpret mode).  Integers, strings and decimals compare exactly (the
decimals as unscaled integers at their scale).  DOUBLE columns compare
within rtol 1e-12, the README's f64 tolerance, against both; against
the device path they are also held within `DEVICE_ULPS` units in the
last place: the reference's decimal -> DOUBLE cast is 1 ulp off for
some values (ROADMAP Queue 3 item 1), and a quotient of two such casts
(q36's margin, q98's revenue ratio) moves by 2.  Against the oracle a
window sum of DOUBLEs adds in another order (q12, q98: up to 20 ulps).
"""
import decimal as pydec

import numpy as np

from spark_rapids_tpu import tpcds as JDS
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession

SCALE = 0.0005
PALLAS_ON = {"spark.rapids.tpu.sql.kernels.pallas.enabled": "true",
             "spark.rapids.tpu.sql.kernels.pallas.segagg": "ON"}
DEVICE_ULPS = 2
ROLLUP = ("q27", "q36", "q70", "q86")
CHANNELS = ("q33", "q56", "q60", "q76")
WINDOWS = ("q12", "q20", "q36", "q70", "q86", "q98")


def reference_results(names, tables):
    """{query: (device path dict, CPU oracle dict)} of the JAX package."""
    out = {}
    for q in names:
        df = JDS.QUERIES[q](JSession(PALLAS_ON), tables)
        cpu = JDF(df._plan, JSession(
            {"spark.rapids.tpu.sql.enabled": "false"})).collect()
        out[q] = (df.collect().to_pydict(), cpu.to_pydict())
    return out


def _unscaled(vs):
    return [(int(v.scaleb(-v.as_tuple().exponent)), -v.as_tuple().exponent)
            if isinstance(v, pydec.Decimal) else v for v in vs]


def _ulps(a, b) -> int:
    a = np.array(a, np.float64)
    b = np.array(b, np.float64)
    return int(np.abs(a.view(np.int64) - b.view(np.int64)).max()) \
        if len(a) else 0


def assert_same(got: dict, want: dict, ulps=None):
    """Equal column by column; DOUBLE columns within rtol 1e-12 (and
    within `ulps` units in the last place when given)."""
    assert list(got) == list(want)
    for name in got:
        g, w = got[name], want[name]
        assert len(g) == len(w), name
        if any(isinstance(v, float) for v in g + w):
            assert [v is None for v in g] == [v is None for v in w], name
            gf = [v for v in g if v is not None]
            wf = [v for v in w if v is not None]
            np.testing.assert_allclose(np.array(gf, float),
                                       np.array(wf, float), rtol=1e-12,
                                       atol=0, err_msg=name)
            if ulps is not None:
                assert _ulps(gf, wf) <= ulps, (name, _ulps(gf, wf))
        else:
            assert _unscaled(g) == _unscaled(w), name


def plan_nodes(node):
    """Every node of a physical plan, depth first."""
    out = [node]
    for c in node.children:
        out += plan_nodes(c)
    return out
