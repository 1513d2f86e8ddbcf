"""The port's udf-compiler (spark_rapids_tpu_torch/plan/udf_compiler.py):
port copies of tests/test_udf_compiler.py, and q1's decimal expressions.
Each function compiles in both packages to the same tree (the same
`repr` and equal canonical fingerprints, but where a string predicate's
own fingerprint differs by its form), and the port's result on both of
its engines equals the reference's device path and its CPU oracle on
the same table, as well as a direct per-row call.
"""
import math

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.plan.udf import PythonUDF as JPythonUDF
from spark_rapids_tpu.plan.udf_compiler import compile_udf as jcompile
from spark_rapids_tpu.plan.udf_compiler import udf as judf
from spark_rapids_tpu.session import DataFrame as JDF
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import types as t
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan.udf import PythonUDF
from spark_rapids_tpu_torch.plan.udf_compiler import (UntranslatableUDF,
                                                      compile_udf, udf)
from spark_rapids_tpu_torch.session import DataFrame, TpuSession, col

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)

CPU = {"spark.rapids.tpu.sql.enabled": "false"}


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1e-12 * max(1.0, abs(b))
    return a == b


def _tree(e):
    """An expression's structure: class, column name or literal value,
    children."""
    leaf = getattr(e, "name", None) if type(e).__name__ == "ColumnRef" \
        else (e.value, str(e.dtype)) if type(e).__name__ == "Literal" \
        else None
    return (type(e).__name__, leaf, tuple(_tree(c) for c in e.children))


def _same_tree(expr, jexpr):
    """The same tree; the same repr and canonical fingerprint too, except
    where a string predicate is in it: the port's fingerprint of one
    also names its pattern (beside the pattern's literal child)."""
    assert _tree(expr) == _tree(jexpr)
    if "With(" not in repr(jexpr):
        assert repr(expr) == repr(jexpr)
        assert expr.canonical_fingerprint() == jexpr.canonical_fingerprint()


def _port_and_ref(fn, arg_names, table):
    """Compile `fn` in both packages (the same tree) and run it: -> (the
    port's values, the reference's device values, its oracle's)."""
    s = TpuSession(device="cpu")
    df = s.from_arrow(table)
    expr = compile_udf(fn, [col(n) for n in arg_names], df.schema)
    js = JSession()
    jdf = js.from_arrow(table)
    jexpr = jcompile(fn, [jcol(n) for n in arg_names], jdf.schema)
    _same_tree(expr, jexpr)
    names = list(table.schema.names)
    q = df.select(*([col(n) for n in names] + [expr]), names=names + ["u"])
    got = q.collect().to_pydict()["u"]
    cpu = DataFrame(q._plan, TpuSession(CPU, device="cpu")).collect() \
        .to_pydict()["u"]
    assert got == cpu
    jq = jdf.select(*([jcol(n) for n in names] + [jexpr]),
                    names=names + ["u"])
    ref = jq.collect().column("u").to_pylist()
    oracle = JDF(jq._plan, JSession(CPU)).collect().column("u").to_pylist()
    return got, ref, oracle


def _run(fn, arg_names, table, schema_types=None, rtype=t.DOUBLE):
    """Compile fn over the named columns; run it on the device engine;
    hold it to the reference; compare with calling fn per row."""
    got, ref, oracle = _port_and_ref(fn, arg_names, table)
    assert all(_close(g, r) for g, r in zip(got, ref)), (got, ref)
    assert all(_close(g, o) for g, o in zip(got, oracle)), (got, oracle)
    cols = [table.column(n).to_pylist() for n in arg_names]
    exp = [None if any(v is None for v in row) else fn(*row)
           for row in zip(*cols)]
    return got, exp


def test_arithmetic_chain_device():
    tbl = pa.table({"x": pa.array([1.0, 2.5, -3.0, None]),
                    "y": pa.array([10, 20, 30, 40], pa.int64())})

    def f(x, y):
        return x * 2.0 + y / 4.0 - 1.0
    got, exp = _run(f, ["x", "y"], tbl)
    for g, e in zip(got, exp):
        assert (g is None and e is None) or abs(g - e) < 1e-12


def test_ternary_and_branches_device():
    tbl = pa.table({"x": pa.array([-5.0, 0.0, 3.0, None, 100.0])})

    def f(x):
        if x > 50.0:
            return 3.0
        return x if x > 0.0 else -x
    got, exp = _run(f, ["x"], tbl)
    assert got == exp


def test_math_and_builtins_device():
    tbl = pa.table({"x": pa.array([0.25, 4.0, 9.0, 100.0])})

    def f(x):
        return math.sqrt(x) + math.log(x) + abs(x - 5.0)
    got, exp = _run(f, ["x"], tbl)
    for g, e in zip(got, exp):
        assert abs(g - e) <= 1e-9 * max(1.0, abs(e))


def test_min_max_builtins():
    tbl = pa.table({"x": pa.array([1.0, 50.0, -2.0]),
                    "y": pa.array([3.0, 4.0, 5.0])})

    def f(x, y):
        return max(min(x, y), 0.0)
    got, exp = _run(f, ["x", "y"], tbl)
    assert got == exp


def test_string_methods_device():
    tbl = pa.table({"s": pa.array(["  Air ", "MAIL", "ship", None])})

    def f(s):
        return s.strip().upper()
    got, exp = _run(f, ["s"], tbl)
    assert got == exp


def test_string_predicates_and_in():
    tbl = pa.table({"s": pa.array(["AIR", "MAIL", "SHIP", "REG AIR"])})

    def f(s):
        return s in ("AIR", "MAIL")
    got, exp = _run(f, ["s"], tbl)
    assert got == exp

    def g(s):
        return s.startswith("REG") or s.endswith("IP")
    got, exp = _run(g, ["s"], tbl)
    assert got == exp


def test_is_none_translation():
    tbl = pa.table({"x": pa.array([1.0, None, 3.0])})

    def f(x):
        return 0.0 if x is None else x
    s = TpuSession(device="cpu")
    df = s.from_arrow(tbl)
    expr = compile_udf(f, [col("x")], df.schema)
    jexpr = jcompile(f, [jcol("x")], JSession().from_arrow(tbl).schema)
    _same_tree(expr, jexpr)
    out = df.select(expr, names=["u"]).collect()
    assert out.to_pydict()["u"] == [1.0, 0.0, 3.0]
    got, ref, oracle = _port_and_ref(f, ["x"], tbl)
    assert got == ref == oracle == [1.0, 0.0, 3.0]


def test_boolean_and_or_chains():
    tbl = pa.table({"x": pa.array([1.0, 6.0, 20.0]),
                    "y": pa.array([5, 10, 2], pa.int64())})

    def f(x, y):
        if x > 5.0 and y < 8:
            return 1
        elif x > 5.0 or y == 5:
            return 2
        else:
            return 3
    got, exp = _run(f, ["x", "y"], tbl)
    assert got == exp


def test_untranslatable_falls_back_to_python_udf():
    def looped(x):
        acc = 0.0
        for _ in range(3):
            acc += x
        return acc
    r = udf(looped, t.DOUBLE, E.ColumnRef("x"))
    assert isinstance(r, PythonUDF)
    assert isinstance(judf(looped, JT.DOUBLE, JE.ColumnRef("x")), JPythonUDF)

    def closure_call(x):
        return len(str(x))
    r2 = udf(closure_call, t.LONG, E.ColumnRef("x"))
    assert isinstance(r2, PythonUDF)
    assert isinstance(judf(closure_call, JT.LONG, JE.ColumnRef("x")),
                      JPythonUDF)


def test_untranslatable_reasons():
    with pytest.raises(UntranslatableUDF, match="loops"):
        def looped(x):
            while x > 0:
                x = x - 1
            return x
        compile_udf(looped, [E.ColumnRef("x")],
                    t.StructType([t.StructField("x", t.DOUBLE)]))

    with pytest.raises(UntranslatableUDF, match="truthiness|boolean"):
        def truthy(x):
            return 1 if x else 2        # int truthiness, not a comparison
        compile_udf(truthy, [E.ColumnRef("x")],
                    t.StructType([t.StructField("x", t.LONG)]))


def test_local_variable_assignment():
    tbl = pa.table({"x": pa.array([2.0, 3.0])})

    def f(x):
        a = x * x
        b = a + 1.0
        return b * 2.0
    got, exp = _run(f, ["x"], tbl)
    assert got == exp


def test_udf_fallback_still_correct_end_to_end():
    """The PythonUDF fallback computes the same result on the CPU
    engine, in both packages."""
    tbl = pa.table({"x": pa.array([1.5, -2.0, 4.0])})

    def weird(x):
        acc = 0.0
        for _ in range(2):
            acc += x
        return acc
    s = TpuSession(device="cpu")
    df = s.from_arrow(tbl)
    expr = udf(weird, t.DOUBLE, col("x"))
    out = df.select(expr, names=["u"]).collect()
    assert out.to_pydict()["u"] == [3.0, -4.0, 8.0]
    jout = JSession().from_arrow(tbl).select(
        judf(weird, JT.DOUBLE, jcol("x")), names=["u"]).collect()
    assert jout.column("u").to_pylist() == out.to_pydict()["u"]


def test_q1_expressions_compile_to_q1s_tree():
    """`p * (1 - d)` and `p * (1 - d) * (1 + x)` over q1's DECIMAL
    columns compile to q1's hand-written expressions, type as the
    reference's decimals, and give q1's answers."""
    import decimal
    from spark_rapids_tpu_torch.columnar.host import from_arrow
    dec = pa.decimal128(12, 2)
    D = decimal.Decimal
    tbl = pa.table({"p": pa.array([D("901.00"), D("1234.56"), None], dec),
                    "d": pa.array([D("0.04"), D("0.10"), D("0.02")], dec),
                    "x": pa.array([D("0.02"), D("0.08"), D("0.00")], dec)})
    disc = compile_udf(lambda p, d: p * (1 - d), [col("p"), col("d")])
    charge = compile_udf(lambda p, d, x: p * (1 - d) * (1 + x),
                         [col("p"), col("d"), col("x")])
    q1_disc = E.Multiply(col("p"), E.Subtract(E.Literal(1), col("d")))
    q1_charge = E.Multiply(q1_disc, E.Add(E.Literal(1), col("x")))
    assert repr(disc) == repr(q1_disc) and repr(charge) == repr(q1_charge)
    schema = from_arrow(tbl).schema
    assert disc.bind(schema).dtype == t.DecimalType(26, 4)
    jdisc = jcompile(lambda p, d: p * (1 - d), [jcol("p"), jcol("d")])
    assert str(jdisc.bind(JSession().from_arrow(tbl).schema).dtype) == \
        str(disc.bind(schema).dtype)
    got, ref, oracle = _port_and_ref(lambda p, d, x: p * (1 - d) * (1 + x),
                                     ["p", "d", "x"], tbl)
    assert got == ref == oracle
    assert got[:2] == [D("901.00") * D("0.96") * D("1.02"),
                       D("1234.56") * D("0.90") * D("1.08")]
