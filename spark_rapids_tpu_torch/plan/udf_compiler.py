"""udf-compiler: translate plain Python row functions into Expression
trees, so that "UDF" queries run wholly on the device.

Counterpart of spark_rapids_tpu/plan/udf_compiler.py, copied onto the
port's plan/expressions.py and plan/strings.py: the same interpreter
over the same bytecode (CPython 3.10 to 3.12; `_PY311` picks the
opcode forms), so that a function compiles to the reference's tree
(the same `repr`, equal canonical fingerprints).  The reference's
udf-compiler module (SURVEY §2.8) decompiles Scala lambda JVM bytecode
into a CFG, symbolically executes its basic blocks and emits Catalyst
expressions, falling back to the JVM UDF when it cannot; here the
function's bytecode (`dis`) is executed symbolically:

- values on the symbolic stack are Expression trees
- conditional jumps fork execution down both paths; each path runs to a
  RETURN and the fork folds into If(cond, then, else) — this one rule
  covers ``and``/``or``, ternaries, and if/elif/else statement chains
- arithmetic, comparisons, abs/min/max, math module fns, string methods
  (upper/lower/strip/startswith/endswith), ``x is None``/``is not None``
  (IsNull/IsNotNull), and ``in`` over literal tuples translate directly
- loops, attribute writes, non-literal globals, truthiness of non-boolean
  values -> UntranslatableUDF, and `udf()` falls back to the row-based
  PythonUDF (plan/udf.py) on the CPU engine, as the reference falls
  back to the JVM UDF

The compiled tree is an expression like any other: it runs on the
device's lanes, and under whole-plan capture it is recorded into the
plan's graph.
"""
from __future__ import annotations

import dis
import math
import sys
from typing import Callable, List, Optional, Sequence

from .. import types as t
from . import expressions as E
from . import strings as S


class UntranslatableUDF(Exception):
    """Raised when bytecode uses features with no Expression analogue."""


_MAX_FORKS = 64


class _Callable:
    """Marker for a resolved callable sitting on the symbolic stack."""

    def __init__(self, name: str, self_expr=None):
        self.name = name
        self.self_expr = self_expr


class _Null:
    """CPython 3.11+ NULL stack sentinel."""


_BINARY = {
    "+": E.Add, "-": E.Subtract, "*": E.Multiply, "/": E.Divide,
    "//": E.IntegralDivide, "%": E.Remainder, "**": E.Pow,
}
# CPython 3.11 folded the per-operator opcodes into BINARY_OP; 3.10
# still emits one opcode per operator (and the INPLACE_ twins for
# augmented assignment, which on immutable Expression values are the
# same pure operation).
_LEGACY_BINOPS = {
    "BINARY_ADD": "+", "BINARY_SUBTRACT": "-", "BINARY_MULTIPLY": "*",
    "BINARY_TRUE_DIVIDE": "/", "BINARY_FLOOR_DIVIDE": "//",
    "BINARY_MODULO": "%", "BINARY_POWER": "**",
    "INPLACE_ADD": "+", "INPLACE_SUBTRACT": "-", "INPLACE_MULTIPLY": "*",
    "INPLACE_TRUE_DIVIDE": "/", "INPLACE_FLOOR_DIVIDE": "//",
    "INPLACE_MODULO": "%", "INPLACE_POWER": "**",
}
# 3.11+ oparg low bits carry push-NULL flags on LOAD_GLOBAL/LOAD_ATTR;
# on 3.10 the arg is a plain name index and must not be bit-tested.
_PY311 = sys.version_info >= (3, 11)
_COMPARE = {
    "==": E.EqualTo, "!=": E.NotEqual, "<": E.LessThan,
    "<=": E.LessThanOrEqual, ">": E.GreaterThan, ">=": E.GreaterThanOrEqual,
}
_GLOBAL_FNS = {
    "abs": lambda a: E.Abs(a),
    "min": lambda *a: E.Least(*a),
    "max": lambda *a: E.Greatest(*a),
}
_MATH_FNS = {
    "sqrt": E.Sqrt, "exp": E.Exp, "log": E.Log, "log10": E.Log10,
    "log2": E.Log2, "sin": E.Sin, "cos": E.Cos, "tan": E.Tan,
    "asin": E.Asin, "acos": E.Acos, "atan": E.Atan, "sinh": E.Sinh,
    "cosh": E.Cosh, "tanh": E.Tanh, "floor": E.Floor, "ceil": E.Ceil,
    "atan2": E.Atan2, "pow": E.Pow,
}
_STR_METHODS = {
    "upper": lambda s: S.Upper(s),
    "lower": lambda s: S.Lower(s),
    "strip": lambda s: S.StringTrim(s),
    "lstrip": lambda s: S.StringTrimLeft(s),
    "rstrip": lambda s: S.StringTrimRight(s),
    "startswith": lambda s, p: S.StartsWith(s, _lit_str(p)),
    "endswith": lambda s, p: S.EndsWith(s, _lit_str(p)),
}
_MATH_CONSTS = {"pi": math.pi, "e": math.e, "inf": math.inf,
                "nan": math.nan}


def _lit_str(e) -> str:
    if isinstance(e, E.Literal) and isinstance(e.value, str):
        return e.value
    raise UntranslatableUDF("string-method argument must be a literal")


def _as_literal(v) -> E.Expression:
    if isinstance(v, (bool, int, float, str)):
        return E.Literal(v)
    raise UntranslatableUDF(f"unsupported constant {v!r}")


def _as_bool(e: E.Expression, schema: t.StructType) -> E.Expression:
    """Conditions must already be boolean (no silent truthiness)."""
    try:
        dt = e.bind(schema).dtype
    except Exception as ex:               # noqa: BLE001
        raise UntranslatableUDF(f"cannot type condition: {ex}") from ex
    if not isinstance(dt, t.BooleanType):
        raise UntranslatableUDF(
            f"non-boolean truthiness ({dt}) — write an explicit comparison")
    return e


class _Compiler:
    def __init__(self, fn: Callable, args: Sequence[E.Expression],
                 schema: t.StructType):
        self.fn = fn
        code = fn.__code__
        if code.co_argcount != len(args):
            raise UntranslatableUDF(
                f"{fn.__name__} takes {code.co_argcount} args, "
                f"{len(args)} given")
        self.locals0 = {code.co_varnames[i]: args[i]
                        for i in range(len(args))}
        self.instrs: List[dis.Instruction] = list(dis.get_instructions(fn))
        self.by_offset = {ins.offset: i
                          for i, ins in enumerate(self.instrs)}
        self.schema = schema
        self.forks = 0

    def run(self) -> E.Expression:
        return self._exec(0, [], dict(self.locals0))

    # -- the symbolic interpreter ------------------------------------------

    def _exec(self, i: int, stack: list, lcls: dict) -> E.Expression:
        while i < len(self.instrs):
            ins = self.instrs[i]
            op = ins.opname
            if op in ("RESUME", "CACHE", "PRECALL", "NOP", "EXTENDED_ARG",
                      "MAKE_CELL", "COPY_FREE_VARS"):
                pass
            elif op in ("LOAD_FAST", "LOAD_FAST_CHECK",
                        "LOAD_FAST_AND_CLEAR"):
                if ins.argval not in lcls:
                    raise UntranslatableUDF(
                        f"read of unassigned local {ins.argval}")
                stack.append(lcls[ins.argval])
            elif op == "STORE_FAST":
                lcls[ins.argval] = stack.pop()
            elif op == "LOAD_CONST":
                v = ins.argval
                if v is None or isinstance(v, (tuple, frozenset)):
                    stack.append(v)        # for IS_OP / CONTAINS_OP
                else:
                    stack.append(_as_literal(v))
            elif op == "RETURN_CONST":
                v = ins.argval
                if v is None:
                    raise UntranslatableUDF("returning None")
                return _as_literal(v)
            elif op == "RETURN_VALUE":
                v = stack.pop()
                if not isinstance(v, E.Expression):
                    raise UntranslatableUDF(f"returning {v!r}")
                return v
            elif op == "LOAD_GLOBAL":
                if _PY311 and ins.arg & 1:   # 3.11+: pushes NULL too
                    stack.append(_Null())
                name = ins.argval
                if name in _GLOBAL_FNS:
                    stack.append(_Callable(name))
                elif name == "math":
                    stack.append(_Callable("__module_math__"))
                else:
                    glb = self.fn.__globals__.get(name)
                    if isinstance(glb, (bool, int, float, str)):
                        stack.append(_as_literal(glb))
                    elif glb is math:
                        stack.append(_Callable("__module_math__"))
                    else:
                        raise UntranslatableUDF(f"global {name!r}")
            elif op in ("LOAD_ATTR", "LOAD_METHOD"):
                obj = stack.pop()
                name = ins.argval
                if isinstance(obj, _Callable) and \
                        obj.name == "__module_math__":
                    if name in _MATH_FNS:
                        stack.append(_Callable(f"math.{name}"))
                        if _PY311 and not (op == "LOAD_ATTR"
                                           and not (ins.arg & 1)):
                            stack.append(_Null())
                    elif name in _MATH_CONSTS:
                        stack.append(E.Literal(_MATH_CONSTS[name]))
                    else:
                        raise UntranslatableUDF(f"math.{name}")
                elif isinstance(obj, E.Expression) and name in _STR_METHODS:
                    stack.append(_Callable(name, self_expr=obj))
                    if _PY311 and op == "LOAD_ATTR" and (ins.arg & 1):
                        stack.append(_Null())
                else:
                    raise UntranslatableUDF(f"attribute {name!r}")
            elif op == "PUSH_NULL":
                stack.append(_Null())
            elif op == "CALL":
                n = ins.arg
                args = stack[len(stack) - n:]
                del stack[len(stack) - n:]
                frame = []
                while stack and not isinstance(stack[-1], _Callable):
                    top = stack.pop()
                    if isinstance(top, _Null):
                        continue
                    frame.append(top)
                if not stack:
                    raise UntranslatableUDF("call of non-callable")
                fn = stack.pop()
                if stack and isinstance(stack[-1], _Null):
                    stack.pop()
                if frame:                  # bound self pushed after fn
                    args = frame[::-1] + args
                stack.append(self._call(fn, args))
            elif op in ("CALL_FUNCTION", "CALL_METHOD"):
                # 3.10 call shape: [callable, (NULL,) args...]; the
                # bound self (string methods) lives inside _Callable
                n = ins.arg
                args = stack[len(stack) - n:]
                del stack[len(stack) - n:]
                while stack and isinstance(stack[-1], _Null):
                    stack.pop()
                if not stack or not isinstance(stack[-1], _Callable):
                    raise UntranslatableUDF("call of non-callable")
                stack.append(self._call(stack.pop(), args))
            elif op == "BINARY_OP":
                rhs, lhs = stack.pop(), stack.pop()
                sym = ins.argrepr.rstrip("=")
                if ins.argrepr.endswith("=") and \
                        ins.argrepr not in ("<=", ">=", "==", "!="):
                    sym = ins.argrepr[:-1]     # in-place += etc.
                cls = _BINARY.get(sym)
                if cls is None:
                    raise UntranslatableUDF(f"operator {ins.argrepr!r}")
                stack.append(cls(lhs, rhs))
            elif op in _LEGACY_BINOPS:
                rhs, lhs = stack.pop(), stack.pop()
                stack.append(_BINARY[_LEGACY_BINOPS[op]](lhs, rhs))
            elif op == "COMPARE_OP":
                rhs, lhs = stack.pop(), stack.pop()
                sym = ins.argval if isinstance(ins.argval, str) \
                    else ins.argrepr
                sym = sym.replace(" ", "")
                cls = _COMPARE.get(sym)
                if cls is None:
                    raise UntranslatableUDF(f"comparison {sym!r}")
                stack.append(cls(lhs, rhs))
            elif op == "IS_OP":
                rhs, lhs = stack.pop(), stack.pop()
                if rhs is not None and lhs is not None:
                    raise UntranslatableUDF("is only supports None")
                expr = lhs if rhs is None else rhs
                stack.append(E.IsNotNull(expr) if ins.arg
                             else E.IsNull(expr))
            elif op == "CONTAINS_OP":
                container, needle = stack.pop(), stack.pop()
                items = self._literal_tuple(container)
                res = E.In(needle, items)
                stack.append(E.Not(res) if ins.arg else res)
            elif op == "UNARY_NEGATIVE":
                stack.append(E.UnaryMinus(stack.pop()))
            elif op == "UNARY_NOT":
                stack.append(E.Not(_as_bool(stack.pop(), self.schema)))
            elif op == "TO_BOOL":
                stack[-1] = _as_bool(stack[-1], self.schema)
            elif op == "POP_TOP":
                stack.pop()
            elif op == "COPY":
                stack.append(stack[-ins.arg])
            elif op == "DUP_TOP":
                stack.append(stack[-1])
            elif op == "SWAP":
                stack[-1], stack[-ins.arg] = stack[-ins.arg], stack[-1]
            elif op == "ROT_TWO":
                stack[-1], stack[-2] = stack[-2], stack[-1]
            elif op == "ROT_THREE":
                stack[-1], stack[-2], stack[-3] = \
                    stack[-2], stack[-3], stack[-1]
            elif op in ("JUMP_FORWARD", "JUMP_BACKWARD_NO_INTERRUPT"):
                i = self.by_offset[ins.argval]
                continue
            elif op == "JUMP_BACKWARD":
                raise UntranslatableUDF("loops are not translatable")
            elif op == "JUMP_ABSOLUTE":
                # 3.10 spells both loop back-edges and if/else merges as
                # absolute jumps; only the backward ones are loops
                tgt = self.by_offset[ins.argval]
                if tgt <= i:
                    raise UntranslatableUDF("loops are not translatable")
                i = tgt
                continue
            elif op in ("JUMP_IF_TRUE_OR_POP", "JUMP_IF_FALSE_OR_POP"):
                # 3.10/3.11 and/or in value position: the jump path keeps
                # the condition as the expression value
                self.forks += 1
                if self.forks > _MAX_FORKS:
                    raise UntranslatableUDF("too many branches")
                tgt = self.by_offset[ins.argval]
                if tgt <= i:
                    raise UntranslatableUDF("loops are not translatable")
                cond = _as_bool(stack.pop(), self.schema)
                taken = self._exec(tgt, list(stack) + [cond], dict(lcls))
                fallthrough = self._exec(i + 1, list(stack), dict(lcls))
                if op == "JUMP_IF_TRUE_OR_POP":
                    return E.If(cond, taken, fallthrough)
                return E.If(cond, fallthrough, taken)
            elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                        "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"):
                self.forks += 1
                if self.forks > _MAX_FORKS:
                    raise UntranslatableUDF("too many branches")
                if self.by_offset[ins.argval] <= i:
                    raise UntranslatableUDF("loops are not translatable")
                raw = stack.pop()
                if op.endswith("_NONE"):
                    cond = E.IsNull(raw) if op.endswith("IF_NONE") \
                        else E.IsNotNull(raw)
                    jump_when = True
                else:
                    cond = _as_bool(raw, self.schema)
                    jump_when = op == "POP_JUMP_IF_TRUE"
                tgt = self.by_offset[ins.argval]
                taken = self._exec(tgt, list(stack), dict(lcls))
                fallthrough = self._exec(i + 1, list(stack), dict(lcls))
                if jump_when:
                    return E.If(cond, taken, fallthrough)
                return E.If(cond, fallthrough, taken)
            else:
                raise UntranslatableUDF(f"opcode {op}")
            i += 1
        raise UntranslatableUDF("fell off the end of the bytecode")

    def _literal_tuple(self, container) -> list:
        if isinstance(container, E.Literal):
            container = container.value
        if isinstance(container, (tuple, list, frozenset, set)):
            return list(container)
        raise UntranslatableUDF("`in` requires a literal tuple/list")

    def _call(self, fn: _Callable, args: list) -> E.Expression:
        if fn.self_expr is not None:       # string method
            m = _STR_METHODS[fn.name]
            return m(fn.self_expr, *args)
        if fn.name in _GLOBAL_FNS:
            return _GLOBAL_FNS[fn.name](*args)
        if fn.name.startswith("math."):
            return _MATH_FNS[fn.name[5:]](*args)
        raise UntranslatableUDF(f"call to {fn.name}")


def compile_udf(fn: Callable, args: Sequence[E.Expression],
                schema: Optional[t.StructType] = None) -> E.Expression:
    """Translate `fn`'s bytecode applied to `args` into an Expression.
    `schema` types the arguments for boolean-condition checking (pass the
    input schema when args contain ColumnRefs)."""
    schema = schema or t.StructType([])
    return _Compiler(fn, args, schema).run()


def udf(fn: Callable, return_type: t.DataType,
        *args: E.Expression, schema: Optional[t.StructType] = None
        ) -> E.Expression:
    """Compile fn to a device expression; fall back to the row-based
    PythonUDF host path when untranslatable (the reference's
    udf-compiler -> JVM-UDF fallback)."""
    try:
        return compile_udf(fn, args, schema)
    except UntranslatableUDF:
        from .udf import PythonUDF
        return PythonUDF(fn, return_type, *args)
