"""The JSON functions: get_json_object, json_tuple, from_json, to_json.

Counterpart of spark_rapids_tpu/plan/json_fns.py (the reference's
GpuGetJsonObject, GpuJsonTuple, GpuJsonToStructs and GpuStructsToJson
roles).  get_json_object is a dictionary transform (plan/strings.py
DictTransform): each distinct string parses once on the host and the
device gathers codes.  Its JSONPath subset is `$`, `.field`,
`['field']` and `[index]`; a wildcard or a recursive descent tags the
expression off the device (the transpile-or-reject contract of the regex
transpiler), and a path Spark itself rejects gives null.  json_tuple is
k such transforms in a projection, or a generator (`JsonTupleGen`)
under LogicalGenerate, which CpuGenerateExec runs.  from_json gives a
STRUCT and to_json reads one: the CPU engine's, as in the reference.
"""
from __future__ import annotations

import datetime as pydt
import decimal as pydec
import json
from typing import List, Optional, Union

import numpy as np

from .. import types as t
from ..columnar.host import from_pydict
from ..ops import host as H
from .expressions import Expression
from .strings import DictTransform

#: a path Spark rejects: the result is null, and nothing falls back
INVALID_PATH = "INVALID"


def parse_json_path(path: str) -> Union[None, str, List[Union[str, int]]]:
    """A JSONPath as its field and index steps; None outside the subset
    (tagged off the device), INVALID_PATH where Spark rejects the path
    (always null)."""
    if not path.startswith("$"):
        return INVALID_PATH
    steps: List[Union[str, int]] = []
    i, n = 1, len(path)
    while i < n:
        c = path[i]
        if c == ".":
            i += 1
            if i < n and path[i] == ".":
                return None                       # recursive descent
            j = i
            while j < n and path[j] not in ".[":
                j += 1
            name = path[i:j]
            if not name or name == "*":
                return None
            steps.append(name)
            i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            inner = path[i + 1:j].strip()
            if inner.startswith("'") and inner.endswith("'"):
                steps.append(inner[1:-1])
            elif inner == "*":
                return None
            else:
                try:
                    idx = int(inner)
                except ValueError:
                    return None
                if idx < 0:
                    # Spark's grammar rejects a negative subscript
                    return INVALID_PATH
                steps.append(idx)
            i = j + 1
        else:
            return None
    return steps


def render(v) -> Optional[str]:
    """Spark's get_json_object rendering: a scalar bare, a structure as
    compact JSON, JSON null as SQL NULL."""
    if v is None:
        return None
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    return json.dumps(v, separators=(",", ":"))


def _loads(s: Optional[str]):
    """The parsed JSON value of `s`, None where it does not parse."""
    if s is None:
        return None
    try:
        return json.loads(s)
    except (ValueError, TypeError):
        return None


class GetJsonObject(DictTransform):
    """get_json_object(json, path) as a dictionary transform."""

    def __init__(self, child, path: str):
        self.children = (child,)
        self.path = path
        self._steps = parse_json_path(path)

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        if self._steps is None:
            out.append(f"JSONPath {self.path!r} outside the supported "
                       "subset ($, .field, ['field'], [index])")
        return out

    def _fp_extra(self):
        return repr(self.path)

    def _transform_value(self, s, args):
        if self._steps is None or self._steps == INVALID_PATH:
            return None
        obj = _loads(s)
        if obj is None:
            return None
        for step in self._steps:
            if isinstance(step, str):
                if not isinstance(obj, dict) or step not in obj:
                    return None
            elif not isinstance(obj, list) or step >= len(obj):
                return None
            obj = obj[step]
        return render(obj)


def json_tuple(child, *fields: str) -> List[GetJsonObject]:
    """json_tuple(json, f1, ..., fk) in a projection: k top-level
    GetJsonObject('$.f') transforms, each on the device path."""
    return [GetJsonObject(child, f"$.{f}") for f in fields]


class JsonTupleGen:
    """json_tuple as a generator (LATERAL VIEW) under LogicalGenerate:
    one output row per input row, k STRING columns c0 ... c(k-1)."""

    def __init__(self, child, fields: List[str]):
        self.child = child
        self.fields = list(fields)
        self.pos = False
        self.outer = False

    def bind(self, schema):
        import copy
        b = copy.copy(self)
        b.child = self.child.bind(schema)
        if not isinstance(b.child.dtype, (t.StringType, t.NullType)):
            raise TypeError("json_tuple requires a string input")
        return b

    def output_fields(self):
        return [t.StructField(f"c{i}", t.STRING, True)
                for i in range(len(self.fields))]

    def rows(self, values) -> List[List[Optional[str]]]:
        """The k output columns over the input's Python values."""
        outs: List[List[Optional[str]]] = [[] for _ in self.fields]
        for v in values:
            obj = _loads(v)
            for j, f in enumerate(self.fields):
                outs[j].append(render(obj[f]) if isinstance(obj, dict)
                               and f in obj else None)
        return outs

    def __repr__(self):
        return f"json_tuple({self.child!r}, {', '.join(self.fields)})"


class FromJson(Expression):
    """from_json(json, schema): a STRUCT (Spark JsonToStructs,
    PERMISSIVE: a malformed record gives a struct of nulls, a null input
    null).  A STRUCT value has no device lane: the CPU engine's."""

    def __init__(self, child, schema: t.StructType):
        self.children = (child,)
        self.schema = schema

    def _resolve(self):
        self.dtype = self.schema
        self.nullable = True

    def _fp_extra(self):
        return self.schema.simple_string

    def unsupported_reasons(self, conf):
        return ["STRUCT results have no device lane (CPU path)"]

    def _coerce(self, v, dt):
        if v is None:
            return None
        if isinstance(dt, t.StringType):
            return v if isinstance(v, str) else json.dumps(v)
        if isinstance(dt, t.BooleanType):
            return v if isinstance(v, bool) else None
        if t.is_integral(dt):
            # a JSON float does not coerce to an integral (Spark's
            # Jackson parser rejects it)
            return int(v) if isinstance(v, int) and \
                not isinstance(v, bool) else None
        if t.is_floating(dt):
            return float(v) if isinstance(v, (int, float)) and \
                not isinstance(v, bool) else None
        if isinstance(dt, t.ArrayType):
            return [self._coerce(x, dt.element_type) for x in v] \
                if isinstance(v, list) else None
        if isinstance(dt, t.StructType):
            return {f.name: self._coerce(v.get(f.name), f.data_type)
                    for f in dt.fields} if isinstance(v, dict) else None
        return None

    def _eval_cpu(self, batch, kids):
        out = []
        for v in kids[0].to_pylist():
            if v is None:
                out.append(None)
                continue
            obj = _loads(v)
            if not isinstance(obj, dict):
                obj = {}              # PERMISSIVE: a struct of nulls
            out.append({f.name: self._coerce(obj.get(f.name), f.data_type)
                        for f in self.schema.fields})
        return from_pydict({"v": out}, t.StructType(
            [t.StructField("v", self.schema)])).columns[0]


class ToJson(Expression):
    """to_json(struct): a JSON string (Spark StructsToJson): a null
    struct gives null, a null field is left out (Spark's default
    ignoreNullFields)."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.STRING
        self.nullable = True

    def unsupported_reasons(self, conf):
        return ["STRUCT inputs have no device lane (CPU path)"]

    @staticmethod
    def _jsonable(v):
        if isinstance(v, dict):
            return {k: ToJson._jsonable(x) for k, x in v.items()
                    if x is not None}
        if isinstance(v, list):
            return [ToJson._jsonable(x) for x in v]
        if isinstance(v, pydec.Decimal):
            return float(v)
        if isinstance(v, (pydt.date, pydt.datetime)):
            return v.isoformat()
        return v

    def _eval_cpu(self, batch, kids):
        vals = [None if v is None else
                json.dumps(self._jsonable(v), separators=(",", ":"))
                for v in kids[0].to_pylist()]
        return H.strings_from_entries(np.arange(len(vals)), vals, None)
