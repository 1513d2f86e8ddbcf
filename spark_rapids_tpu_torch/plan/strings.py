"""String expressions over dictionary-coded columns.

Counterpart of spark_rapids_tpu/plan/strings.py: every family the
reference runs on its device path.  Each works once per dictionary
entry, and a row's result is a gather by its code:

  * **Predicates** — `StartsWith`, `EndsWith`, `Contains` with a literal
    pattern, and `Like`: the dictionary's byte tensors (ops/strings.py)
    on the device, one bool per entry.  A LIKE pattern outside the simple
    shapes (`compile_like`) is a full-match regex over the entries on the
    host, once per dictionary.  A row's validity is its string's; a null
    pattern gives null.
  * **Lengths** — `Length`, `OctetLength`, `BitLength` over the byte
    tensors.
  * **Dictionary transforms** (`DictTransform`) — `Upper`, `Lower`,
    `InitCap`, the trims, `Substring`, `Concat`, `ConcatWs`,
    `StringReplace`, the pads, `StringRepeat`, `Reverse`, `SplitPart`,
    `Translate`, `SubstringIndex`, `Left`, `Right`, `Base64E`,
    `UnBase64`, `SoundEx`, `Hex`, `Conv` and `ParseUrl` rewrite every
    dictionary entry.  Upper, lower, the trims without trim characters
    and substring run on the device for dictionaries of
    `sql.string.transformDeviceMinUnique` entries or more
    (ops/strings.py `transform_dict_device`); everything else runs the
    exact per-entry `_transform_value` on the host.  Either way the
    output dictionary is sorted and duplicate free and the row codes are
    remapped on the device, so group-by, IN, = and sort read codes as
    strings.  An entry whose transform is null (UnBase64 of invalid
    text, Conv of no digit, a missing URL part) has a validity lane
    entry that the rows gather and AND into their own validity; it is
    never the string 'None'.
  * **Integer lanes** (`DictIntTransform`) — `StringLocate`, `Instr`,
    `Ascii`, `Levenshtein` and `FindInSet`: one int32 per entry, on the
    host, gathered by code.

Arguments other than the one string operand must be literals on the
device, as in the reference.  Two non-literal operands (concat of two
columns), format_number and bin run on the CPU engine, as in the
reference.  RLIKE runs the regex transpiler's byte DFA over the
dictionary's byte tensors on the device (ops/regex.py), or a host mask
in the Python re dialect where the transpiler rejects the pattern;
regexp_extract and regexp_replace are dictionary transforms in the
Python re dialect behind the transpiler's subset check, as in the
reference.

Every class also has `_eval_cpu`, the CPU engine's evaluation
(exec/host_exec.py): the same per-entry Python functions over the
dictionary on the host, the rows gathered by code in numpy, each result
re-encoded into a sorted, duplicate-free dictionary; operands that are
not literals run once per distinct combination of values.

The port has no prepare-phase auxiliary inputs (the reference's
`pctx.add` / `ctx.aux_of`): each bound expression keeps what it derived
from a dictionary (byte tensors, entry masks, transforms), keyed by that
dictionary, for every batch that carries the same one.  A failing device
transform raises; it does not fall back to the host loop.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

import numpy as np
import torch

from .. import types as t
from ..columnar.host import HostColumn
from ..config import REGEX_MAX_DFA_STATES, STRING_TRANSFORM_DEVICE_MIN
from ..ops import host as H
from ..ops import strings as S
from ..ops.kernels import merge_validity
from ..ops.regex import (MAX_DFA_STATES, RegexUnsupported, compile_dfa,
                         dfa_matches_lanes, entry_order, utf8_lengths)
from ..runtime.capture import host_constant
from .expressions import (DevVal, Expression, HostVal, Literal,
                          dict_or_empty, per_dictionary)


def _lift(x) -> Expression:
    return x if isinstance(x, Expression) else Literal(x)


def _byte_tensors(e: Expression, d: np.ndarray, device):
    """The dictionary's (offsets, bytes), built once per dictionary."""
    return per_dictionary(e, "_bytes").get(
        d, lambda: S.dict_byte_tensors(d, device))


def _gather(lane: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return lane[torch.clamp(codes, 0, lane.shape[0] - 1).long()]


def _entry_lane(e: Expression, name: str, d: np.ndarray, fn, dtype):
    """(value lane, ok lane) of `fn` over each entry of `d` (None is a
    null result), once per dictionary: the CPU engine's per-entry work,
    which the rows gather by code (one not-ok entry for an empty
    dictionary)."""
    def make():
        vals = [fn(v) for v in d.tolist()] or [None]
        ok = np.array([v is not None for v in vals], bool)
        lane = np.array([0 if v is None else v for v in vals], dtype)
        return lane, ok
    return per_dictionary(e, name).get(d, make)


def _gather_np(col: HostColumn, lane: np.ndarray, ok: np.ndarray,
               dtype: t.DataType, *validity) -> HostColumn:
    codes = np.clip(col.data, 0, len(lane) - 1)
    return H.column(lane[codes], H.and_valid(col.validity, ok[codes],
                                             *validity), dtype)


def _row_tuples(kids: List[HostColumn]):
    """(tuple id per row, the Python values of each distinct tuple): the
    CPU engine's row-wise path for operands that are not literals, which
    works once per distinct combination of operand values."""
    n = len(kids[0])
    lanes = []
    for k in kids:
        lanes.append((~H.valid_of(k.validity, n)).astype(np.int64))
        lanes.append(H.order_lane(k) if k.data.dtype.kind != "f"
                     else k.data.astype(np.float64).view(np.int64))
    ids, count = H.factorize(lanes)
    if not n:
        return ids, []
    first = H.first_of_ids(ids, count)
    cols = [H.take(k, first).to_pylist() for k in kids]
    return ids, list(zip(*cols))


def _string_operand_reasons(e: Expression) -> List[str]:
    c = e.children[0]
    if not isinstance(c.dtype, (t.StringType, t.NullType)):
        return [f"operand is {c.dtype.simple_string}, not string"]
    return []


# ---------------------------------------------------------------------------
# Predicates over the dictionary's bytes
# ---------------------------------------------------------------------------

class StringPredicate(Expression):
    """predicate(string expression, literal pattern), evaluated per
    dictionary entry on the device and gathered by code."""
    kernel = None

    def __init__(self, left, right):
        self.children = (left, _lift(right))

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = True

    def unsupported_reasons(self, conf):
        out = []
        if not isinstance(self.children[1], Literal):
            out.append("search pattern must be a literal")
        return out + _string_operand_reasons(self)

    def _pattern(self) -> Optional[str]:
        return self.children[1].value

    def entry_mask(self, d: np.ndarray, device) -> torch.Tensor:
        """bool per dictionary entry (one False entry for an empty
        dictionary, whose rows are all null)."""
        def make():
            if len(d) == 0:
                return torch.zeros(1, dtype=torch.bool, device=device)
            offsets, bytes_ = _byte_tensors(self, d, device)
            return type(self).kernel(offsets, bytes_,
                                     self._pattern().encode("utf-8"))
        return per_dictionary(self, "_masks").get(d, make)

    def _eval_dev(self, ctx, kids):
        if self._pattern() is None:
            return DevVal(ctx.full(False, torch.bool),
                          ctx.full(False, torch.bool), t.BOOLEAN)
        s = kids[0]
        mask = self.entry_mask(dict_or_empty(s.dictionary), ctx.device)
        return DevVal(_gather(mask, s.data), s.validity, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        s, p = kids
        fn = type(self).py_fn
        if not isinstance(self.children[1], Literal):
            ids, rows = _row_tuples(kids)
            vals = [None if a is None or b is None else fn(a, b)
                    for a, b in rows]
            ok = np.array([v is not None for v in vals] or [False], bool)
            lane = np.array([bool(v) for v in vals] or [False], bool)
            return H.column(lane[ids], ok[ids], t.BOOLEAN)
        pat = self._pattern()
        if pat is None:
            n = batch.num_rows
            return H.column(np.zeros(n, bool), np.zeros(n, bool), t.BOOLEAN)
        lane, ok = _entry_lane(self, "_cpu_masks", dict_or_empty(
            s.dictionary), lambda v: fn(v, pat), bool)
        return _gather_np(s, lane, ok, t.BOOLEAN)

    def _fp_extra(self):
        return repr(self._pattern())


class StartsWith(StringPredicate):
    kernel = staticmethod(S.match_prefix)
    py_fn = staticmethod(lambda s, p: s.startswith(p))


class EndsWith(StringPredicate):
    kernel = staticmethod(S.match_suffix)
    py_fn = staticmethod(lambda s, p: s.endswith(p))


class Contains(StringPredicate):
    kernel = staticmethod(S.match_contains)
    py_fn = staticmethod(lambda s, p: p in s)


class Like(Expression):
    """str LIKE pattern (a Python string, with `escape`).  The simple
    shapes (equals, prefix, suffix, contains, prefix%suffix) run as the
    byte matchers on the device; any other pattern masks the dictionary
    on the host with its full-match regex (`re.DOTALL`: `%` and `_` take
    a newline too), once per dictionary.  Either way the rows gather the
    mask by code."""

    def __init__(self, left, pattern: str, escape: str = "\\"):
        self.children = (left,)
        self.pattern = pattern
        self.escape = escape
        self._plan = S.compile_like(pattern, escape)

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return _string_operand_reasons(self)

    def entry_mask(self, d: np.ndarray, device) -> torch.Tensor:
        def make():
            if len(d) == 0:
                return torch.zeros(1, dtype=torch.bool, device=device)
            if self._plan is not None:
                return self._plan.eval_device(*_byte_tensors(self, d, device))
            rx = re.compile(S.like_to_regex(self.pattern, self.escape),
                            re.DOTALL)
            mask = np.array([rx.fullmatch(v) is not None for v in d.tolist()],
                            bool)
            return host_constant(mask, device)
        return per_dictionary(self, "_masks").get(d, make)

    def _eval_dev(self, ctx, kids):
        s = kids[0]
        mask = self.entry_mask(dict_or_empty(s.dictionary), ctx.device)
        return DevVal(_gather(mask, s.data), s.validity, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        rx = re.compile(S.like_to_regex(self.pattern, self.escape),
                        re.DOTALL)
        lane, ok = _entry_lane(self, "_cpu_masks", dict_or_empty(
            kids[0].dictionary), lambda v: rx.fullmatch(v) is not None, bool)
        return _gather_np(kids[0], lane, ok, t.BOOLEAN)

    def _fp_extra(self):
        return f"{self.pattern!r};{self.escape!r}"


# ---------------------------------------------------------------------------
# Lengths over the dictionary's bytes
# ---------------------------------------------------------------------------

class Length(Expression):
    """length(str): characters (UTF-8 lead bytes) per entry, on the
    device, gathered by code."""

    def __init__(self, child):
        self.children = (child,)

    def _resolve(self):
        self.dtype = t.INT
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        return _string_operand_reasons(self)

    @staticmethod
    def _lane(offsets, bytes_) -> torch.Tensor:
        return S.char_lengths(offsets, bytes_)

    def _eval_dev(self, ctx, kids):
        s = kids[0]
        d = dict_or_empty(s.dictionary)
        def make():
            if len(d) == 0:
                return torch.zeros(1, dtype=torch.int32, device=ctx.device)
            return self._lane(*_byte_tensors(self, d, ctx.device)).to(
                torch.int32)
        lane = per_dictionary(self, "_lanes").get(d, make)
        return DevVal(_gather(lane, s.data), s.validity, t.INT)

    @staticmethod
    def _py_len(v: str) -> int:
        return len(v)

    def _eval_cpu(self, batch, kids):
        lane, ok = _entry_lane(self, "_cpu_lanes", dict_or_empty(
            kids[0].dictionary), self._py_len, np.int32)
        return _gather_np(kids[0], lane, ok, t.INT)


class OctetLength(Length):
    """octet_length(str): UTF-8 bytes per entry."""

    @staticmethod
    def _lane(offsets, bytes_):
        return S.byte_lengths(offsets)

    @staticmethod
    def _py_len(v: str) -> int:
        return len(v.encode("utf-8"))


class BitLength(Length):
    """bit_length(str): 8 x the UTF-8 bytes per entry."""

    @staticmethod
    def _lane(offsets, bytes_):
        return S.byte_lengths(offsets) * 8

    @staticmethod
    def _py_len(v: str) -> int:
        return 8 * len(v.encode("utf-8"))


# ---------------------------------------------------------------------------
# Dictionary transforms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rewritten:
    """A transformed dictionary: `dictionary` sorted and duplicate free;
    `remap` the int32 output code of every input entry on the device
    (one more, last, for the transform's null-operand row where it has
    one: ConcatWs); `valid` False where an entry's result is null (None:
    every entry's result is a string)."""
    dictionary: np.ndarray
    remap: torch.Tensor
    valid: Optional[torch.Tensor] = None


def _rewrite_on_host(values: List[Optional[str]], device) -> Rewritten:
    """The sorted, duplicate-free dictionary of the non-null `values`,
    each value's code in it, and a validity lane if any value is None."""
    ok = np.array([v is not None for v in values], bool)
    out = np.array([v if v is not None else "" for v in values], str)
    uniq, inverse = np.unique(out[ok], return_inverse=True)
    codes = np.zeros(len(values), np.int32)
    codes[ok] = inverse.reshape(-1)
    return Rewritten(uniq.astype(str), host_constant(codes, device),
                     None if ok.all() else host_constant(ok, device))


class DictTransform(Expression):
    """Rewrites the dictionary of its one non-literal string child; the
    other children are literal arguments.  A row's validity is the AND
    of its children's and of its entry's result (`Rewritten.valid`).
    Subclasses give the exact per-entry `_transform_value(s, args)`
    (None for a null result), and `device_transform_kind` where the
    device rewrites the entries (ops/strings.py)."""
    #: indexes of children that must be literals
    literal_slots: tuple = ()

    def _resolve(self):
        self.dtype = t.STRING
        self.nullable = True

    def _code_child_index(self) -> int:
        for i, c in enumerate(self.children):
            if not isinstance(c, Literal):
                return i
        return 0

    def unsupported_reasons(self, conf):
        out = []
        ci = self._code_child_index()
        others = [i for i, c in enumerate(self.children)
                  if i != ci and not isinstance(c, Literal)]
        out += [f"argument {i} must be a literal" for i in others
                if i in self.literal_slots]
        if any(i not in self.literal_slots for i in others):
            out.append("more than one non-literal string operand "
                       "(dictionary transform needs a single code lane)")
        code = self.children[ci]
        if not isinstance(code.dtype, (t.StringType, t.NullType)):
            out.append(f"operand is {code.dtype.simple_string}, not string")
        return out

    def _args(self) -> List[object]:
        return [c.value if isinstance(c, Literal) else None
                for c in self.children]

    def _all_null(self) -> bool:
        """A null literal argument makes every row null (the row's
        validity ANDs the literal's): no entry is transformed."""
        ci = self._code_child_index()
        return any(isinstance(c, Literal) and c.value is None
                   for i, c in enumerate(self.children) if i != ci)

    def device_transform_kind(self):
        """(kind, args) of ops/strings.py transform_dict_device, or None
        when only the host loop runs this transform."""
        return None

    def _transform_value(self, s: str, args) -> Optional[str]:
        """The exact per-entry transform (the host loop)."""
        raise NotImplementedError

    def _null_row(self, args) -> Optional[str]:
        """The result of a row whose string operand is null: None (the
        row is null) except where the function skips null operands."""
        return None

    def transformed(self, d: np.ndarray, conf, device) -> Rewritten:
        """Input dictionary `d` rewritten (once per dictionary)."""
        def make():
            args = self._args()
            extra = None if self._all_null() else self._null_row(args)
            if self._all_null() or (len(d) == 0 and extra is None):
                return Rewritten(np.array([], str), torch.zeros(
                    len(d) + 1, dtype=torch.int32, device=device))
            kind = self.device_transform_kind()
            if kind is not None and extra is None and \
                    len(d) >= conf.get(STRING_TRANSFORM_DEVICE_MIN):
                out, remap = S.transform_dict_device(
                    d, kind[0], kind[1], device,
                    byte_tensors=_byte_tensors(self, d, device)
                    if kind[0] == "substr" else None)
                return Rewritten(out, remap)
            values = [self._transform_value(v, args) for v in d.tolist()]
            if extra is not None:
                values.append(extra)
            return _rewrite_on_host(values, device)
        return per_dictionary(self, "_transforms").get(d, make)

    def _prepare(self, pctx, kids):
        d = dict_or_empty(kids[self._code_child_index()].dictionary)
        return HostVal(self.transformed(d, pctx.conf, pctx.device)
                       .dictionary)

    def _eval_dev(self, ctx, kids):
        k = kids[self._code_child_index()]
        rw = self.transformed(dict_or_empty(k.dictionary), ctx.conf,
                              ctx.device)
        codes = _gather(rw.remap, k.data)
        valid = merge_validity(*(v.validity for v in kids),
                               None if rw.valid is None
                               else _gather(rw.valid, k.data))
        return DevVal(codes, valid, t.STRING, rw.dictionary)

    def _row_value(self, values) -> Optional[str]:
        """The result of one row from all its operand values (the CPU
        engine's path for operands that are not literals): null if any
        operand is."""
        if any(v is None for v in values):
            return None
        return self._transform_value(values[self._code_child_index()],
                                     list(values))

    def _eval_cpu(self, batch, kids):
        """Each dictionary entry transformed once, the rows gathered by
        code; with more than one non-literal operand, each distinct
        combination of operand values once."""
        ci = self._code_child_index()
        if any(i != ci and not isinstance(c, Literal)
               for i, c in enumerate(self.children)):
            ids, rows = _row_tuples(kids)
            return H.strings_from_entries(
                ids, [self._row_value(r) for r in rows], None)
        k = kids[ci]
        d = dict_or_empty(k.dictionary)
        args = self._args()
        n = batch.num_rows
        if self._all_null():
            return H.string_literal_column(None, n)
        values = per_dictionary(self, "_cpu_entries").get(
            d, lambda: [self._transform_value(v, args) for v in d.tolist()]
            + [self._null_row(args)])
        codes = np.clip(k.data, 0, max(len(d) - 1, 0))
        if k.validity is not None:
            codes = np.where(k.validity, codes, len(d))
        return H.strings_from_entries(codes, values,
                                      self._literal_validity(kids, ci))

    def _literal_validity(self, kids, ci):
        """The rows' validity from the literal operands: a null one
        nulls the row."""
        return H.and_valid(*(c.validity for i, c in enumerate(kids)
                             if i != ci))


class Upper(DictTransform):
    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        return s.upper()

    def device_transform_kind(self):
        return ("upper", ())


class Lower(DictTransform):
    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        return s.lower()

    def device_transform_kind(self):
        return ("lower", ())


class InitCap(DictTransform):
    """initcap: the first letter of each space-separated word upper, the
    rest lower."""

    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        out = []
        cap = True
        for ch in s.lower():
            if cap and ch.isalpha():
                out.append(ch.upper())
                cap = False
            else:
                out.append(ch)
            if ch == " ":
                cap = True
        return "".join(out)


class StringTrim(DictTransform):
    """trim(str[, chars]): Python's str.strip (white space by
    str.isspace, or the literal `chars`), as the reference runs it."""
    _strip = staticmethod(lambda s, chars: s.strip(chars))
    _device_kind = "trim"

    def __init__(self, child, trim_chars: Optional[Expression] = None):
        self.children = (child,) + ((_lift(trim_chars),)
                                    if trim_chars is not None else ())
        self.literal_slots = (1,) if trim_chars is not None else ()

    def _transform_value(self, s, args):
        return type(self)._strip(s, args[1] if len(args) > 1 else None)

    def device_transform_kind(self):
        if len(self.children) > 1:
            return None             # trim characters: the host loop
        return (self._device_kind, ())


class StringTrimLeft(StringTrim):
    _strip = staticmethod(lambda s, chars: s.lstrip(chars))
    _device_kind = "ltrim"


class StringTrimRight(StringTrim):
    _strip = staticmethod(lambda s, chars: s.rstrip(chars))
    _device_kind = "rtrim"


def _spark_substring(s: str, pos: int, length: Optional[int]) -> str:
    n = len(s)
    if length is not None and length <= 0:
        return ""
    if pos > 0:
        start = pos - 1
    elif pos == 0:
        start = 0
    else:
        start = max(n + pos, 0)
    end = n if length is None else min(start + length, n)
    return s[start:end] if start < n else ""


class Substring(DictTransform):
    """substring(str, pos[, len]): 1-based, by characters, with Spark's
    rules for pos 0 and a negative pos.  pos and len are literals; a null
    one makes every row null."""
    literal_slots = (1, 2)

    def __init__(self, child, pos, length=None):
        kids = (child, _lift(pos))
        if length is not None:
            kids += (_lift(length),)
        self.children = kids

    def _pos_len(self):
        args = self._args()
        return args[1], (args[2] if len(args) > 2 else None)

    def _transform_value(self, s, args):
        pos, length = args[1], (args[2] if len(args) > 2 else None)
        return _spark_substring(s, int(pos), None if length is None
                                else int(length))

    def device_transform_kind(self):
        pos, length = self._pos_len()
        return ("substr", (int(pos), None if length is None
                           else int(length)))

    def _fp_extra(self):
        return repr(self._pos_len())


class Concat(DictTransform):
    """concat(...) of one string column and literals: null if any
    operand is null."""

    def __init__(self, *children):
        self.children = tuple(_lift(c) for c in children)

    def _transform_value(self, s, args):
        ci = self._code_child_index()
        return "".join(s if i == ci else str(a) for i, a in enumerate(args))

    def _row_value(self, values):
        if any(v is None for v in values):
            return None
        return "".join(str(v) for v in values)


class ConcatWs(DictTransform):
    """concat_ws(sep, ...): null operands are skipped, so a row whose
    string operand is null still joins the literal parts (an entry of
    its own, `_null_row`); only a null separator makes the row null."""
    literal_slots = (0,)

    def __init__(self, sep, *children):
        self.children = (_lift(sep),) + tuple(_lift(c) for c in children)

    def _code_child_index(self):
        for i, c in enumerate(self.children[1:], start=1):
            if not isinstance(c, Literal):
                return i
        return 1 if len(self.children) > 1 else 0

    def _all_null(self):
        return self._args()[0] is None

    def _transform_value(self, s, args):
        ci = self._code_child_index()
        return args[0].join(s if i == ci else str(a)
                            for i, a in enumerate(args)
                            if i != 0 and (i == ci or a is not None))

    def _null_row(self, args):
        ci = self._code_child_index()
        return args[0].join(str(a) for i, a in enumerate(args)
                            if i not in (0, ci) and a is not None)

    def _row_value(self, values):
        if values[0] is None:
            return None
        return values[0].join(str(v) for v in values[1:] if v is not None)

    def _literal_validity(self, kids, ci):
        # null operands are skipped: only a null separator nulls a row
        return kids[0].validity

    def _eval_dev(self, ctx, kids):
        sep = kids[0]
        k = kids[self._code_child_index()]
        d = dict_or_empty(k.dictionary)
        rw = self.transformed(d, ctx.conf, ctx.device)
        codes = torch.clamp(k.data, 0, max(len(d) - 1, 0)).long()
        if k.validity is not None:
            # a null operand takes the literals-only entry, code len(d)
            codes = torch.where(k.validity, codes, len(d))
        return DevVal(rw.remap[codes], sep.validity, t.STRING, rw.dictionary)


class StringReplace(DictTransform):
    literal_slots = (1, 2)

    def __init__(self, child, search, replace):
        self.children = (child, _lift(search), _lift(replace))

    def _transform_value(self, s, args):
        search, repl = args[1], args[2]
        if search == "":
            return s
        return s.replace(search, repl)


class StringPad(DictTransform):
    literal_slots = (1, 2)
    _left = True

    def __init__(self, child, length, pad=" "):
        self.children = (child, _lift(length), _lift(pad))

    def _transform_value(self, s, args):
        length, pad = int(args[1]), args[2]
        if length <= 0:
            return ""                    # Spark: no slicing from the end
        if length <= len(s):
            return s[:length]
        if not pad:
            return s
        fill = (pad * ((length - len(s)) // len(pad) + 1))[: length - len(s)]
        return fill + s if self._left else s + fill


class Lpad(StringPad):
    _left = True


class Rpad(StringPad):
    _left = False


class StringRepeat(DictTransform):
    literal_slots = (1,)

    def __init__(self, child, times):
        self.children = (child, _lift(times))

    def _transform_value(self, s, args):
        return s * max(int(args[1]), 0)


class Reverse(DictTransform):
    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        return s[::-1]


class SplitPart(DictTransform):
    """split_part(str, delim, part): 1-based, a negative part counts from
    the end, out of range gives ''; an empty delimiter gives null."""
    literal_slots = (1, 2)

    def __init__(self, child, delim, part):
        self.children = (child, _lift(delim), _lift(part))

    def _transform_value(self, s, args):
        delim, part = args[1], int(args[2])
        if not delim:
            return None
        parts = s.split(delim)
        idx = part - 1 if part > 0 else len(parts) + part
        if part == 0 or idx < 0 or idx >= len(parts):
            return ""
        return parts[idx]


class Translate(DictTransform):
    """translate(str, from, to): per character; a `from` character past
    the end of `to` is deleted, the first mapping of a repeat wins."""
    literal_slots = (1, 2)

    def __init__(self, child, matching, replace):
        self.children = (child, _lift(matching), _lift(replace))

    def _transform_value(self, s, args):
        m, r = args[1], args[2]
        table = {}
        for i, ch in enumerate(m):
            if ch not in table:
                table[ch] = r[i] if i < len(r) else None
        return "".join(c for c in (table.get(ch, ch) for ch in s)
                       if c is not None)


class SubstringIndex(DictTransform):
    """substring_index(str, delim, count)."""
    literal_slots = (1, 2)

    def __init__(self, child, delim, count):
        self.children = (child, _lift(delim), _lift(count))

    def _transform_value(self, s, args):
        delim, count = args[1], int(args[2])
        if delim == "" or count == 0:
            return ""
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        return delim.join(parts[count:])


class Left(DictTransform):
    literal_slots = (1,)

    def __init__(self, child, n):
        self.children = (child, _lift(n))

    def _transform_value(self, s, args):
        n = int(args[1])
        return "" if n <= 0 else s[:n]


class Right(DictTransform):
    literal_slots = (1,)

    def __init__(self, child, n):
        self.children = (child, _lift(n))

    def _transform_value(self, s, args):
        n = int(args[1])
        return "" if n <= 0 else s[-n:]


class Base64E(DictTransform):
    """base64(str): base64 of the UTF-8 bytes."""

    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        import base64
        return base64.b64encode(s.encode("utf-8")).decode("ascii")


class UnBase64(DictTransform):
    """unbase64(str) decoded as UTF-8: invalid base64, or bytes that are
    not UTF-8, give null."""

    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        import base64
        import binascii
        try:
            return base64.b64decode(s, validate=True).decode("utf-8")
        except (binascii.Error, ValueError):
            return None


class SoundEx(DictTransform):
    """soundex(str): the classic four-character code; a string that does
    not start with an ASCII letter is returned as it is."""
    _CODES = {c: d for cs, d in [("BFPV", "1"), ("CGJKQSXZ", "2"),
                                 ("DT", "3"), ("L", "4"), ("MN", "5"),
                                 ("R", "6")] for c in cs}

    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        if not s:
            return s
        first = s[0].upper()
        if not first.isalpha() or not first.isascii():
            return s
        out = [first]
        prev = self._CODES.get(first, "")
        for ch in s[1:].upper():
            code = self._CODES.get(ch, "")
            if code and code != prev:
                out.append(code)
                if len(out) == 4:
                    break
            if ch not in "HW":
                prev = code
        return "".join(out).ljust(4, "0")


class Hex(DictTransform):
    """hex(str): upper-case hex of the UTF-8 bytes."""

    def __init__(self, child):
        self.children = (child,)

    def _transform_value(self, s, args):
        return s.encode("utf-8").hex().upper()


class Conv(DictTransform):
    """conv(num, from_base, to_base): bases 2..36 (a negative to_base
    renders signed); digits stop at the first invalid character, no
    digit gives null, overflow saturates at the unsigned 64-bit
    maximum."""
    literal_slots = (1, 2)

    def __init__(self, child, from_base, to_base):
        self.children = (child, _lift(from_base), _lift(to_base))

    def _transform_value(self, s, args):
        fb, tb = int(args[1]), int(args[2])
        if not (2 <= fb <= 36 and 2 <= abs(tb) <= 36):
            return None
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"
        s2 = s.strip()
        neg = s2.startswith("-")
        if neg:
            s2 = s2[1:]
        val = 0
        seen = False
        for ch in s2.lower():
            d = digits.find(ch)
            if d < 0 or d >= abs(fb):
                break
            val = val * abs(fb) + d
            seen = True
        if not seen:
            return None
        if val >= (1 << 64):
            val = (1 << 64) - 1
            neg = False
        if neg:
            val = -val
        if tb > 0:
            val &= (1 << 64) - 1
            sign = ""
        else:
            sign = "-" if val < 0 else ""
            val = abs(val)
            tb = -tb
        if val == 0:
            return "0"
        out = []
        while val:
            out.append(digits[val % tb])
            val //= tb
        return sign + "".join(reversed(out)).upper()


class ParseUrl(DictTransform):
    """parse_url(url, part[, key]): PROTOCOL, HOST, PATH, QUERY, REF,
    FILE, AUTHORITY or USERINFO; with QUERY a key extracts one query
    parameter.  A URL without a scheme, and an absent part, give null."""
    literal_slots = (1, 2)
    _PARTS = ("PROTOCOL", "HOST", "PATH", "QUERY", "REF", "FILE",
              "AUTHORITY", "USERINFO")

    def __init__(self, child, part, key=None):
        self.children = (child, _lift(part)) + (
            (_lift(key),) if key is not None else ())

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        part = self.children[1].value \
            if isinstance(self.children[1], Literal) else None
        if part is not None and str(part).upper() not in self._PARTS:
            out.append(f"parse_url part {part!r} is not a Spark part")
        return out

    def _transform_value(self, s, args):
        from urllib.parse import parse_qs, urlparse
        part = str(args[1]).upper()
        key = args[2] if len(args) > 2 else None
        try:
            u = urlparse(s)
            if not u.scheme:
                return None
        except ValueError:
            return None
        if part == "QUERY" and key is not None:
            vals = parse_qs(u.query, keep_blank_values=False).get(key)
            return vals[0] if vals else None
        # java.net.URI keeps the host's case (urllib's .hostname lowers
        # it): the raw host from netloc, without userinfo and port
        raw_host = u.netloc.rsplit("@", 1)[-1]
        if raw_host.startswith("["):
            end = raw_host.find("]")
            raw_host = raw_host[:end + 1] if end >= 0 else None
        else:
            raw_host = raw_host.split(":", 1)[0] or None
        return {
            "PROTOCOL": u.scheme or None,
            "HOST": raw_host,
            "PATH": u.path if (u.path or u.netloc) else None,
            "QUERY": u.query or None,
            "REF": u.fragment or None,
            "FILE": (u.path + ("?" + u.query if u.query else ""))
            if (u.path or u.query or u.netloc) else None,
            "AUTHORITY": u.netloc or None,
            "USERINFO": (u.username or "") + (":" + u.password
                                              if u.password else "")
            if (u.username or u.password) else None,
        }.get(part)


# ---------------------------------------------------------------------------
# Integer lanes per dictionary entry
# ---------------------------------------------------------------------------

class DictIntTransform(Expression):
    """An int32 per dictionary entry (`_per_entry`, on the host; None is
    a null result), gathered by code.  Every child but the string operand
    must be a literal; a null literal makes every row null."""
    result_type = t.INT

    def _resolve(self):
        self.dtype = type(self).result_type
        self.nullable = True

    def _code_child_index(self) -> int:
        for i, c in enumerate(self.children):
            if not isinstance(c, Literal):
                return i
        return 0

    def _args(self) -> List[object]:
        return [c.value if isinstance(c, Literal) else None
                for c in self.children]

    def unsupported_reasons(self, conf):
        ci = self._code_child_index()
        out = [f"argument {i} must be a literal"
               for i, c in enumerate(self.children)
               if i != ci and not isinstance(c, Literal)]
        code = self.children[ci]
        if not isinstance(code.dtype, (t.StringType, t.NullType)):
            out.append(f"operand is {code.dtype.simple_string}, not string")
        return out

    def _per_entry(self, s: str, args) -> Optional[int]:
        raise NotImplementedError

    def entry_lanes(self, d: np.ndarray, device):
        """(int32 value lane, bool validity lane or None) per entry."""
        def make():
            ci = self._code_child_index()
            args = self._args()
            if any(a is None for i, a in enumerate(args) if i != ci) or \
                    len(d) == 0:
                return torch.zeros(max(len(d), 1), dtype=torch.int32,
                                   device=device), None
            vals = [self._per_entry(v, args) for v in d.tolist()]
            ok = np.array([v is not None for v in vals], bool)
            lane = np.array([0 if v is None else v for v in vals], np.int32)
            return (host_constant(lane, device),
                    None if ok.all() else host_constant(ok, device))
        return per_dictionary(self, "_lanes").get(d, make)

    def _eval_dev(self, ctx, kids):
        k = kids[self._code_child_index()]
        lane, ok = self.entry_lanes(dict_or_empty(k.dictionary), ctx.device)
        valid = merge_validity(*(v.validity for v in kids),
                               None if ok is None else _gather(ok, k.data))
        return DevVal(_gather(lane, k.data), valid, self.dtype)

    def _eval_cpu(self, batch, kids):
        ci = self._code_child_index()
        if any(i != ci and not isinstance(c, Literal)
               for i, c in enumerate(self.children)):
            ids, rows = _row_tuples(kids)
            vals = [None if any(v is None for v in r) else
                    self._per_entry(r[ci], list(r)) for r in rows]
            ok = np.array([v is not None for v in vals] or [False], bool)
            lane = np.array([0 if v is None else v for v in vals] or [0],
                            np.int32)
            return H.column(lane[ids], ok[ids], self.dtype)
        args = self._args()
        if any(a is None for i, a in enumerate(args) if i != ci):
            n = batch.num_rows
            return H.column(np.zeros(n, np.int32), np.zeros(n, bool),
                            self.dtype)
        k = kids[ci]
        lane, ok = _entry_lane(self, "_cpu_lanes", dict_or_empty(
            k.dictionary), lambda v: self._per_entry(v, args), np.int32)
        return _gather_np(k, lane, ok, self.dtype,
                          *(c.validity for i, c in enumerate(kids)
                            if i != ci))


class StringLocate(DictIntTransform):
    """locate(substr, str[, start]): the 1-based position of substr at or
    after start, 0 if absent or start <= 0."""

    def __init__(self, substr, string, start=1):
        self.children = (_lift(substr), string, _lift(start))

    def _code_child_index(self):
        return 1

    def _per_entry(self, s, args):
        sub, start = args[0], int(args[2])
        if start <= 0:
            return 0
        return s.find(sub, start - 1) + 1


class Instr(DictIntTransform):
    """instr(str, substr): the 1-based position of substr, 0 if absent."""

    def __init__(self, string, substr):
        self.children = (string, _lift(substr))

    def _code_child_index(self):
        return 0

    def _per_entry(self, s, args):
        return s.find(args[1]) + 1


class Ascii(DictIntTransform):
    """ascii(str): the code point of the first character, 0 if empty."""

    def __init__(self, child):
        self.children = (child,)

    def _per_entry(self, s, args):
        return ord(s[0]) if s else 0


class Levenshtein(DictIntTransform):
    """levenshtein(str, literal): the edit distance in characters."""

    def __init__(self, child, other):
        self.children = (child, _lift(other))

    def _per_entry(self, s, args):
        b = args[1]
        if len(s) < len(b):
            s, b = b, s
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(s, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]


class FindInSet(DictIntTransform):
    """find_in_set(literal, str): the 1-based index of the literal in the
    comma-separated list, 0 if absent or if the literal holds a comma."""

    def __init__(self, needle, child):
        self.children = (_lift(needle), child)

    def _per_entry(self, s, args):
        needle = args[0]
        if "," in needle:
            return 0
        parts = s.split(",")
        return parts.index(needle) + 1 if needle in parts else 0


# ---------------------------------------------------------------------------
# Families that only the CPU engine runs
# ---------------------------------------------------------------------------

class _PerRowString(Expression):
    """A string function that the reference runs only on its CPU engine
    (per-row string building): `unsupported_reasons` says so, and
    `_eval_cpu` formats each distinct value once."""
    result_type = t.STRING
    what = ""

    def _resolve(self):
        self.dtype = self.result_type
        self.nullable = True

    def unsupported_reasons(self, conf):
        return ["per-row string building (CPU path)"]

    def _format(self, v) -> str:
        raise NotImplementedError

    def _eval_cpu(self, batch, kids):
        ids, rows = _row_tuples(kids)
        return H.strings_from_entries(
            ids, [None if r[0] is None else self._format(r[0])
                  for r in rows], None)


class FormatNumber(_PerRowString):
    """format_number(x, d): HALF_EVEN to d places, thousands separated
    by commas."""

    def __init__(self, child, d: int):
        self.children = (child,)
        self.d = int(d)

    def _format(self, v):
        import decimal as pydec
        q = pydec.Decimal(str(v)).quantize(pydec.Decimal(1).scaleb(-self.d),
                                           rounding=pydec.ROUND_HALF_EVEN)
        return f"{q:,.{self.d}f}"

    def _fp_extra(self):
        return str(self.d)


class Bin(_PerRowString):
    """bin(x): the binary digits of the 64-bit two's complement value."""

    def __init__(self, child):
        self.children = (child,)

    def unsupported_reasons(self, conf):
        if not t.is_integral(self.children[0].dtype):
            return [f"bin over {self.children[0].dtype.simple_string}"]
        return super().unsupported_reasons(conf)

    def _format(self, v):
        return format(int(v) & ((1 << 64) - 1), "b")


def _java_replacement_to_python(rep: str) -> str:
    """A Java replacement string ($N group references, backslash escapes)
    as a Python re template."""
    out = []
    i = 0
    while i < len(rep):
        c = rep[i]
        if c == "$" and i + 1 < len(rep) and rep[i + 1].isdigit():
            out.append("\\" + rep[i + 1])
            i += 2
        elif c == "\\" and i + 1 < len(rep):
            nxt = rep[i + 1]
            out.append("\\\\" if nxt == "\\" else nxt)
            i += 2
        elif c == "\\":
            out.append("\\\\")
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _automaton(e, conf):
    """The DFA of `e.pattern` under the session's state budget
    (`sql.regexp.maxStates`): the default budget's automaton is built
    once at construction; a pattern it rejected for its state count is
    tried again under a raised budget, as the reference retries at tag
    time.  None when the transpiler rejects the pattern."""
    if e._dfa is None and conf is not None and \
            "state blowup" in (e._reject or ""):
        budget = conf.get(REGEX_MAX_DFA_STATES)
        if budget != MAX_DFA_STATES:
            try:
                e._dfa = compile_dfa(e.pattern, max_states=budget)
                e._reject = None
            except RegexUnsupported as err:
                e._reject = str(err)
    return e._dfa


class RLike(Expression):
    """str RLIKE regex (an unanchored find).

    A pattern inside the transpiler's Java-regex subset (ops/regex.py,
    the reference's CudfRegexTranspiler role) runs on the device as a
    byte DFA over the dictionary's byte tensors (`dfa_matches_lanes`),
    once per dictionary; a rejected pattern masks the dictionary on the
    host with Python `re` (the reference's documented dialect
    deviation).  Either way the rows gather the mask by code."""

    def __init__(self, left, pattern: str):
        self.children = (left,)
        self.pattern = pattern
        try:
            self._dfa = compile_dfa(pattern)
            self._reject = None
        except RegexUnsupported as err:
            self._dfa = None
            self._reject = str(err)

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = self.children[0].nullable

    def unsupported_reasons(self, conf):
        _automaton(self, conf)
        return _string_operand_reasons(self)

    def entry_mask(self, d: np.ndarray, conf, device) -> torch.Tensor:
        """bool per dictionary entry (one False entry for an empty
        dictionary)."""
        def make():
            if len(d) == 0:
                return torch.zeros(1, dtype=torch.bool, device=device)
            dfa = _automaton(self, conf)
            if dfa is None:
                rx = re.compile(self.pattern)
                return host_constant(np.array(
                    [rx.search(v) is not None for v in d.tolist()], bool),
                    device)
            offsets, bytes_ = _byte_tensors(self, d, device)
            order = entry_order(utf8_lengths(d), device)
            return dfa_matches_lanes(
                host_constant(dfa.table.T.astype(np.int16), device),
                host_constant(dfa.accepting, device), offsets, bytes_,
                order)
        return per_dictionary(self, "_masks").get(d, make)

    def _eval_dev(self, ctx, kids):
        s = kids[0]
        mask = self.entry_mask(dict_or_empty(s.dictionary), ctx.conf,
                               ctx.device)
        return DevVal(_gather(mask, s.data), s.validity, t.BOOLEAN)

    def _eval_cpu(self, batch, kids):
        rx = re.compile(self.pattern)
        lane, ok = _entry_lane(self, "_cpu_masks", dict_or_empty(
            kids[0].dictionary), lambda v: rx.search(v) is not None, bool)
        return _gather_np(kids[0], lane, ok, t.BOOLEAN)

    def _fp_extra(self):
        return f"{self.pattern!r}"


def _validated_regex(pattern: str):
    """(the compiled Python re, the transpiler's reject reason or None).
    The subset check decides whether Java's and Python's semantics agree
    well enough for the pattern to place on the device path; a rejected
    pattern is tagged, so its operator falls back visibly (the transform
    runs on the host either way).  A pattern Python cannot compile is an
    analysis error, as in Spark."""
    try:
        rx = re.compile(pattern)
    except re.error as err:
        raise ValueError(f"invalid regexp pattern {pattern!r}: {err}") \
            from err
    try:
        compile_dfa(pattern)
        return rx, None
    except RegexUnsupported as err:
        return rx, str(err)


class RegexpExtract(DictTransform):
    """regexp_extract(str, pattern, idx): group `idx` of the first match,
    "" without one (Spark's semantics), a dictionary transform in the
    Python re dialect behind the transpiler's subset check (the
    reference's documented deviation)."""

    def __init__(self, subject, pattern: str, idx: int = 1):
        self.children = (subject,)
        self.pattern = pattern
        self.idx = idx
        self._rx, self._subset_reject = _validated_regex(pattern)

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        if self._subset_reject is not None:
            out.append(f"pattern outside the Java-regex subset "
                       f"({self._subset_reject}); CPU fallback evaluates "
                       "in the Python re dialect")
        if self.idx < 0 or self.idx > self._rx.groups:
            out.append(f"group index {self.idx} out of range "
                       f"(pattern has {self._rx.groups})")
        return out

    def _transform_value(self, s, args):
        m = self._rx.search(s)
        if m is None:
            return ""
        g = m.group(self.idx)
        return "" if g is None else g

    def _fp_extra(self):
        return f"{self.pattern!r};{self.idx}"


class RegexpReplace(DictTransform):
    """regexp_replace(str, pattern, replacement): every match replaced
    (Spark's semantics), Java's $N group references in the replacement;
    a dictionary transform behind the subset check, as RegexpExtract."""

    def __init__(self, subject, pattern: str, replacement: str):
        self.children = (subject,)
        self.pattern = pattern
        self.replacement = replacement
        self._rx, self._subset_reject = _validated_regex(pattern)
        self._py_rep = _java_replacement_to_python(replacement)

    def unsupported_reasons(self, conf):
        out = super().unsupported_reasons(conf)
        if self._subset_reject is not None:
            out.append(f"pattern outside the Java-regex subset "
                       f"({self._subset_reject}); CPU fallback evaluates "
                       "in the Python re dialect")
        return out

    def _transform_value(self, s, args):
        return self._rx.sub(self._py_rep, s)

    def _fp_extra(self):
        return f"{self.pattern!r};{self.replacement!r}"
