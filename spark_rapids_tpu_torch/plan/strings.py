"""String expressions over dictionary-coded columns.

Counterpart of spark_rapids_tpu/plan/strings.py for what the TPC-H
queries reach.  Both shapes work once per dictionary entry and gather a
row's result by its code:

  * **Predicates** — `StartsWith`, `EndsWith`, `Contains` with a literal
    pattern: the dictionary's byte tensors (ops/strings.py) on the
    device, one bool per entry, gathered by code.  A row's validity is
    its string's; a null pattern gives null.
  * **Dictionary transforms** — `Substring` rewrites every dictionary
    entry.  Dictionaries of `sql.string.transformDeviceMinUnique` entries
    or more are rewritten on the device (ops/strings.py
    `transform_dict_device`), smaller ones by an exact per-entry loop on
    the host.  Either way the output dictionary is sorted and duplicate
    free and the row codes are remapped on the device, so group-by, IN,
    = and sort read codes as strings (q22's 1,500,000 phones have 25
    two-character prefixes).

The port has no prepare-phase auxiliary inputs (the reference's
`pctx.add` / `ctx.aux_of`): each bound expression keeps what it derived
from a dictionary (byte tensors, entry masks, transforms), keyed by that
dictionary, for every batch that carries the same one.  A failing device
transform raises; it does not fall back to the host loop.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import types as t
from ..config import STRING_TRANSFORM_DEVICE_MIN
from ..ops import strings as S
from ..ops.kernels import merge_validity
from .expressions import DevVal, Expression, HostVal, Literal

#: dictionaries an expression keeps derived tensors for at once
_CACHE_ENTRIES = 4


def _dict_or_empty(d: Optional[np.ndarray]) -> np.ndarray:
    return np.array([], str) if d is None else d


class _PerDictionary:
    """What an expression derived from each dictionary it met, by the
    dictionary's identity (the entry holds the dictionary, so its id is
    not reused while cached)."""

    def __init__(self):
        self.entries = {}

    def get(self, d: np.ndarray, make):
        hit = self.entries.get(id(d))
        if hit is not None and hit[0] is d:
            return hit[1]
        value = make()
        if len(self.entries) >= _CACHE_ENTRIES:
            self.entries.pop(next(iter(self.entries)))
        self.entries[id(d)] = (d, value)
        return value


def _per_dictionary(e: Expression, name: str) -> _PerDictionary:
    """The expression's own cache (bound copies each make theirs)."""
    cache = e.__dict__.get(name)
    if cache is None:
        cache = e.__dict__[name] = _PerDictionary()
    return cache


# ---------------------------------------------------------------------------
# Predicates over the dictionary's bytes
# ---------------------------------------------------------------------------

class StringPredicate(Expression):
    """predicate(string expression, literal pattern), evaluated per
    dictionary entry on the device and gathered by code."""
    kernel = None

    def __init__(self, left, right):
        self.children = (left, right if isinstance(right, Expression)
                         else Literal(right))

    def _resolve(self):
        self.dtype = t.BOOLEAN
        self.nullable = True

    def unsupported_reasons(self, conf):
        out = []
        if not isinstance(self.children[1], Literal):
            out.append("search pattern must be a literal")
        if not isinstance(self.children[0].dtype, (t.StringType,
                                                   t.NullType)):
            out.append("operand is "
                       f"{self.children[0].dtype.simple_string}, not string")
        return out

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
        return _per_dictionary(self, "_masks").get(d, make)

    def _eval_dev(self, ctx, kids):
        if self._pattern() is None:
            return DevVal(ctx.full(False, torch.bool),
                          ctx.full(False, torch.bool), t.BOOLEAN)
        s = kids[0]
        mask = self.entry_mask(_dict_or_empty(s.dictionary), ctx.device)
        codes = torch.clamp(s.data, 0, mask.shape[0] - 1).long()
        return DevVal(mask[codes], s.validity, t.BOOLEAN)

    def _fp_extra(self):
        return repr(self._pattern())


def _byte_tensors(e: Expression, d: np.ndarray, device):
    """The dictionary's (offsets, bytes), built once per dictionary."""
    return _per_dictionary(e, "_bytes").get(
        d, lambda: S.dict_byte_tensors(d, device))


class StartsWith(StringPredicate):
    kernel = staticmethod(S.match_prefix)


class EndsWith(StringPredicate):
    kernel = staticmethod(S.match_suffix)


class Contains(StringPredicate):
    kernel = staticmethod(S.match_contains)


# ---------------------------------------------------------------------------
# Dictionary transforms
# ---------------------------------------------------------------------------

class DictTransform(Expression):
    """Rewrites the dictionary of its one non-literal string child; the
    other children are literal arguments.  The output dictionary is
    sorted and duplicate-free, and the child's codes are remapped into
    it on the device.  A row's validity is the AND of its children's."""
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
        non_lit = [i for i, c in enumerate(self.children)
                   if not isinstance(c, Literal)
                   and isinstance(c.dtype, (t.StringType, t.NullType))]
        if len(non_lit) > 1:
            out.append("more than one non-literal string operand "
                       "(a dictionary transform needs a single code lane)")
        for i in self.literal_slots:
            if i < len(self.children) and \
                    not isinstance(self.children[i], Literal):
                out.append(f"argument {i} must be a literal")
        return out

    def _args(self) -> List[object]:
        return [c.value if isinstance(c, Literal) else None
                for c in self.children]

    def device_transform_kind(self):
        """(kind, args) of ops/strings.py transform_dict_device, or None
        when the arguments leave nothing to transform (all null)."""
        raise NotImplementedError

    def _transform_value(self, s: str) -> str:
        """The exact per-entry transform (the host loop)."""
        raise NotImplementedError

    def transformed(self, d: np.ndarray, conf, device):
        """(sorted unique output dictionary, int32 code remap on
        `device`) of input dictionary `d`."""
        def make():
            kind = self.device_transform_kind()
            if kind is None or len(d) == 0:
                return np.array([], str), torch.zeros(
                    1, dtype=torch.int32, device=device)
            if len(d) >= conf.get(STRING_TRANSFORM_DEVICE_MIN):
                return S.transform_dict_device(
                    d, kind[0], kind[1], device,
                    byte_tensors=_byte_tensors(self, d, device))
            out = np.array([self._transform_value(s) for s in d.tolist()],
                           str)
            uniq, inverse = np.unique(out, return_inverse=True)
            return uniq.astype(str), torch.from_numpy(
                inverse.astype(np.int32).reshape(-1)).to(device)
        return _per_dictionary(self, "_transforms").get(d, make)

    def _prepare(self, pctx, kids):
        d = _dict_or_empty(kids[self._code_child_index()].dictionary)
        return HostVal(self.transformed(d, pctx.conf, pctx.device)[0])

    def _eval_dev(self, ctx, kids):
        ci = self._code_child_index()
        k = kids[ci]
        out, remap = self.transformed(_dict_or_empty(k.dictionary),
                                      ctx.conf, ctx.device)
        codes = remap[torch.clamp(k.data, 0, remap.shape[0] - 1).long()]
        valid = merge_validity(*(v.validity for v in kids))
        return DevVal(codes, valid, t.STRING, out)


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
        kids = (child, pos if isinstance(pos, Expression) else Literal(pos))
        if length is not None:
            kids += (length if isinstance(length, Expression)
                     else Literal(length),)
        self.children = kids

    def _pos_len(self):
        args = self._args()
        return args[1], (args[2] if len(args) > 2 else None)

    def _transform_value(self, s):
        pos, length = self._pos_len()
        return _spark_substring(s, int(pos), None if length is None
                                else int(length))

    def device_transform_kind(self):
        pos, length = self._pos_len()
        if pos is None:
            return None
        return ("substr", (int(pos), None if length is None
                           else int(length)))

    def _fp_extra(self):
        return repr(self._pos_len())
