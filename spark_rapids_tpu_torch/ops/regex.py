"""Java-regex -> byte-DFA transpiler and the automaton's runner.

Counterpart of spark_rapids_tpu/ops/regex.py.  The transpiler is the
reference's, copied as it is (`_Parser`, `_NFA`, `compile_dfa`, `Dfa`
and the limits): a Java-regex subset (literals, escapes, classes, '.',
top-level anchors, groups, alternation, greedy quantifiers) parses to
an AST, Thompson-constructs an NFA over the byte alphabet (non-ASCII
literals expand to their UTF-8 bytes; '.' and negated classes accept
well-formed multi-byte sequences), and subset-constructs a DFA under a
state cap; anything outside the subset (backreferences, lookaround,
lazy or possessive quantifiers, interior anchors, word boundaries, a
state blowup) raises RegexUnsupported, which the caller turns into the
host dictionary form, as the reference's transpile-or-reject contract
does.  Search (RLIKE) semantics come from the automaton's shape: an
unanchored head loops on the start state, an unanchored tail makes the
accepting states absorb.

The runner is PyTorch and computes the reference's function another
way.  The reference composes per-byte state maps with a segmented
associative scan over an (n_bytes, S) array, O(n_bytes * S * log n)
work that holds several such arrays at once.  Here the dictionary's
entries are ordered by UTF-8 length, longest first, once on the host
(`entry_order`): at step j the entries still running are a prefix of
that order, and each steps its state by one lookup of the transition
table, `state = table_t[byte, state]`.  That is max_len steps and
n_bytes lookups in all, on any device; the loop count comes from the
host dictionary, so a captured graph reads no device value.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

MAX_NFA_STATES = 256
MAX_DFA_STATES = 96
MAX_REPEAT = 64


class RegexUnsupported(Exception):
    """Pattern uses a construct outside the DFA-compilable subset."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class _Node:
    pass


class _Bytes(_Node):              # literal byte sequence (one char)
    def __init__(self, bs: bytes):
        self.bs = bs


class _Class(_Node):              # set of single BYTES (ASCII subset)
    def __init__(self, bytes_set: FrozenSet[int], with_multibyte: bool):
        self.bytes_set = bytes_set
        self.with_multibyte = with_multibyte   # also match any non-ASCII char


class _Concat(_Node):
    def __init__(self, parts: List[_Node]):
        self.parts = parts


class _Alt(_Node):
    def __init__(self, opts: List[_Node]):
        self.opts = opts


class _Repeat(_Node):
    def __init__(self, node: _Node, lo: int, hi: Optional[int]):
        self.node = node
        self.lo = lo
        self.hi = hi             # None = unbounded


_ASCII = frozenset(range(0x00, 0x80))
_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(ord(c) for c in
                  "abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(b" \t\n\x0b\f\r")


class _Parser:
    """Recursive-descent Java-regex parser for the DFA subset."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> Tuple[_Node, bool, bool]:
        """Returns (ast, start_anchored, end_anchored)."""
        start = False
        if self.peek() == "^":
            self.take()
            start = True
        node = self._alternation(top=True)
        end = getattr(self, "_end_anchor", False)
        if self.i < len(self.p):
            raise RegexUnsupported(f"unbalanced pattern at {self.i}")
        return node, start, end

    def _alternation(self, top=False) -> _Node:
        opts = [self._concat(top)]
        while self.peek() == "|":
            self.take()
            opts.append(self._concat(top))
        if len(opts) > 1 and top and getattr(self, "_end_anchor", False):
            # '$' consumed inside one branch of a top-level alternation
            raise RegexUnsupported(
                "'$' inside an alternation branch (interior anchor)")
        return opts[0] if len(opts) == 1 else _Alt(opts)

    def _concat(self, top=False) -> _Node:
        parts: List[_Node] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            if c == "$":
                self.take()
                if top and self.peek() is None:
                    self._end_anchor = True
                    break
                raise RegexUnsupported("interior '$' anchor")
            if c == "^":
                raise RegexUnsupported("interior '^' anchor")
            atom = self._atom()
            atom = self._quantified(atom)
            parts.append(atom)
        return _Concat(parts)

    def _quantified(self, atom: _Node) -> _Node:
        c = self.peek()
        if c not in ("*", "+", "?", "{"):
            return atom
        if c == "{":
            save = self.i
            self.take()
            lo, hi = self._brace()
            if lo is None:                   # not a quantifier: literal '{'
                self.i = save
                return atom
        else:
            self.take()
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
        nxt = self.peek()
        if nxt == "?":
            raise RegexUnsupported("lazy quantifier (no leftmost spans "
                                   "in a DFA)")
        if nxt == "+":
            raise RegexUnsupported("possessive quantifier")
        return _Repeat(atom, lo, hi)

    def _brace(self):
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.take()
        if not digits:
            return None, None
        lo = int(digits)
        hi = lo
        if self.peek() == ",":
            self.take()
            d2 = ""
            while self.peek() is not None and self.peek().isdigit():
                d2 += self.take()
            hi = int(d2) if d2 else None
        if self.peek() != "}":
            return None, None
        self.take()
        if hi is not None and (hi < lo or hi > MAX_REPEAT) or lo > MAX_REPEAT:
            raise RegexUnsupported(f"repeat bound beyond {MAX_REPEAT}")
        return lo, hi

    def _atom(self) -> _Node:
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                n = self.peek()
                if n == ":":
                    self.take()
                else:
                    raise RegexUnsupported(
                        "lookaround / named group / inline flags")
            inner = self._alternation()
            if self.peek() != ")":
                raise RegexUnsupported("unbalanced group")
            self.take()
            return inner           # capturing == non-capturing for matching
        if c == "[":
            return self._char_class()
        if c == ".":
            # Java default: any char except line terminators
            return _Class(_ASCII - {0x0A, 0x0D}, with_multibyte=True)
        if c == "\\":
            return self._escape()
        if c in "*+?":
            raise RegexUnsupported(f"dangling quantifier '{c}'")
        return _Bytes(c.encode("utf-8"))

    def _escape(self) -> _Node:
        if self.peek() is None:
            raise RegexUnsupported("trailing backslash")
        c = self.take()
        simple = {"n": b"\n", "t": b"\t", "r": b"\r", "f": b"\f",
                  "a": b"\x07", "e": b"\x1b", "0": b"\x00"}
        if c in simple:
            return _Bytes(simple[c])
        if c == "d":
            return _Class(_DIGITS, False)
        if c == "D":
            return _Class(_ASCII - _DIGITS, True)
        if c == "w":
            return _Class(_WORD, False)
        if c == "W":
            return _Class(_ASCII - _WORD, True)
        if c == "s":
            return _Class(_SPACE, False)
        if c == "S":
            return _Class(_ASCII - _SPACE, True)
        if c == "x":
            h = ""
            for _ in range(2):
                if self.peek() is None:
                    raise RegexUnsupported("bad \\x escape")
                h += self.take()
            return _Bytes(bytes([int(h, 16)]))
        if c in "123456789":
            raise RegexUnsupported("backreference")
        if c in ("b", "B"):
            raise RegexUnsupported("word boundary")
        if c in ("A",):
            raise RegexUnsupported("\\A anchor (use leading ^)")
        if c in ("z", "Z", "G"):
            raise RegexUnsupported(f"\\{c} anchor")
        if c in ("p", "P", "u", "N", "k", "Q"):
            raise RegexUnsupported(f"\\{c} construct")
        # escaped metacharacter or punctuation: literal
        return _Bytes(c.encode("utf-8"))

    def _char_class(self) -> _Node:
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        items: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexUnsupported("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            c = self.take()
            if c == "[" and self.peek() == ":":
                raise RegexUnsupported("POSIX class")
            if c == "\\":
                e = self.take()
                cls = {"d": _DIGITS, "w": _WORD, "s": _SPACE}.get(e)
                if cls is not None:
                    items |= cls
                    continue
                if e in ("D", "W", "S"):
                    raise RegexUnsupported(
                        "negated predefined class inside a class")
                simple = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C}
                lo_b = simple.get(e, ord(e) if ord(e) < 128 else None)
                if lo_b is None:
                    raise RegexUnsupported("non-ASCII escape in class")
            else:
                if ord(c) > 127:
                    raise RegexUnsupported("non-ASCII char in class")
                lo_b = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hi_c = self.take()
                if hi_c == "\\":
                    hi_c = self.take()
                if ord(hi_c) > 127:
                    raise RegexUnsupported("non-ASCII range in class")
                items |= set(range(lo_b, ord(hi_c) + 1))
            else:
                items.add(lo_b)
        if negated:
            return _Class(_ASCII - items, with_multibyte=True)
        return _Class(frozenset(items), with_multibyte=False)


# ---------------------------------------------------------------------------
# NFA (Thompson) over the byte alphabet
# ---------------------------------------------------------------------------

_MB_LEAD2 = frozenset(range(0xC2, 0xE0))
_MB_LEAD3 = frozenset(range(0xE0, 0xF0))
_MB_LEAD4 = frozenset(range(0xF0, 0xF5))
_MB_CONT = frozenset(range(0x80, 0xC0))


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[FrozenSet[int], int]]] = []

    def new_state(self) -> int:
        if len(self.eps) >= MAX_NFA_STATES:
            raise RegexUnsupported("pattern too large (NFA cap)")
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_eps(self, a, b):
        self.eps[a].append(b)

    def add(self, a, byteset: FrozenSet[int], b):
        self.trans[a].append((byteset, b))

    def _multibyte(self, a, b):
        """Accept one well-formed non-ASCII UTF-8 char from a to b."""
        m2 = self.new_state()
        self.add(a, _MB_LEAD2, m2)
        self.add(m2, _MB_CONT, b)
        m3a, m3b = self.new_state(), self.new_state()
        self.add(a, _MB_LEAD3, m3a)
        self.add(m3a, _MB_CONT, m3b)
        self.add(m3b, _MB_CONT, b)
        m4a, m4b, m4c = (self.new_state(), self.new_state(),
                         self.new_state())
        self.add(a, _MB_LEAD4, m4a)
        self.add(m4a, _MB_CONT, m4b)
        self.add(m4b, _MB_CONT, m4c)
        self.add(m4c, _MB_CONT, b)

    def build(self, node: _Node, a: int, b: int):
        """Wire `node` to accept between states a..b."""
        if isinstance(node, _Bytes):
            cur = a
            for i, byte in enumerate(node.bs):
                nxt = b if i == len(node.bs) - 1 else self.new_state()
                self.add(cur, frozenset([byte]), nxt)
                cur = nxt
        elif isinstance(node, _Class):
            if node.bytes_set:
                self.add(a, node.bytes_set, b)
            if node.with_multibyte:
                self._multibyte(a, b)
        elif isinstance(node, _Concat):
            cur = a
            for i, part in enumerate(node.parts):
                nxt = b if i == len(node.parts) - 1 else self.new_state()
                self.build(part, cur, nxt)
                cur = nxt
            if not node.parts:
                self.add_eps(a, b)
        elif isinstance(node, _Alt):
            for opt in node.opts:
                s, e = self.new_state(), self.new_state()
                self.add_eps(a, s)
                self.build(opt, s, e)
                self.add_eps(e, b)
        elif isinstance(node, _Repeat):
            lo, hi = node.lo, node.hi
            cur = a
            for _ in range(lo):
                nxt = self.new_state()
                self.build(node.node, cur, nxt)
                cur = nxt
            if hi is None:
                # loop: cur -> cur, then out
                s, e = self.new_state(), self.new_state()
                self.add_eps(cur, s)
                self.build(node.node, s, e)
                self.add_eps(e, s)
                self.add_eps(cur, b)
                self.add_eps(e, b)
            else:
                self.add_eps(cur, b)
                for _ in range(hi - lo):
                    nxt = self.new_state()
                    self.build(node.node, cur, nxt)
                    self.add_eps(nxt, b)
                    cur = nxt
        else:
            raise RegexUnsupported(f"unknown node {node!r}")


# ---------------------------------------------------------------------------
# DFA via subset construction
# ---------------------------------------------------------------------------

class Dfa:
    """table: (S, 256) int16 next-state; accepting: (S,) bool; start: 0."""

    def __init__(self, table: np.ndarray, accepting: np.ndarray):
        self.table = table
        self.accepting = accepting

    @property
    def num_states(self):
        return self.table.shape[0]


def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for n in nfa.eps[s]:
            if n not in seen:
                seen.add(n)
                stack.append(n)
    return frozenset(seen)


def compile_dfa(pattern: str, search: bool = True,
                max_states: int = MAX_DFA_STATES) -> Dfa:
    """Compile a Java regex to a byte DFA.

    search=True gives RLIKE find-anywhere semantics via automaton shape:
    unanchored head = start loops on every byte; unanchored tail =
    accepting states absorb.  Raises RegexUnsupported outside the subset.
    """
    ast, anchored_start, anchored_end = _Parser(pattern).parse()
    nfa = _NFA()
    start = nfa.new_state()
    accept = nfa.new_state()
    nfa.build(ast, start, accept)

    all_bytes = frozenset(range(256))
    if search and not anchored_start:
        nfa.add(start, all_bytes, start)
    if search and not anchored_end:
        nfa.add(accept, all_bytes, accept)

    d0 = _eps_closure(nfa, frozenset([start]))
    states: Dict[FrozenSet[int], int] = {d0: 0}
    order = [d0]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.zeros(256, np.int16)
        # group target sets per byte
        for b in range(256):
            tgt = set()
            for s in cur:
                for byteset, to in nfa.trans[s]:
                    if b in byteset:
                        tgt.add(to)
            if tgt:
                closed = _eps_closure(nfa, frozenset(tgt))
            else:
                closed = frozenset()
            idx = states.get(closed)
            if idx is None:
                if len(states) >= max_states:
                    raise RegexUnsupported("DFA state blowup")
                idx = len(states)
                states[closed] = idx
                order.append(closed)
            row[b] = idx
        rows.append(row)
        i += 1
    table = np.stack(rows)
    accepting = np.array([accept in st for st in order], bool)
    return Dfa(table, accepting)



# ---------------------------------------------------------------------------
# Runner: the entries by length, one table lookup a byte
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EntryOrder:
    """The runner's host plan over one dictionary: `order` the entries
    by UTF-8 length, longest first (a stable order), `starts` each
    ordered entry's first byte, both on the device, and `live[j]` the
    number of entries longer than j bytes (the prefix of `order` that
    step j advances)."""
    n: int
    order: torch.Tensor
    starts: torch.Tensor
    live: List[int]


#: id(dictionary) -> (a weak reference to it, its entries' lengths): a
#: dictionary's lengths are computed once, whichever query reads it
_LENGTHS: Dict[int, tuple] = {}


def utf8_lengths(dictionary: np.ndarray) -> np.ndarray:
    """Each entry's UTF-8 byte length, from its code points (numpy),
    computed once per dictionary object."""
    hit = _LENGTHS.get(id(dictionary))
    if hit is not None and hit[0]() is dictionary:
        return hit[1]
    out = _utf8_lengths(dictionary)
    for k in [k for k, (ref, _l) in _LENGTHS.items() if ref() is None]:
        del _LENGTHS[k]
    _LENGTHS[id(dictionary)] = (weakref.ref(dictionary), out)
    return out


def _utf8_lengths(dictionary: np.ndarray) -> np.ndarray:
    n = len(dictionary)
    if n == 0:
        return np.zeros(0, np.int64)
    nchars = np.char.str_len(dictionary).astype(np.int64)
    cps = np.ascontiguousarray(dictionary).view(np.uint32).reshape(n, -1)
    if not cps.size or int(cps.max()) < 0x80:
        return nchars
    out = np.empty(n, np.int64)
    pos = np.arange(cps.shape[1])
    for lo in range(0, n, 1 << 16):
        c = cps[lo:lo + (1 << 16)]
        width = 1 + (c >= 0x80).astype(np.int64) + (c >= 0x800) + \
            (c >= 0x10000)
        out[lo:lo + len(c)] = (width * (pos[None, :] <
                                        nchars[lo:lo + len(c), None])
                               ).sum(axis=1)
    return out


def entry_order(lengths: np.ndarray, device) -> EntryOrder:
    """The runner's plan from the entries' byte lengths (host data)."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    order = np.argsort(-lengths, kind="stable")
    max_len = int(lengths.max()) if n else 0
    longer = n - np.cumsum(np.bincount(lengths, minlength=max_len + 1))
    from ..runtime.capture import host_constant
    device = torch.device(device)
    return EntryOrder(n, host_constant(order, device),
                      host_constant(offsets[:-1][order], device),
                      [int(k) for k in longer[:max_len]])


def dfa_matches_lanes(table_t: torch.Tensor, accepting: torch.Tensor,
                      offsets: torch.Tensor, bytes_: torch.Tensor,
                      order: Optional[EntryOrder] = None) -> torch.Tensor:
    """Run the DFA over every dictionary entry at once (the reference's
    `dfa_matches_lanes`, same arguments and result).

    table_t: (256, S) int16 transposed transition table; accepting: (S,)
    bool; offsets: (n_entries + 1,) int32; bytes_: (n_bytes,) uint8, all
    on one device; `order` the plan of `entry_order` (built here from the
    offsets, one host read, when not given).  Returns (n_entries,) bool:
    the entry matches.  An empty entry ends in state 0, as in the
    reference."""
    if order is None:
        off = offsets.cpu().numpy().astype(np.int64)
        order = entry_order(np.diff(off), bytes_.device)
    device = bytes_.device
    out = torch.zeros(order.n, dtype=torch.bool, device=device)
    if order.n == 0:
        return out
    S = table_t.shape[1]
    flat = table_t.reshape(-1)
    state = torch.zeros(order.n, dtype=torch.int64, device=device)
    for j, k in enumerate(order.live):
        byte = bytes_[order.starts[:k] + j].to(torch.int64)
        state[:k] = flat[byte * S + state[:k]].to(torch.int64)
    out[order.order] = accepting[state]
    return out


def dfa_matches(dfa: Dfa, offsets: torch.Tensor, bytes_: torch.Tensor
                ) -> torch.Tensor:
    """`dfa_matches_lanes` with the DFA's tables put on the bytes'
    device."""
    dev = bytes_.device
    return dfa_matches_lanes(
        torch.from_numpy(dfa.table.T.astype(np.int16).copy()).to(dev),
        torch.from_numpy(dfa.accepting.copy()).to(dev), offsets, bytes_)
