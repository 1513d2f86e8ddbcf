"""Encoded execution: computing on encoded lanes (`sql.encoded.*`).

Counterpart of spark_rapids_tpu/ops/encodings.py.  Strings already live
on the device as codes into sorted, duplicate-free host dictionaries
(columnar/device.py), so the reference's `dict.sortOnScan` is what the
port always does.  This module is the rest of the layer:

  * **Code-space dictionary predicates.**  A literal comparison over a
    dictionary column translates the literal through the dictionary
    once on the host: equality and small IN-lists become code
    comparisons, ranges one scalar bound over an ordered dictionary; an
    unordered dictionary, or `dict.predicates=OFF`, takes the decode
    rung (a per-entry table gathered by code).
  * **FOR-narrowed integer lanes.**  An integer-family, DATE or narrow
    DECIMAL scan lane whose batch's live values fit a smaller signed
    dtype uploads at that dtype (`narrow_np_dtype`: value-preserving,
    no bias).  A comparison runs on the narrow lane with range guards
    (`narrow_compare`), arithmetic between two narrow lanes at the
    exact width its result needs (`exact_arith_dtype`); every other
    reader sees the lane widened to its logical storage dtype
    (`DeviceColumn.data`, `expressions.DevVal.data`).
  * **RLE run-domain predicates** (`rle_predicate_mask`).

PyTorch differs from JAX in one way that matters here: a Python scalar
or a 0-d tensor never promotes a narrow lane, and an out-of-range value
wraps silently (int8 `< 300`, int16 `* 100`, `torch.where` with a wide
0-d tensor).  So nothing but the guarded sites above reads a narrow lane
as such.

Every encoded dispatch that can shed fires the `kernel` chaos site
(`elect_encoded`); an injected OOM there takes the decoded tier,
bit-identically.  The counters go to the running query's `ctx.metrics`:
`encoded_dispatch.<site>.<outcome>` and `encoded_decode_bytes.<site>`
(the reference's registry families port with ROADMAP Queue 1 item 10).
With `encoded.execution.enabled=false` no encoded path is consulted.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from ..config import (ENCODED_DICT_PREDICATES, ENCODED_DICT_SORT_SCAN,
                      ENCODED_EXECUTION, ENCODED_IN_MAX_CODES,
                      ENCODED_NARROW_LANES, TpuConf)


@dataclasses.dataclass(frozen=True)
class EncodingPolicy:
    """The resolved encoded-execution decisions of a conf."""
    enabled: bool
    dict_predicates: bool
    dict_sort_scan: bool
    narrow_lanes: bool
    in_max_codes: int

    @property
    def any_enabled(self) -> bool:
        return self.enabled and (self.dict_predicates or
                                 self.dict_sort_scan or self.narrow_lanes)


NO_ENCODING = EncodingPolicy(False, False, False, False, 0)


def encoding_policy(conf: TpuConf) -> EncodingPolicy:
    """The policy of a conf, cached on the conf instance."""
    pol = conf._cache.get("__encoding_policy")
    if pol is not None:
        return pol
    if not conf.get(ENCODED_EXECUTION):
        pol = NO_ENCODING
    else:
        def mode(entry, auto: bool) -> bool:
            v = str(conf.get(entry)).upper()
            return auto if v == "AUTO" else v == "ON"
        pol = EncodingPolicy(
            enabled=True,
            dict_predicates=mode(ENCODED_DICT_PREDICATES, True),
            dict_sort_scan=bool(conf.get(ENCODED_DICT_SORT_SCAN)),
            narrow_lanes=mode(ENCODED_NARROW_LANES, True),
            in_max_codes=int(conf.get(ENCODED_IN_MAX_CODES)))
    conf._cache["__encoding_policy"] = pol
    return pol


def encoding_discriminant(conf: TpuConf) -> Optional[tuple]:
    """The policy as a cache-key part: two confs whose resolved policies
    differ must not share an upload or a compiled program (lane dtypes
    differ).  None when everything is off."""
    p = encoding_policy(conf)
    if not p.any_enabled:
        return None
    return ("enc", p.dict_predicates, p.dict_sort_scan, p.narrow_lanes,
            p.in_max_codes)


# ---------------------------------------------------------------------------
# Dispatch bookkeeping and the `kernel` chaos site
# ---------------------------------------------------------------------------

def _ctx():
    from ..exec.plan import active_context
    return active_context()


def count_dispatch(site: str, outcome: str = "encoded") -> None:
    """One encoded dispatch, as `encoded_dispatch.<site>.<outcome>`."""
    ctx = _ctx()
    if ctx is not None:
        ctx.bump(f"encoded_dispatch.{site}.{outcome}")


def count_decode(site: str, nbytes: int) -> None:
    """One decode pass (a table gathered by code, a full-width widen)."""
    ctx = _ctx()
    if ctx is not None:
        ctx.bump(f"encoded_decode_bytes.{site}", int(nbytes))
        ctx.bump(f"encoded_dispatch.{site}.decode")


def elect_encoded(conf: TpuConf, site: str) -> bool:
    """The last step of an encoded dispatch: fires the `kernel` chaos
    site with `kernel=<site>`.  An injected OOM sheds the dispatch to the
    decoded tier (`oom_shed`), bit-identically; every other kind
    propagates to its own ladder."""
    from ..runtime.faults import get_active_injector, get_injector
    from ..runtime.memory import TpuRetryOOM
    inj = get_injector(conf)
    if not inj.enabled:
        inj = get_active_injector()
    if inj.enabled:
        try:
            inj.fire("kernel", kernel=site, mode="encoded")
        except TpuRetryOOM:
            count_dispatch(site, "oom_shed")
            return False
    count_dispatch(site)
    return True


# ---------------------------------------------------------------------------
# Dictionary helpers (numpy dictionaries, cached per dictionary object)
# ---------------------------------------------------------------------------
# The batches of one scan share their column's dictionary object, so the
# dictionary-sized host work runs once a dictionary.  Entries pin the
# dictionary, so a reused id() cannot alias a stale hit.

_LOCK = threading.RLock()
_ORDERED: dict = {}
_UNIQUE: dict = {}
_LITERAL_CODE: dict = {}
_RANK_BOUNDS: dict = {}
_RANK_TABLE: dict = {}


def clear_dict_caches() -> None:
    with _LOCK:
        for c in (_ORDERED, _UNIQUE, _LITERAL_CODE, _RANK_BOUNDS,
                  _RANK_TABLE):
            c.clear()


def _cached(cache: dict, key, pin, compute):
    with _LOCK:
        hit = cache.get(key)
        if hit is not None and hit[0] is pin:
            return hit[1]
        value = compute()
        if len(cache) > 4096:
            cache.clear()
        cache[key] = (pin, value)
        return value


def is_ordered_dict(d: Optional[np.ndarray]) -> bool:
    """The dictionary strictly increases in Spark's string order (code
    points, numpy's): codes are ranks."""
    if d is None:
        return False
    if len(d) <= 1:
        return True
    return _cached(_ORDERED, id(d), d, lambda: bool(np.all(d[:-1] < d[1:])))


def is_unique_dict(d: Optional[np.ndarray]) -> bool:
    """No entry repeats: code equality is value equality (a computed
    dictionary may repeat values)."""
    if d is None:
        return False
    if len(d) <= 1:
        return True
    return _cached(_UNIQUE, id(d), d,
                   lambda: len(np.unique(np.asarray(d, str))) == len(d))


#: a literal absent from the dictionary: equals no valid code (>= 0) and
#: not the -1 of a string absent from a join build's dictionary
ABSENT_CODE = -2


def literal_code(d: Optional[np.ndarray], value: str) -> int:
    """The code of `value` in the dictionary, or ABSENT_CODE."""
    if d is None or len(d) == 0:
        return ABSENT_CODE

    def compute():
        hits = np.flatnonzero(np.asarray(d, str) == value)
        return int(hits[0]) if len(hits) else ABSENT_CODE
    return _cached(_LITERAL_CODE, (id(d), value), d, compute)


def rank_bounds(d: Optional[np.ndarray], value: str):
    """(#entries < value, #entries <= value) in Spark's string order:
    col < value iff rank(col) < the first, col <= value iff rank(col) <
    the second (over an ordered dictionary, rank is the code)."""
    if d is None or len(d) == 0:
        return 0, 0

    def compute():
        a = np.asarray(d, str)
        return int(np.sum(a < value)), int(np.sum(a <= value))
    return _cached(_RANK_BOUNDS, (id(d), value), d, compute)


def rank_table(d: Optional[np.ndarray]) -> np.ndarray:
    """ranks[code]: the rank of the code's string in the sorted
    dictionary (ops/sort.dictionary_ranks), the decode rung of a range
    predicate over an unordered dictionary."""
    if d is None or len(d) == 0:
        return np.zeros(1, np.int32)
    from .sort import dictionary_ranks
    return _cached(_RANK_TABLE, id(d), d, lambda: dictionary_ranks(d))


def sort_dictionary_encode(values: np.ndarray, valid=None):
    """Dictionary-encode host strings with an order-preserving (sorted,
    duplicate-free) dictionary: -> (int32 codes, nulls as 0; the
    dictionary).  The port's host columns are built this way
    (columnar/host.py), so the scan uploads them as they are."""
    values = np.asarray(values, str)
    if valid is not None:
        values = np.where(valid, values, "")
    d, codes = np.unique(values, return_inverse=True)
    codes = codes.astype(np.int32)
    if valid is not None:
        used = np.unique(codes[valid])
        d2 = d[used]
        remap = np.zeros(len(d), np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        codes = np.where(valid, remap[codes], 0).astype(np.int32)
        d = d2
    return codes, d


# ---------------------------------------------------------------------------
# FOR-narrowed integer lanes (value-preserving, no bias)
# ---------------------------------------------------------------------------

_NARROW_STEPS = {8: (np.int8, np.int16, np.int32),
                 4: (np.int8, np.int16),
                 2: (np.int8,)}

_SIGNED_BY_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}
_SIGNED_SIZE = {v: k for k, v in _SIGNED_BY_SIZE.items()}


def narrow_np_dtype(lo: int, hi: int, base) -> Optional[np.dtype]:
    """The smallest signed dtype narrower than `base` that holds [lo, hi]
    exactly, or None."""
    base = np.dtype(base)
    if base.kind != "i" or base.itemsize not in _NARROW_STEPS:
        return None
    for cand in _NARROW_STEPS[base.itemsize]:
        info = np.iinfo(cand)
        if info.min <= lo and hi <= info.max:
            return np.dtype(cand)
    return None


def narrow_widths(itemsize_a: int, itemsize_b: int, op: str) -> int:
    """Itemsize (bytes) that holds `op` over two signed lanes exactly:
    add and subtract need one more bit (twice the wider side), multiply
    the sum of the widths."""
    need = itemsize_a + itemsize_b if op == "mul" \
        else 2 * max(itemsize_a, itemsize_b)
    w = 1
    while w < need:
        w *= 2
    return w


def exact_arith_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype, op: str,
                      logical_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The torch dtype for exact arithmetic over two narrow lanes, or
    None when that width is not narrower than the logical compute dtype
    (then the operands widen as usual)."""
    sizes = [_SIGNED_SIZE.get(d) for d in (a_dtype, b_dtype, logical_dtype)]
    if None in sizes:
        return None
    w = narrow_widths(sizes[0], sizes[1], op)
    if w >= sizes[2] or w > 8:
        return None
    return _SIGNED_BY_SIZE[w]


def common_narrow_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype
                        ) -> Optional[torch.dtype]:
    """The wider of two signed narrow dtypes (a value-preserving common
    comparison dtype), or None."""
    a, b = _SIGNED_SIZE.get(a_dtype), _SIGNED_SIZE.get(b_dtype)
    if a is None or b is None:
        return None
    return _SIGNED_BY_SIZE[max(a, b)]


def narrow_compare(symbol: str, narrow_lane: torch.Tensor,
                   wide_other: torch.Tensor) -> torch.Tensor:
    """Compare a narrow lane with a full-width lane (a literal's, or any
    wider integer lane) without widening the rows: the wide side clamps
    into the narrow dtype, and range guards give the answer wherever it
    lies outside it.  Exact for every value of the wide side; every
    operand is a tensor of an explicit dtype, so nothing wraps."""
    info = torch.iinfo(narrow_lane.dtype)
    below = wide_other < info.min     # under every lane value
    above = wide_other > info.max     # over every lane value
    dn = torch.clamp(wide_other, info.min, info.max).to(narrow_lane.dtype)
    if symbol == "=":
        core, if_below, if_above = narrow_lane == dn, False, False
    elif symbol == "!=":
        core, if_below, if_above = narrow_lane != dn, True, True
    elif symbol == "<":
        core, if_below, if_above = narrow_lane < dn, False, True
    elif symbol == "<=":
        core, if_below, if_above = narrow_lane <= dn, False, True
    elif symbol == ">":
        core, if_below, if_above = narrow_lane > dn, True, False
    elif symbol == ">=":
        core, if_below, if_above = narrow_lane >= dn, True, False
    else:
        raise ValueError(f"narrow_compare: unknown symbol {symbol!r}")
    out = torch.where(below, torch.full_like(core, if_below), core)
    return torch.where(above, torch.full_like(core, if_above), out)


# ---------------------------------------------------------------------------
# RLE run-domain predicates
# ---------------------------------------------------------------------------

def rle_predicate_mask(values: torch.Tensor, lengths: torch.Tensor, n: int,
                       pred) -> torch.Tensor:
    """Row mask of `pred` over an RLE lane without decoding it: the
    predicate runs once a run, and its verdict expands to the rows by a
    search against the run ends."""
    verdict = pred(values)
    ends = torch.cumsum(lengths.to(torch.int64), 0)
    rows = torch.arange(n, dtype=torch.int64, device=values.device)
    run_of_row = torch.searchsorted(ends, rows, right=True)
    run_of_row = torch.clamp(run_of_row, 0, values.shape[0] - 1)
    in_range = rows < ends[-1]
    return verdict[run_of_row] & in_range
