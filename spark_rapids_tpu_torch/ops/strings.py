"""Byte-level string work over a dictionary's (offsets, bytes) tensors.

Counterpart of spark_rapids_tpu/ops/strings.py for what the TPC-H
queries reach.  Row strings stay dictionary codes (columnar/device.py);
the byte work runs once per dictionary entry on the device and a row's
result is a gather by its code:

  * `dict_byte_tensors`: a numpy `str` dictionary as int32 offsets and
    uint8 UTF-8 bytes, encoded on the device from the array's UCS-4 code
    points (no per-entry Python);
  * `byte_lengths`, `char_lengths`;
  * `match_prefix`, `match_suffix`, `match_contains`, `match_equals`:
    one bool per entry;
  * `LikePlan`, `compile_like` and `like_to_regex`: a LIKE pattern of
    one of the simple shapes (equals, prefix, suffix, contains,
    prefix%suffix) as a composition of the matchers; any other pattern
    compiles to None, and the caller masks the dictionary with the
    pattern's full-match regex on the host;
  * `substr_bytes` and `transform_dict_device`: Spark's 1-based
    `substring(str, pos, len)` by characters (UTF-8 lead bytes) over
    every entry, and upper, lower, trim, ltrim and rtrim over the
    entries' code points (an ASCII rewrite on the device; an entry with
    a character past ASCII is redone on the host by Python's exact
    `str.upper` / `lower` / `strip`, since 'ß'.upper() is 'SS'), each
    decoded into a sorted duplicate-free dictionary plus the int32 remap
    of the input's codes, which stays on the device.

The reference pads its byte tensors to bucket capacities to bound its
jit cache; PyTorch runs eagerly, so the tensors here are exactly the
dictionary's (with one zero byte when it has none, so gathers stay in
range).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..runtime.capture import capturing, host_constant

# leading-byte marks of a 1-, 2-, 3- and 4-byte UTF-8 sequence
_UTF8_LEAD = (0x00, 0xC0, 0xE0, 0xF0)
# payload bits a leading byte keeps, by sequence length
_UTF8_LEAD_BITS = (0x7F, 0x1F, 0x0F, 0x07)


def code_points(dictionary: np.ndarray, device) -> torch.Tensor:
    """int32 [n, width] UCS-4 code points of a numpy `str` array on
    `device`, zero-padded past each entry (numpy's own padding)."""
    d = np.ascontiguousarray(np.asarray(dictionary, str))
    if d.dtype.itemsize == 0:
        d = d.astype("<U1")
    width = d.dtype.itemsize // 4
    cps = d.view(np.int32).reshape(len(d), width)
    return host_constant(cps, torch.device(device))


def _char_counts(cps: torch.Tensor) -> torch.Tensor:
    """Characters per entry: one past its last non-zero code point (numpy
    strips trailing NULs, so a zero inside an entry is a character)."""
    pos = torch.arange(1, cps.shape[1] + 1, dtype=torch.int32,
                       device=cps.device)
    return torch.where(cps != 0, pos, torch.zeros_like(pos)).amax(dim=1)


def _dict_bytes_host(dictionary: np.ndarray, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dict_byte_tensors encoded on the host: the same offsets and bytes
    (a lone surrogate as its 3-byte form, as the device encodes it)."""
    enc = [str(s).encode("utf-8", "surrogatepass")
           for s in np.asarray(dictionary, str)]
    offsets = np.zeros(len(enc) + 1, np.int32)
    offsets[1:] = np.cumsum([len(b) for b in enc])
    data = np.frombuffer(b"".join(enc) or b"\0", np.uint8)
    return host_constant(offsets, device), host_constant(data, device)


def dict_byte_tensors(dictionary: Optional[np.ndarray], device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets int32[n + 1], bytes uint8[max(total, 1)]) of a string
    dictionary on `device`: entry i's UTF-8 bytes are bytes[offsets[i]:
    offsets[i + 1]].  Encoded on the device from the code points."""
    if dictionary is None or len(dictionary) == 0:
        return (torch.zeros(1, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.uint8, device=device))
    if capturing():
        # the encoded length is a host decision: a graph takes the bytes
        # as a constant, encoded here on the host
        return _dict_bytes_host(dictionary, torch.device(device))
    cps = code_points(dictionary, device)
    n, width = cps.shape
    nchars = _char_counts(cps)
    in_entry = torch.arange(width, device=device)[None, :] < \
        nchars[:, None].long()
    # UTF-8 length of each code point: 1 to 4 bytes, 0 past the entry
    nbytes = (1 + (cps >= 0x80).to(torch.int32) +
              (cps >= 0x800).to(torch.int32) +
              (cps >= 0x10000).to(torch.int32)) * in_entry
    lens = nbytes.sum(dim=1, dtype=torch.int64)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lens, 0)
    if bool((cps < 0x80).all()):
        data = cps[in_entry].to(torch.uint8)
    else:
        # byte j of a code point of L bytes: its bits from 6 * (L - 1 - j)
        j = torch.arange(4, dtype=torch.int32, device=device)
        L = nbytes[..., None]
        shift = torch.clamp(6 * (L - 1 - j), min=0)
        bits = torch.bitwise_right_shift(cps[..., None], shift)
        lead = host_constant(_UTF8_LEAD, torch.device(device),
                             torch.int32)[torch.clamp(L - 1, min=0)]
        byte = torch.where(j == 0, lead | bits, 0x80 | (bits & 0x3F))
        data = byte[j < L].to(torch.uint8)
    if data.numel() == 0:
        data = torch.zeros(1, dtype=torch.uint8, device=device)
    return offsets.to(torch.int32), data


def byte_lengths(offsets: torch.Tensor) -> torch.Tensor:
    return offsets[1:] - offsets[:-1]


def _lead_csum(offsets: torch.Tensor, bytes_: torch.Tensor) -> torch.Tensor:
    """Exclusive count of UTF-8 lead bytes (characters) before each byte
    position, one entry longer than the live bytes."""
    live = int(offsets[-1])
    lead = ((bytes_[:live] & 0xC0) != 0x80).to(torch.int32)
    csum = torch.zeros(live + 1, dtype=torch.int32, device=bytes_.device)
    csum[1:] = torch.cumsum(lead, 0, dtype=torch.int32)
    return csum


def char_lengths(offsets: torch.Tensor, bytes_: torch.Tensor
                 ) -> torch.Tensor:
    """Unicode characters per entry (Spark length()): a character starts
    at every byte that is not a continuation byte (0b10xxxxxx)."""
    csum = _lead_csum(offsets, bytes_)
    return csum[offsets[1:].long()] - csum[offsets[:-1].long()]


def match_prefix(offsets: torch.Tensor, bytes_: torch.Tensor,
                 pat: bytes) -> torch.Tensor:
    """bool[n]: the entry starts with `pat` (byte-wise; exact for UTF-8)."""
    lo, hi = offsets[:-1].long(), offsets[1:].long()
    ok = (hi - lo) >= len(pat)
    cap = bytes_.shape[0]
    for k, b in enumerate(pat):
        ok = ok & (bytes_[torch.clamp(lo + k, 0, cap - 1)] == b)
    return ok


def match_suffix(offsets: torch.Tensor, bytes_: torch.Tensor,
                 pat: bytes) -> torch.Tensor:
    lo, hi = offsets[:-1].long(), offsets[1:].long()
    p = len(pat)
    ok = (hi - lo) >= p
    cap = bytes_.shape[0]
    for k, b in enumerate(pat):
        ok = ok & (bytes_[torch.clamp(hi - p + k, 0, cap - 1)] == b)
    return ok


def match_contains(offsets: torch.Tensor, bytes_: torch.Tensor,
                   pat: bytes) -> torch.Tensor:
    """bool[n]: `pat` occurs in the entry.  window[j] says the bytes from
    j match `pat`; an entry's starts are [lo, hi - p], so no window that
    runs into the next entry is counted, and a per-entry any() is a
    difference of the windows' prefix sums."""
    lo, hi = offsets[:-1].long(), offsets[1:].long()
    p = len(pat)
    if p == 0:
        return torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    starts = bytes_.shape[0] - p + 1
    if starts <= 0:
        return torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    window = torch.ones(starts, dtype=torch.bool, device=bytes_.device)
    for k, b in enumerate(pat):
        window = window & (bytes_[k:k + starts] == b)
    wsum = torch.zeros(starts + 1, dtype=torch.int32, device=bytes_.device)
    wsum[1:] = torch.cumsum(window.to(torch.int32), 0, dtype=torch.int32)
    start_lo = torch.clamp(lo, 0, starts)
    start_hi = torch.maximum(torch.clamp(hi - p + 1, 0, starts), start_lo)
    return (wsum[start_hi] - wsum[start_lo]) > 0


def match_equals(offsets: torch.Tensor, bytes_: torch.Tensor,
                 pat: bytes) -> torch.Tensor:
    lo, hi = offsets[:-1].long(), offsets[1:].long()
    return match_prefix(offsets, bytes_, pat) & ((hi - lo) == len(pat))


# ---------------------------------------------------------------------------
# LIKE: the simple shapes as matcher compositions, the rest as a regex
# ---------------------------------------------------------------------------

class LikePlan:
    """A LIKE pattern of a simple shape: `kind` is equals, prefix,
    suffix, contains or prefix_suffix, `parts` its UTF-8 literals."""

    def __init__(self, kind: str, parts: List[bytes]):
        self.kind = kind
        self.parts = parts

    def eval_device(self, offsets: torch.Tensor, bytes_: torch.Tensor
                    ) -> torch.Tensor:
        """bool per dictionary entry: the entry matches the pattern."""
        if self.kind == "equals":
            return match_equals(offsets, bytes_, self.parts[0])
        if self.kind == "prefix":
            return match_prefix(offsets, bytes_, self.parts[0])
        if self.kind == "suffix":
            return match_suffix(offsets, bytes_, self.parts[0])
        if self.kind == "contains":
            return match_contains(offsets, bytes_, self.parts[0])
        if self.kind == "prefix_suffix":
            pre, suf = self.parts
            lens = byte_lengths(offsets)
            return (match_prefix(offsets, bytes_, pre) &
                    match_suffix(offsets, bytes_, suf) &
                    (lens >= len(pre) + len(suf)))
        raise AssertionError(self.kind)


#: the wildcard tokens of a LIKE pattern, apart from any literal chunk
#: (a literal "%" is an escaped character, not a wildcard)
_ANY, _ONE = object(), object()


def compile_like(pattern: str, escape: str = "\\") -> Optional[LikePlan]:
    """The matcher composition of a simple LIKE shape, or None for any
    other pattern (an `_` anywhere, or literals between two `%` runs
    that are not the prefix%suffix shape)."""
    literal: List[str] = []
    tokens: list = []              # literal chunks, _ANY and _ONE
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            literal.append(pattern[i + 1])
            i += 2
            continue
        if c in ("%", "_"):
            if literal:
                tokens.append("".join(literal))
                literal = []
            tokens.append(_ANY if c == "%" else _ONE)
            i += 1
            continue
        literal.append(c)
        i += 1
    if literal:
        tokens.append("".join(literal))
    if any(tk is _ONE for tk in tokens):
        return None
    # a run of % is one %
    coll: list = []
    for tk in tokens:
        if not (tk is _ANY and coll and coll[-1] is _ANY):
            coll.append(tk)
    lits = [tk.encode("utf-8") for tk in coll if tk is not _ANY]
    if not coll:
        return LikePlan("equals", [b""])
    if not lits:
        return LikePlan("contains", [b""])
    if len(lits) == 1:
        starts, ends = coll[0] is _ANY, coll[-1] is _ANY
        kind = {(False, False): "equals", (False, True): "prefix",
                (True, False): "suffix", (True, True): "contains"}[
                    (starts, ends)]
        return LikePlan(kind, lits)
    if len(lits) == 2 and len(coll) == 3:
        return LikePlan("prefix_suffix", lits)
    return None


def like_to_regex(pattern: str, escape: str = "\\") -> str:
    """The full-match regex of a LIKE pattern: `%` is `.*`, `_` is `.`,
    an escaped character and every other one stand for themselves."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Substring over every dictionary entry
# ---------------------------------------------------------------------------

def substr_bounds(nchars: torch.Tensor, pos: int, length: Optional[int]):
    """Per entry [start, end) in characters of Spark's substring(str, pos,
    len): 1-based pos, pos 0 as 1, a negative pos from the end (clamped
    to the start), len <= 0 empty, len None to the end."""
    if pos > 0:
        start = torch.clamp(nchars, max=pos - 1)
    elif pos == 0:
        start = torch.zeros_like(nchars)
    else:
        start = torch.clamp(nchars + pos, min=0)
    if length is None:
        end = nchars
    elif length <= 0:
        end = start
    else:
        end = torch.minimum(start + length, nchars)
    return start, torch.maximum(end, start)


def substr_bytes(offsets: torch.Tensor, bytes_: torch.Tensor, pos: int,
                 length: Optional[int]):
    """(offsets, bytes) of every entry's substring, packed densely."""
    n = offsets.shape[0] - 1
    dev = bytes_.device
    total_bytes = int(offsets[-1])
    csum = _lead_csum(offsets, bytes_)
    lo_b, hi_b = offsets[:-1].long(), offsets[1:].long()
    chars_before = csum[lo_b]
    start, end = substr_bounds(csum[hi_b] - chars_before, pos, length)
    # byte position of each character by its global rank, and the end of
    # the bytes for a rank past the last character
    lead = (bytes_[:total_bytes] & 0xC0) != 0x80
    char_pos = torch.cat([torch.nonzero(lead).flatten(), torch.tensor(
        [total_bytes], dtype=torch.int64, device=dev)])
    last = char_pos.shape[0] - 1

    def char_byte(rank):
        return char_pos[torch.clamp(rank.long(), 0, last)]
    # a rank at an entry's end lands on the next entry's first byte (or
    # past empty entries): clamp into the entry
    lo = torch.minimum(char_byte(chars_before + start), hi_b)
    hi = torch.minimum(char_byte(chars_before + end), hi_b)
    return pack_ranges(bytes_, lo, hi, n)


def pack_ranges(bytes_: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                n: int):
    """Pack per-entry byte ranges [lo, hi) into dense (offsets, bytes)."""
    dev = bytes_.device
    lens = torch.clamp(hi - lo, min=0)
    out_offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    out_offs[1:] = torch.cumsum(lens, 0)
    total = int(out_offs[-1])
    ent = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                  output_size=total)
    src = lo[ent] + (torch.arange(total, device=dev) - out_offs[ent])
    return out_offs.to(torch.int32), bytes_[src]


def decode_code_points(offsets: torch.Tensor, bytes_: torch.Tensor
                       ) -> torch.Tensor:
    """int32 [n, width] code points of (offsets, UTF-8 bytes), zero-padded:
    the inverse of `dict_byte_tensors` for well-formed UTF-8."""
    n = offsets.shape[0] - 1
    dev = bytes_.device
    csum = _lead_csum(offsets, bytes_)
    total = csum.shape[0] - 1
    b = bytes_[:total].to(torch.int32)
    nb = torch.where(b < 0x80, 1, torch.where(
        b < 0xE0, 2, torch.where(b < 0xF0, 3, 4)))
    payload = host_constant(_UTF8_LEAD_BITS, dev, torch.int32)
    cp = b & payload[nb - 1]
    at = torch.arange(total, device=dev)
    for j in range(1, 4):
        follow = b[torch.clamp(at + j, max=max(total - 1, 0))]
        cp = torch.where(nb > j, (cp << 6) | (follow & 0x3F), cp)
    lo, hi = offsets[:-1].long(), offsets[1:].long()
    first = csum[lo]
    width = int((csum[hi] - first).max()) if n else 0
    out = torch.zeros((n, max(width, 1)), dtype=torch.int32, device=dev)
    lead_at = torch.nonzero((b & 0xC0) != 0x80).flatten()
    ent = torch.repeat_interleave(torch.arange(n, device=dev), hi - lo,
                                  output_size=total)[lead_at]
    out[ent, (csum[lead_at] - first[ent]).long()] = cp[lead_at]
    return out


def as_str_array(cps: torch.Tensor) -> np.ndarray:
    """A numpy `str` array from int32 [n, width] code points."""
    host = np.ascontiguousarray(cps.cpu().numpy().astype(np.int32))
    return host.view(f"<U{host.shape[1]}").reshape(host.shape[0])


def unique_remap(cps: torch.Tensor) -> Tuple[np.ndarray, torch.Tensor]:
    """(sorted duplicate-free dictionary, int32 remap on the device) of
    [n, width] code points.  Rows compare as numpy compares strings: by
    code point, a shorter string (zero padding) first."""
    uniq, inverse = torch.unique(cps, dim=0, return_inverse=True)
    return as_str_array(uniq), inverse.to(torch.int32)


#: the ASCII characters Python's str.isspace() holds: str.strip() with no
#: argument removes exactly these from an ASCII entry
_ASCII_SPACE = (9, 10, 11, 12, 13, 28, 29, 30, 31, 32)
#: the exact per-entry transform that redoes an entry past ASCII
_HOST_EXACT = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
               "ltrim": str.lstrip, "rtrim": str.rstrip}


def _case_cps(cps: torch.Tensor, upper: bool) -> torch.Tensor:
    lo, hi, shift = (97, 122, -32) if upper else (65, 90, 32)
    return torch.where((cps >= lo) & (cps <= hi), cps + shift, cps)


def _trim_cps(cps: torch.Tensor, left: bool, right: bool) -> torch.Tensor:
    """Each row's characters without its leading (`left`) and trailing
    (`right`) ASCII white space, moved to the row's start."""
    n, width = cps.shape
    pos = torch.arange(width, device=cps.device)
    nchars = _char_counts(cps).long()
    space = torch.isin(cps, host_constant(_ASCII_SPACE, cps.device,
                                          cps.dtype))
    keep = (pos[None, :] < nchars[:, None]) & ~space
    start = torch.minimum(torch.where(keep, pos, width).amin(dim=1), nchars) \
        if left else torch.zeros_like(nchars)
    end = torch.where(keep, pos + 1, 0).amax(dim=1) if right else nchars
    length = torch.clamp(end - start, min=0)
    src = torch.clamp(start[:, None] + pos[None, :], max=width - 1)
    out = torch.gather(cps, 1, src)
    return torch.where(pos[None, :] < length[:, None], out,
                       torch.zeros_like(out))


def _redo_on_host(out: torch.Tensor, dictionary: np.ndarray,
                  redo: torch.Tensor, fn) -> torch.Tensor:
    """`out` with the rows flagged in `redo` replaced by `fn` of the
    entry, computed on the host (the output may be longer: the rows
    widen to fit)."""
    rows = torch.nonzero(redo).flatten()
    if rows.numel() == 0:
        return out
    idx = rows.cpu().numpy()
    fixed = code_points(np.array([fn(s) for s in dictionary[idx].tolist()],
                                 str), out.device)
    width = max(out.shape[1], fixed.shape[1])
    out = torch.nn.functional.pad(out, (0, width - out.shape[1]))
    out[rows] = torch.nn.functional.pad(fixed, (0, width - fixed.shape[1]))
    return out


def transform_dict_device(dictionary: np.ndarray, kind: str, args: tuple,
                          device, byte_tensors=None
                          ) -> Tuple[np.ndarray, torch.Tensor]:
    """Every dictionary entry transformed on `device` -> (the sorted
    duplicate-free output dictionary, the int32 code remap on the
    device).  `kind` is "substr" with args (pos, len), over the UTF-8
    bytes (`byte_tensors` reuses the dictionary's (offsets, bytes) when
    the caller has them), or "upper", "lower", "trim", "ltrim" or
    "rtrim" over the code points: an ASCII rewrite, and the entries with
    a character past ASCII redone on the host."""
    if kind != "substr" and kind not in _HOST_EXACT:
        raise ValueError(f"no device transform {kind!r}")
    if len(dictionary) == 0:
        return np.array([], str), torch.zeros(1, dtype=torch.int32,
                                              device=device)
    if kind == "substr":
        offsets, bytes_ = byte_tensors if byte_tensors is not None \
            else dict_byte_tensors(dictionary, device)
        out_offs, out_bytes = substr_bytes(offsets, bytes_, *args)
        return unique_remap(decode_code_points(out_offs, out_bytes))
    cps = code_points(dictionary, device)
    if kind in ("upper", "lower"):
        out = _case_cps(cps, kind == "upper")
    else:
        out = _trim_cps(cps, kind != "rtrim", kind != "ltrim")
    out = _redo_on_host(out, dictionary, (cps >= 0x80).any(dim=1),
                        _HOST_EXACT[kind])
    return unique_remap(out)
