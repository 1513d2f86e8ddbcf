"""Spark-exact Murmur3_x86_32 and XXH64 hashing, on tensors and on numpy.

Counterpart of spark_rapids_tpu/ops/hashing.py.  Bit-compatibility with
Spark's `hash()` (Murmur3_x86_32, seed 42) and `xxhash64()` (XXH64,
seed 42) matters because hash partitioning decides row placement, and
CPU and device operators must agree on it.

Spark's semantics, per column folded into a running per-row seed:

  * a null field leaves the running hash unchanged;
  * boolean -> hashInt(0/1); byte/short/int/date -> hashInt of the
    sign-extended value; long/timestamp -> hashLong;
  * float/double -> hashInt/hashLong of the bits, -0.0 folded into +0.0
    and every NaN the canonical one (`doubleToLongBits`);
  * a decimal of at most 18 digits -> hashLong of its unscaled value;
  * a string -> hashUnsafeBytes of its UTF-8 bytes (murmur3: 4-byte
    little-endian words, then one round a signed tail byte).

PyTorch has no usable unsigned arithmetic, so every lane here is int64:
a 32-bit murmur3 lane holds a value in [0, 2^32) and is masked after
each multiply and shift-or; a 64-bit XXH64 lane is the two's-complement
image of the uint64, whose multiplies and adds wrap modulo 2^64.  `>>`
of an int64 is arithmetic, so every logical shift masks (`_lsr`).  The
same functions run on numpy int64 arrays, which wrap alike, so the CPU
engine (exec/host_exec.py) computes with this code on numpy and the
device path on tensors.

Strings hash per dictionary entry on the host: where the string is the
first column the running seed is the constant 42 and each row picks up
`dict_hashes[code]`.  Behind another column the seed differs by row, so
each entry's words are tabled once on the host (murmur3's pre-mixed
words, XXH64's 8-byte words) and the rows fold them with their own
seeds, one gather per word position; the reference runs that case on
its CPU engine only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import types as t
from ..runtime.capture import host_constant

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
SPARK_SEED = 42
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _s64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    c &= _M64
    return c - (1 << 64) if c >= 1 << 63 else c


def where(cond, a, b):
    """torch.where or np.where, by the condition's kind."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _i64(x):
    """An int64 lane of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return np.asarray(x).astype(np.int64)


def _lsr(x, r: int):
    """Logical right shift of an int64 lane by 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


# ---------------------------------------------------------------------------
# Murmur3_x86_32 over 32-bit values held in int64 lanes
# ---------------------------------------------------------------------------

def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    k1 = (k1 * _C1) & _M32
    k1 = _rotl32(k1, 15)
    return (k1 * _C2) & _M32


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def hash_int32(x, seed):
    """Murmur3 hashInt: the low 32 bits of `x` under `seed` (a lane or
    an int in [0, 2^32)) -> int64 lane in [0, 2^32)."""
    h1 = _mix_h1(seed, _mix_k1(_i64(x) & _M32))
    return _fmix(h1, 4)


def hash_int64(x, seed):
    """Murmur3 hashLong: the low word, then the high word."""
    x = _i64(x)
    h1 = _mix_h1(seed, _mix_k1(x & _M32))
    h1 = _mix_h1(h1, _mix_k1((x >> 32) & _M32))
    return _fmix(h1, 8)


def double_bits(x):
    """int64 bits of DOUBLE values as Spark hashes them: -0.0 as +0.0,
    every NaN as 0x7FF8000000000000 (doubleToLongBits)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float64)
        bits = torch.where(x == 0.0, torch.zeros_like(x), x).view(torch.int64)
        return torch.where(torch.isnan(x),
                           torch.full_like(bits, 0x7FF8000000000000), bits)
    x = np.asarray(x, np.float64)
    bits = np.where(x == 0.0, 0.0, x).view(np.int64)
    return np.where(np.isnan(x), np.int64(0x7FF8000000000000), bits)


def float_bits(x):
    """int32 bits (in an int64 lane) of FLOAT values: -0.0 as +0.0, NaN
    as 0x7FC00000 (floatToIntBits)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        bits = torch.where(x == 0.0, torch.zeros_like(x), x).view(torch.int32)
        return torch.where(torch.isnan(x), torch.full_like(bits, 0x7FC00000),
                           bits).to(torch.int64)
    x = np.asarray(x, np.float32)
    bits = np.where(x == 0.0, np.float32(0.0), x).view(np.int32)
    return np.where(np.isnan(x), np.int32(0x7FC00000), bits).astype(np.int64)


def hash_width(dt: t.DataType) -> Optional[int]:
    """32 or 64: how Spark hashes a fixed-width type (hashInt or
    hashLong); None for a type hashed otherwise or not at all."""
    if isinstance(dt, (t.BooleanType, t.ByteType, t.ShortType, t.IntegerType,
                       t.DateType, t.FloatType)):
        return 32
    if isinstance(dt, (t.LongType, t.TimestampType, t.DoubleType)):
        return 64
    if isinstance(dt, t.DecimalType) and not dt.is_wide:
        return 64
    return None


def hash_lane(data, dt: t.DataType):
    """The int64 lane Spark feeds hashInt/hashLong for a fixed-width
    column's data (compute lane on the device, storage lane on the
    host)."""
    if isinstance(dt, t.DoubleType):
        return double_bits(data)
    if isinstance(dt, t.FloatType):
        return float_bits(data)
    return _i64(data)


def hash_column(data, validity, dt: t.DataType, seed):
    """Fold one fixed-width column into a running murmur3 lane (Spark
    semantics); `seed` is the running lane (or an int), and nulls pass
    it through.  Strings fold by `murmur3_strings`, or as the first
    column by `first_string_table`."""
    width = hash_width(dt)
    if width is None:
        raise TypeError(f"unsupported hash type {dt}")
    lane = hash_lane(data, dt)
    h = hash_int32(lane, seed) if width == 32 else hash_int64(lane, seed)
    if validity is not None:
        h = where(validity, h, seed)
    return h


# ---------------------------------------------------------------------------
# XXH64 over int64 lanes holding uint64 bits
# ---------------------------------------------------------------------------

_XXP1 = 0x9E3779B185EBCA87
_XXP2 = 0xC2B2AE3D27D4EB4F
_XXP3 = 0x165667B19E3779F9
_XXP4 = 0x85EBCA77C2B2AE63
_XXP5 = 0x27D4EB2F165667C5
_P1, _P2, _P3, _P4, _P5 = (_s64(p) for p in (_XXP1, _XXP2, _XXP3, _XXP4,
                                              _XXP5))


def _rotl64_lane(x, r: int):
    return (x << r) | _lsr(x, 64 - r)


def _xx_fmix_lane(h):
    h = h ^ _lsr(h, 33)
    h = h * _P2
    h = h ^ _lsr(h, 29)
    h = h * _P3
    return h ^ _lsr(h, 32)


def xxhash64_long_lane(lane, seed):
    """Spark XXH64.hashLong over an int64 lane; `seed` is the running
    int64 lane (or an int): per-row chaining across columns."""
    h = seed + _s64(_XXP5 + 8)
    h = h ^ (_rotl64_lane(_i64(lane) * _P2, 31) * _P1)
    h = _rotl64_lane(h, 27) * _P1 + _P4
    return _xx_fmix_lane(h)


def xxhash64_int_lane(lane, seed):
    """Spark XXH64.hashInt over the low 32 bits of a lane (zero-extended,
    as Java's `i & 0xFFFFFFFFL`)."""
    h = seed + _s64(_XXP5 + 4)
    h = h ^ ((_i64(lane) & _M32) * _P1)
    h = _rotl64_lane(h, 23) * _P2 + _P3
    return _xx_fmix_lane(h)


def xxhash64_column(data, validity, dt: t.DataType, seed):
    """Fold one fixed-width column into a running XXH64 lane."""
    width = hash_width(dt)
    if width is None:
        raise TypeError(f"unsupported xxhash64 type {dt}")
    lane = hash_lane(data, dt)
    h = xxhash64_int_lane(lane, seed) if width == 32 \
        else xxhash64_long_lane(lane, seed)
    if validity is not None:
        h = where(validity, h, seed)
    return h


# ---------------------------------------------------------------------------
# Strings under a per-row seed: per-entry word tables
# ---------------------------------------------------------------------------

def _entry_bytes(dictionary):
    return [str(s).encode("utf-8") for s in dictionary]


class StringTables:
    """Per-dictionary tables that let a row hash its string under its own
    running seed.  `murmur_k1` [E, U]: each entry's murmur3 units (the
    aligned 4-byte words, then each signed tail byte) already through
    mixK1, with `murmur_units` [E] and `nbytes` [E]; `xx_words` [E, W]:
    each entry's little-endian 8-byte words (zero padded).  numpy on the
    host; `to(device)` gives the tensor copy."""

    def __init__(self, dictionary):
        raw = _entry_bytes(dictionary)
        if not raw:
            raw = [b""]
        n = len(raw)
        self.nbytes = np.array([len(b) for b in raw], np.int64)
        units = [[int.from_bytes(b[i:i + 4], "little")
                  for i in range(0, len(b) - len(b) % 4, 4)] +
                 [(x - 256 if x >= 128 else x) & _M32
                  for x in b[len(b) - len(b) % 4:]] for b in raw]
        self.murmur_units = np.array([len(u) for u in units], np.int64)
        width = max(1, int(self.murmur_units.max()))
        k = np.zeros((n, width), np.int64)
        for i, u in enumerate(units):
            k[i, :len(u)] = u
        self.murmur_k1 = _mix_k1(k)
        words = max(1, -(-int(self.nbytes.max()) // 8))
        w = np.zeros((n, words * 8), np.uint8)
        for i, b in enumerate(raw):
            w[i, :len(b)] = np.frombuffer(b, np.uint8)
        self.xx_words = w.view("<i8").astype(np.int64).reshape(n, words)

    def to(self, device) -> "StringTables":
        out = object.__new__(StringTables)
        for name in ("nbytes", "murmur_units", "murmur_k1", "xx_words"):
            setattr(out, name, host_constant(getattr(self, name), device))
        return out


def _gather2(table, codes, col):
    """table[codes, col] of a 2-D table (col a lane or an int)."""
    width = table.shape[1]
    if isinstance(codes, torch.Tensor):
        flat = table.reshape(-1)
        if not isinstance(col, torch.Tensor):
            col = torch.full_like(codes, col)
        return flat[codes * width + col.clamp(0, width - 1)]
    return table[codes, np.clip(col, 0, width - 1)]


def murmur3_strings(codes, seed, tabs: StringTables):
    """Murmur3 hashUnsafeBytes of each row's dictionary entry under the
    row's own running seed (codes already clipped into the table)."""
    units = tabs.murmur_units[codes]
    h = seed
    for u in range(tabs.murmur_k1.shape[1]):
        h = where(u < units, _mix_h1(h, _gather2(tabs.murmur_k1, codes, u)),
                   h)
    return _fmix(h, tabs.nbytes[codes])


def xxhash64_strings(codes, seed, tabs: StringTables):
    """XXH64 hashUnsafeBytes of each row's dictionary entry under the
    row's own running seed: the 32-byte stripes, the 8-byte words, one
    4-byte word and the tail bytes, each step masked to the rows whose
    string reaches it."""
    words = tabs.xx_words
    length = tabs.nbytes[codes]
    stripes = length // 32
    v = [seed + _s64(_XXP1 + _XXP2), seed + _P2, seed, seed - _P1]
    for s in range((words.shape[1]) // 4):
        act = s < stripes
        for j in range(4):
            w = _gather2(words, codes, 4 * s + j)
            v[j] = where(act, _rotl64_lane(v[j] + w * _P2, 31) * _P1, v[j])
    big = _rotl64_lane(v[0], 1) + _rotl64_lane(v[1], 7) + \
        _rotl64_lane(v[2], 12) + _rotl64_lane(v[3], 18)
    for vj in v:
        big = big ^ (_rotl64_lane(vj * _P2, 31) * _P1)
        big = big * _P1 + _P4
    h = where(length >= 32, big, seed + _P5) + length
    base = 4 * stripes                      # word index after the stripes
    rem = length - 32 * stripes
    nwords = rem // 8
    for j in range(3):
        w = _gather2(words, codes, base + j)
        nh = _rotl64_lane(h ^ (_rotl64_lane(w * _P2, 31) * _P1), 27) * _P1 \
            + _P4
        h = where(j < nwords, nh, h)
    rem = rem - 8 * nwords
    w4 = _gather2(words, codes, base + nwords) & _M32
    has4 = rem >= 4
    h = where(has4, _rotl64_lane(h ^ (w4 * _P1), 23) * _P2 + _P3, h)
    pos = 32 * stripes + 8 * nwords + where(has4, 4, 0)
    for i in range(3):
        p = pos + i
        byte = (_gather2(words, codes, p // 8) >> ((p % 8) * 8)) & 0xFF
        nh = _rotl64_lane(h ^ (byte * _P5), 11) * _P1
        h = where(p < length, nh, h)
    return _xx_fmix_lane(h)


def clip_codes(codes, n: int):
    codes = _i64(codes)
    return codes.clip(0, max(n - 1, 0))


# ---------------------------------------------------------------------------
# Host, one value at a time (Python ints; the tests' and tables' yardstick)
# ---------------------------------------------------------------------------

def murmur3_bytes(data: bytes, seed: int) -> int:
    """Spark Murmur3_x86_32.hashUnsafeBytes over `data` (per-byte tail)."""
    h1 = seed & _M32
    n = len(data)
    aligned = n - n % 4
    for i in range(0, aligned, 4):
        word = int.from_bytes(data[i:i + 4], "little")
        h1 = _mix_h1(h1, _mix_k1(word))
    for i in range(aligned, n):
        byte = int.from_bytes(data[i:i + 1], "little", signed=True)
        h1 = _mix_h1(h1, _mix_k1(byte & _M32))
    return int(_fmix(h1, n))


def murmur3_utf8(s, seed: int) -> int:
    return murmur3_bytes(s.encode("utf-8"), seed)


def dict_hash_array(dictionary, seed: int) -> np.ndarray:
    """uint32 murmur3 of every dictionary entry under `seed` (host;
    dictionaries are small); one entry of `seed` for an empty one."""
    out = np.empty(max(len(dictionary), 1), dtype=np.uint32)
    out[:] = np.uint32(seed)
    for i, v in enumerate(dictionary):
        if v is not None:
            out[i] = np.uint32(murmur3_utf8(str(v), seed))
    return out


def murmur3_int32_host(x: int, seed: int) -> int:
    return int(_fmix(_mix_h1(seed & _M32, _mix_k1(x & _M32)), 4))


def murmur3_int64_host(x: int, seed: int) -> int:
    x &= _M64
    h1 = _mix_h1(seed & _M32, _mix_k1(x & _M32))
    h1 = _mix_h1(h1, _mix_k1((x >> 32) & _M32))
    return int(_fmix(h1, 8))


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xx_fmix(h: int) -> int:
    h ^= h >> 33
    h = (h * _XXP2) & _M64
    h ^= h >> 29
    h = (h * _XXP3) & _M64
    h ^= h >> 32
    return h


def xxhash64_long_host(v: int, seed: int) -> int:
    """Spark XXH64.hashLong, exact (host ints, result in [0, 2^64))."""
    h = (seed + _XXP5 + 8) & _M64
    h ^= (_rotl64((v & _M64) * _XXP2 & _M64, 31) * _XXP1) & _M64
    h = (_rotl64(h, 27) * _XXP1 + _XXP4) & _M64
    return _xx_fmix(h)


def xxhash64_int_host(i: int, seed: int) -> int:
    """Spark XXH64.hashInt, exact (host ints)."""
    h = (seed + _XXP5 + 4) & _M64
    h ^= ((i & _M32) * _XXP1) & _M64
    h = (_rotl64(h, 23) * _XXP2 + _XXP3) & _M64
    return _xx_fmix(h)


def _xx_round(acc: int, w: int) -> int:
    return (_rotl64((acc + w * _XXP2) & _M64, 31) * _XXP1) & _M64


def xxhash64_bytes_host(data: bytes, seed: int) -> int:
    """Spark XXH64.hashUnsafeBytes (strings), exact."""
    length = len(data)
    seed &= _M64
    off = 0
    if length >= 32:
        v = [(seed + _XXP1 + _XXP2) & _M64, (seed + _XXP2) & _M64, seed,
             (seed - _XXP1) & _M64]
        while off + 32 <= length:
            for j in range(4):
                w = int.from_bytes(data[off + 8 * j:off + 8 * j + 8],
                                   "little")
                v[j] = _xx_round(v[j], w)
            off += 32
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) +
             _rotl64(v[3], 18)) & _M64
        for vj in v:
            h ^= _xx_round(0, vj)
            h = (h * _XXP1 + _XXP4) & _M64
    else:
        h = (seed + _XXP5) & _M64
    h = (h + length) & _M64
    while off + 8 <= length:
        w = int.from_bytes(data[off:off + 8], "little")
        h ^= _xx_round(0, w)
        h = (_rotl64(h, 27) * _XXP1 + _XXP4) & _M64
        off += 8
    if off + 4 <= length:
        w = int.from_bytes(data[off:off + 4], "little")
        h ^= (w * _XXP1) & _M64
        h = (_rotl64(h, 23) * _XXP2 + _XXP3) & _M64
        off += 4
    while off < length:
        h ^= (data[off] * _XXP5) & _M64
        h = (_rotl64(h, 11) * _XXP1) & _M64
        off += 1
    return _xx_fmix(h)


def xxhash64_utf8(s, seed: int) -> int:
    return xxhash64_bytes_host(s.encode("utf-8"), seed)


def dict_xxhash_array(dictionary, seed: int) -> np.ndarray:
    """uint64 XXH64 of every dictionary entry under `seed` (host)."""
    out = np.empty(max(len(dictionary), 1), dtype=np.uint64)
    out[:] = np.uint64(seed)
    for i, v in enumerate(dictionary):
        if v is not None:
            out[i] = np.uint64(xxhash64_utf8(str(v), seed))
    return out


def signed64(table: np.ndarray) -> np.ndarray:
    """A uint64 table as the int64 with the same bits."""
    return np.asarray(table, np.uint64).view(np.int64)


def first_string_table(dictionary, xx: bool) -> np.ndarray:
    """int64 hashes of each entry under the constant seed 42 (a string
    that is the first column): murmur3 in [0, 2^32), XXH64 as int64
    bits."""
    if xx:
        return signed64(dict_xxhash_array(dictionary, SPARK_SEED))
    return dict_hash_array(dictionary, SPARK_SEED).astype(np.int64)

