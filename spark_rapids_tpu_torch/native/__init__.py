"""Native host-runtime bindings (ctypes over two C++ libraries).

Counterpart of spark_rapids_tpu/native/__init__.py.  Two libraries:

  * `spillio.cpp` (the reference's own source, copied): checksummed block
    framing with xxhash64, single-block spill files (the disk tier of
    runtime/memory.py) and multi-block shuffle appenders;
  * `codecs.cpp` (the port's): Snappy, Zstandard frames and the Parquet
    value decoders of io/parquet.py.

Both build with `g++ -O2 -shared -fPIC` at first use into
`spark_rapids_tpu_torch/_build/`, keyed by a hash of the source, each to a
temporary name that `os.replace` publishes, so processes that build at
once never load half a file.  A failed build raises: the runtime has no
pure-Python stand-in.  ctypes releases the GIL around each call, so a
thread pool decodes and encodes in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from typing import List

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_MAGIC = 0x53525450554C4F42
_HEADER = struct.Struct("<QQQ")

_lock = threading.Lock()
_libs: dict = {}

_c_i64, _c_u64, _c_p = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
_SIGNATURES = {
    "spillio": {
        "spill_write": (_c_i64, [ctypes.c_char_p, _c_p, _c_i64]),
        "spill_read": (_c_i64, [ctypes.c_char_p, _c_p, _c_i64]),
        "spill_length": (_c_i64, [ctypes.c_char_p]),
        "spill_xxhash64": (_c_u64, [_c_p, _c_i64, _c_u64]),
        "shuffle_open": (_c_p, [ctypes.c_char_p]),
        "shuffle_append": (_c_i64, [_c_p, _c_p, _c_i64]),
        "shuffle_close": (_c_i64, [_c_p]),
        "shuffle_read_block": (_c_i64, [ctypes.c_char_p, _c_i64, _c_p,
                                        _c_i64]),
    },
    "codecs": {
        "snappy_max_compressed": (_c_i64, [_c_i64]),
        "snappy_compress": (_c_i64, [_c_p, _c_i64, _c_p, _c_i64]),
        "snappy_length": (_c_i64, [_c_p, _c_i64]),
        "snappy_decompress": (_c_i64, [_c_p, _c_i64, _c_p, _c_i64]),
        "zstd_max_compressed": (_c_i64, [_c_i64]),
        "zstd_compress": (_c_i64, [_c_p, _c_i64, _c_p, _c_i64,
                                   ctypes.c_int]),
        "zstd_content_size": (_c_i64, [_c_p, _c_i64]),
        "zstd_decompress": (_c_i64, [_c_p, _c_i64, _c_p, _c_i64]),
        "rle_hybrid_decode": (_c_i64, [_c_p, _c_i64, ctypes.c_int, _c_p,
                                       _c_i64]),
        "delta_binary_decode": (_c_i64, [_c_p, _c_i64, _c_p, _c_i64,
                                         _c_p]),
        "plain_byte_array_index": (_c_i64, [_c_p, _c_i64, _c_i64, _c_p,
                                            _c_p]),
        "gather_fixed": (None, [_c_p, _c_p, _c_p, _c_i64, _c_i64, _c_p]),
        "be_int64": (None, [_c_p, _c_i64, ctypes.c_int, _c_p]),
        "delta_byte_array": (_c_i64, [_c_p, _c_i64, _c_p, _c_p, _c_p, _c_p,
                                      _c_i64, _c_p]),
        "spans_to_be16": (_c_i64, [_c_p, _c_p, _c_p, _c_i64, _c_p]),
        "avro_decode_flat": (_c_i64, [_c_p, _c_i64, _c_i64, ctypes.c_int,
                                      _c_p, _c_p, _c_p, _c_p, _c_p]),
    },
}


def library_path(name: str) -> str:
    """Where `name`'s shared library lives once built (keyed by a hash of
    its source and the flags)."""
    src = os.path.join(_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name` ("spillio" or "codecs"), built with g++
    on first use; raises if the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                r = subprocess.run(
                    ["g++", *CXX_FLAGS, os.path.join(_DIR, f"{name}.cpp"),
                     "-o", tmp], capture_output=True, text=True, timeout=300)
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {name}.cpp:\n"
                                       f"{r.stderr[-4000:]}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(out)
        for fn, (res, args) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = res
            f.argtypes = args
        _libs[name] = lib
        return lib


def native_available() -> bool:
    """True once both libraries load (a failed build raises instead)."""
    library("spillio")
    library("codecs")
    return True


def _address(data) -> tuple:
    """(address, nbytes, keep-alive) of a bytes-like object, without a
    copy of a contiguous buffer."""
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
    else:
        arr = np.frombuffer(data, np.uint8) if memoryview(data).nbytes \
            else np.zeros(0, np.uint8)
    if arr.nbytes == 0:
        arr = np.zeros(1, np.uint8)
        return arr.ctypes.data, 0, arr
    return arr.ctypes.data, arr.nbytes, arr


# ---------------------------------------------------------------------------
# Spill blocks
# ---------------------------------------------------------------------------

def xxhash64(data, seed: int = 0) -> int:
    addr, n, _keep = _address(data)
    return int(library("spillio").spill_xxhash64(addr, n, seed))


def spill_write(path: str, data) -> int:
    """Write one checksummed spill block; returns bytes written."""
    addr, n, _keep = _address(data)
    r = library("spillio").spill_write(path.encode(), addr, n)
    if r < 0:
        raise IOError(f"native spill_write failed for {path}")
    return int(r)


#: spill_read's error codes (spillio.cpp)
SPILL_ERRORS = {-1: "open or short read", -2: "bad magic",
                -3: "capacity too small", -4: "checksum mismatch"}


def spill_read_array(path: str) -> np.ndarray:
    """Read and verify one spill block into a new uint8 array; IOError
    naming the failure (-4 = checksum mismatch) otherwise."""
    lib = library("spillio")
    n = lib.spill_length(path.encode())
    if n < 0:
        raise IOError(f"bad spill file {path}: "
                      f"{SPILL_ERRORS.get(int(n), n)}")
    out = np.empty(max(int(n), 1), np.uint8)
    r = lib.spill_read(path.encode(), out.ctypes.data, n)
    if r < 0:
        raise IOError(f"spill read failed for {path} (code {r}; "
                      f"{SPILL_ERRORS.get(int(r), '?')})")
    return out[:r]


def spill_read(path: str) -> bytes:
    """Read and verify one spill block; raises on corruption."""
    return spill_read_array(path).tobytes()


class ShuffleBlockWriter:
    """Appends framed blocks to one shuffle data file; returns per-block
    offsets (the sort-shuffle index-file role).  Copied with the
    reference's library; the port's exchange (ROADMAP Queue 1 item 9)
    does not use it yet."""

    def __init__(self, path: str):
        self.path = path
        self.offsets: List[int] = []
        self._lib = library("spillio")
        self._h = self._lib.shuffle_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")

    def append(self, data) -> int:
        addr, n, _keep = _address(data)
        off = self._lib.shuffle_append(self._h, addr, n)
        if off < 0:
            raise IOError("shuffle append failed")
        self.offsets.append(int(off))
        return int(off)

    def close(self) -> int:
        total = self._lib.shuffle_close(self._h)
        self._h = None
        if total < 0:
            raise IOError("shuffle close failed")
        return int(total)


def read_shuffle_block(path: str, offset: int) -> bytes:
    """One framed block of a shuffle data file (unused until Queue 1
    item 9, as ShuffleBlockWriter)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(offset)
        hdr = f.read(24)
    if len(hdr) < 24:
        raise IOError(f"truncated shuffle block header in {path} "
                      f"at {offset}")
    magic, n, _h = _HEADER.unpack(hdr)
    if magic != _MAGIC:
        raise IOError(f"bad shuffle block magic in {path} at {offset}")
    if n > size - offset - 24:
        raise IOError(f"shuffle block length {n} exceeds file size "
                      f"({path} at {offset})")
    out = np.empty(max(int(n), 1), np.uint8)
    r = library("spillio").shuffle_read_block(path.encode(), offset,
                                              out.ctypes.data, n)
    if r < 0:
        raise IOError(f"shuffle block read failed (code {r})")
    return out[:r].tobytes()


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

class CodecError(ValueError):
    """A compressed buffer that does not decode."""


def snappy_compress(data) -> bytes:
    lib = library("codecs")
    addr, n, _keep = _address(data)
    out = np.empty(lib.snappy_max_compressed(n), np.uint8)
    r = lib.snappy_compress(addr, n, out.ctypes.data, len(out))
    if r < 0:
        raise CodecError(f"snappy compress failed ({r})")
    return out[:r].tobytes()


def snappy_decompress(data, size: int = -1) -> np.ndarray:
    """The decoded bytes as a uint8 array (`size` checks the length)."""
    lib = library("codecs")
    addr, n, _keep = _address(data)
    want = lib.snappy_length(addr, n)
    if want < 0 or (size >= 0 and want != size):
        raise CodecError(f"snappy block of {want} bytes, expected {size}")
    out = np.empty(max(int(want), 1), np.uint8)
    r = lib.snappy_decompress(addr, n, out.ctypes.data, want)
    if r != want:
        raise CodecError(f"corrupt snappy block ({r})")
    return out[:r]


def zstd_compress(data, level: int = 3) -> bytes:
    """One Zstandard frame (greedy matches, raw or RLE literals, the
    predefined sequence codes: a lower ratio than libzstd's)."""
    lib = library("codecs")
    addr, n, _keep = _address(data)
    out = np.empty(lib.zstd_max_compressed(n), np.uint8)
    r = lib.zstd_compress(addr, n, out.ctypes.data, len(out), level)
    if r < 0:
        raise CodecError(f"zstd compress failed ({r})")
    return out[:r].tobytes()


def zstd_decompress(data, size: int = -1) -> np.ndarray:
    """Every frame of `data` decoded, as a uint8 array.  `size` is the
    expected length (Parquet's uncompressed page size); without it the
    first frame's content size is read, growing the buffer if absent."""
    lib = library("codecs")
    addr, n, _keep = _address(data)
    cap = size if size >= 0 else lib.zstd_content_size(addr, n)
    if cap < 0:
        cap = max(4 * n, 1 << 16)
    while True:
        out = np.empty(max(int(cap), 1), np.uint8)
        r = lib.zstd_decompress(addr, n, out.ctypes.data, cap)
        if r == -2 and size < 0:
            cap *= 2
            continue
        if r < 0 or (size >= 0 and r != size):
            raise CodecError(f"corrupt zstd frame ({r}, expected {size})")
        return out[:r]


def gzip_compress(data) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, 31)
    return c.compress(bytes(memoryview(data))) + c.flush()


def gzip_decompress(data, size: int = -1) -> np.ndarray:
    out = zlib.decompress(bytes(memoryview(data)), 47)
    if size >= 0 and len(out) != size:
        raise CodecError(f"gzip member of {len(out)} bytes, expected {size}")
    return np.frombuffer(out, np.uint8)


def rle_hybrid_decode(buf: np.ndarray, width: int, count: int):
    """(int32 values, bytes consumed) of Parquet's RLE / bit-packed
    hybrid at `width` bits."""
    out = np.empty(max(count, 1), np.int32)
    if count == 0:
        return out[:0], 0
    r = library("codecs").rle_hybrid_decode(buf.ctypes.data, len(buf), width,
                                            out.ctypes.data, count)
    if r < 0:
        raise CodecError("corrupt RLE / bit-packed run")
    return out[:count], int(r)


def delta_binary_decode(buf: np.ndarray, count: int):
    """(int64 values, bytes consumed) of a DELTA_BINARY_PACKED run of at
    most `count` values."""
    out = np.empty(max(count, 1), np.int64)
    total = ctypes.c_int64(0)
    r = library("codecs").delta_binary_decode(
        buf.ctypes.data, len(buf), out.ctypes.data, count,
        ctypes.addressof(total))
    if r < 0:
        raise CodecError(f"corrupt DELTA_BINARY_PACKED run ({r})")
    return out[:total.value], int(r)


def plain_byte_array_index(buf: np.ndarray, count: int):
    """(starts int64, lengths int32, bytes consumed) of `count` PLAIN
    BYTE_ARRAY values."""
    starts = np.empty(max(count, 1), np.int64)
    lens = np.empty(max(count, 1), np.int32)
    r = library("codecs").plain_byte_array_index(
        buf.ctypes.data, len(buf), count, starts.ctypes.data,
        lens.ctypes.data)
    if r < 0:
        raise CodecError("corrupt PLAIN BYTE_ARRAY values")
    return starts[:count], lens[:count], int(r)


def be_int64(rows: np.ndarray) -> np.ndarray:
    """(n, width <= 8) uint8 rows of big-endian two's complement values
    as int64."""
    rows = np.ascontiguousarray(rows)
    n, width = rows.shape
    out = np.empty(max(n, 1), np.int64)
    library("codecs").be_int64(rows.ctypes.data, n, width, out.ctypes.data)
    return out[:n]


def delta_byte_array(buf: np.ndarray, prefix: np.ndarray,
                     suf_starts: np.ndarray, suf_lens: np.ndarray):
    """DELTA_BYTE_ARRAY values -> (their bytes back to back, n + 1
    offsets)."""
    n = len(prefix)
    prefix = np.ascontiguousarray(prefix, np.int64)
    suf_starts = np.ascontiguousarray(suf_starts, np.int64)
    suf_lens = np.ascontiguousarray(suf_lens, np.int64)
    cap = int(prefix.sum() + suf_lens.sum())
    out = np.empty(max(cap, 1), np.uint8)
    offs = np.empty(n + 1, np.int64)
    r = library("codecs").delta_byte_array(
        buf.ctypes.data, n, prefix.ctypes.data, suf_starts.ctypes.data,
        suf_lens.ctypes.data, out.ctypes.data, cap, offs.ctypes.data)
    if r < 0:
        raise CodecError(f"corrupt DELTA_BYTE_ARRAY values ({r})")
    return out[:cap], offs


def spans_to_be16(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray
                  ) -> np.ndarray:
    """Big-endian two's complement byte spans as (n, 16) sign-extended
    rows."""
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.empty((max(n, 1), 16), np.uint8)
    r = library("codecs").spans_to_be16(buf.ctypes.data, starts.ctypes.data,
                                        lens.ctypes.data, n, out.ctypes.data)
    if r < 0:
        raise CodecError("a BYTE_ARRAY decimal wider than 16 bytes")
    return out[:n]


def gather_fixed(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray
                 ) -> np.ndarray:
    """Byte spans of `buf` as a numpy 'S' array (zero-padded)."""
    n = len(starts)
    width = max(int(lens.max()) if n else 0, 1)
    out = np.empty((n, width), np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    library("codecs").gather_fixed(buf.ctypes.data, starts.ctypes.data,
                                   lens.ctypes.data, n, width,
                                   out.ctypes.data)
    return out.view(f"S{width}").reshape(n)


def avro_decode_flat(buf: np.ndarray, rows: int, kinds, null_branch):
    """Decode `rows` Avro records of flat fields (native/codecs.cpp
    `avro_decode_flat`) -> ([int64 values], [int32 lengths], [bool
    validity], bytes consumed), one entry a field."""
    nf = len(kinds)
    vals = [np.zeros(max(rows, 1), np.int64) for _ in range(nf)]
    lens = [np.zeros(max(rows, 1), np.int32) for _ in range(nf)]
    valid = [np.zeros(max(rows, 1), np.uint8) for _ in range(nf)]

    def ptrs(arrs):
        return np.array([a.ctypes.data for a in arrs], np.uint64)
    pv, pl, pva = ptrs(vals), ptrs(lens), ptrs(valid)
    k = np.asarray(kinds, np.int32)
    nb = np.asarray(null_branch, np.int32)
    r = library("codecs").avro_decode_flat(
        buf.ctypes.data, len(buf), rows, nf, k.ctypes.data, nb.ctypes.data,
        pv.ctypes.data, pl.ctypes.data, pva.ctypes.data)
    if r < 0:
        raise CodecError(f"corrupt avro block ({r})")
    return ([v[:rows] for v in vals], [x[:rows] for x in lens],
            [x[:rows].astype(bool) for x in valid], int(r))
