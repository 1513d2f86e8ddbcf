"""The port's host codecs (spark_rapids_tpu_torch/native/codecs.cpp)
against pyarrow's: Snappy raw blocks and Zstandard frames decoded and
encoded both ways, over empty, one-byte, incompressible, highly
repetitive and larger than 128 KiB inputs, Zstandard at levels 1, 3, 9
and 19 (libzstd's FSE and Huffman tables, repeat offsets, several
blocks), and the Parquet value decoders.  Every result is exact.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import native

torch.set_num_threads(1)

_rng = np.random.default_rng(11)
INPUTS = {
    "empty": b"",
    "one_byte": b"x",
    "incompressible": _rng.bytes(200_000),
    "repetitive": b"abcabcabd" * 40_000,
    "zeros": bytes(300_000),
    "sorted_ints": np.sort(_rng.integers(0, 1000, 50_000)).astype(
        np.int64).tobytes(),
    "text": " ".join(str(x) for x in _rng.integers(0, 100_000, 40_000))
    .encode(),
}


@pytest.mark.parametrize("name", list(INPUTS))
def test_snappy_both_ways(name):
    data = INPUTS[name]
    ours = native.snappy_compress(data)
    assert pa.decompress(ours, len(data), codec="snappy").to_pybytes() \
        == data
    theirs = pa.compress(data, codec="snappy").to_pybytes()
    assert native.snappy_decompress(theirs, len(data)).tobytes() == data
    assert native.snappy_decompress(ours).tobytes() == data


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_zstd_decodes_pyarrow_frames(name, level):
    data = INPUTS[name]
    frame = pa.Codec("zstd", compression_level=level).compress(data) \
        .to_pybytes()
    assert native.zstd_decompress(frame, len(data)).tobytes() == data
    assert native.zstd_decompress(frame).tobytes() == data


@pytest.mark.parametrize("name", list(INPUTS))
def test_zstd_frames_decode_in_pyarrow(name):
    data = INPUTS[name]
    frame = native.zstd_compress(data)
    assert pa.decompress(frame, len(data), codec="zstd").to_pybytes() \
        == data
    assert native.zstd_decompress(frame).tobytes() == data


def test_zstd_concatenated_frames_and_corruption():
    a, b = INPUTS["text"], INPUTS["repetitive"]
    both = native.zstd_compress(a) + \
        pa.Codec("zstd", compression_level=3).compress(b).to_pybytes()
    assert native.zstd_decompress(both, len(a) + len(b)).tobytes() == a + b
    frame = native.zstd_compress(a)
    for bad in (frame[:-7], b"\x00" + frame[1:]):      # truncated, no magic
        with pytest.raises(native.CodecError):
            native.zstd_decompress(bad, len(a))
    with pytest.raises(native.CodecError):
        native.snappy_decompress(native.snappy_compress(a)[:-3], len(a))


def test_gzip_round_trips_with_pyarrow():
    data = INPUTS["text"]
    ours = native.gzip_compress(data)
    assert pa.decompress(ours, len(data), codec="gzip").to_pybytes() == data
    theirs = pa.compress(data, codec="gzip").to_pybytes()
    assert native.gzip_decompress(theirs, len(data)).tobytes() == data


def _hybrid_bitpacked(values, width):
    n = len(values)
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, np.uint64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(width, dtype=np.uint64)) & 1)
    return bytes([groups << 1 | 1]) + np.packbits(
        bits.astype(np.uint8).reshape(-1), bitorder="little").tobytes()


@pytest.mark.parametrize("width", [1, 3, 8, 13, 20, 32])
def test_rle_hybrid_runs(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 2 ** width, 21, dtype=np.uint64)
    rle_val = int(vals[0])
    nbytes = (width + 7) // 8
    buf = bytes([7 << 1]) + rle_val.to_bytes(nbytes, "little") + \
        _hybrid_bitpacked(vals, width)
    out, used = native.rle_hybrid_decode(np.frombuffer(buf, np.uint8),
                                         width, 28)
    assert used == len(buf)
    want = np.concatenate([np.full(7, rle_val), vals]).astype(np.uint32)
    assert (out.view(np.uint32) == want).all()


def _uleb(n):
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def test_delta_binary_packed_zero_width_and_partial_miniblocks():
    # one block of 128 values in 4 miniblocks of 32; 70 values, so 69
    # deltas: miniblock 1 all at the minimum (bit width 0, no bytes),
    # miniblock 2 full, miniblock 3 partial (padded), miniblock 4 absent
    first = -5
    deltas = [3] * 32 + [3 + i for i in range(37)]
    mind = min(deltas)
    adj = [d - mind for d in deltas]
    widths = [max(adj[k:k + 32] or [0]).bit_length()
              for k in range(0, 128, 32)]
    assert widths[0] == 0 and widths[3] == 0
    zz = lambda v: (v << 1) if v >= 0 else ((-v << 1) - 1)   # noqa: E731
    body = _uleb(128) + _uleb(4) + _uleb(70) + _uleb(zz(first))
    body += _uleb(zz(mind)) + bytes(widths)
    for k in (1, 2):
        part = np.zeros(32, np.uint64)
        chunk = adj[32 * k:32 * k + 32]
        part[:len(chunk)] = chunk
        body += _hybrid_bitpacked(part, widths[k])[1:]
    out, used = native.delta_binary_decode(np.frombuffer(body, np.uint8),
                                           70)
    assert used == len(body)
    assert out.tolist() == np.cumsum([first] + deltas).tolist()


def test_byte_array_decimals_sign_extend_to_16_bytes():
    # BYTE_ARRAY decimals (a writer other than pyarrow's) become 16-byte
    # rows: each span right-aligned, its sign extended
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 50)] + \
        [0, -1, 1, -(2 ** 127), 2 ** 127 - 1, 255, -256]
    width = [next(n for n in range(1, 17)
                  if -(1 << (8 * n - 1)) <= v < 1 << (8 * n - 1))
             for v in vals]
    raw = [v.to_bytes(w, "big", signed=True) for v, w in zip(vals, width)]
    buf = np.frombuffer(b"".join(raw), np.uint8)
    lens = np.array([len(r) for r in raw], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    rows = native.spans_to_be16(buf, starts, lens)
    assert [int.from_bytes(r.tobytes(), "big", signed=True)
            for r in rows] == vals
