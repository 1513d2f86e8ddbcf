"""The port's lane codecs (ops/bitpack.py) and the RLE run-domain
predicate (ops/encodings.rle_predicate_mask) against the JAX package's.

Ports of tests/test_exchange_opt.py's codec cases: bit packing, the
frame-of-reference wire widths and round trips, run-length encoding.
Each runs the same inputs, made from a seed with numpy, through the JAX
package's function and the port's (CPU tensors) and holds them equal:
packed bytes, wire dtypes, the encoded words' bits, decoded lanes and
run counts exactly.  `rle_predicate_mask` is held to decode-first
(`rle_decode`, then the predicate row by row) and to the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import bitpack as JB
from spark_rapids_tpu.ops import encodings as JENC
from spark_rapids_tpu_torch.ops import bitpack as PB
from spark_rapids_tpu_torch.ops import encodings as PENC

# one intra-op thread a process: the suite runs several pytest
# workers on the host's cores, and small ops over-subscribed
# across every worker's pool run tens of times slower
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(4, 128), (1, 8), (3, 64)])
def test_pack_bits_roundtrip_and_width(shape):
    rng = np.random.default_rng(3)
    x = rng.random(shape) < 0.3
    p = PB.pack_bits(torch.from_numpy(x))
    assert p.shape == shape[:-1] + (shape[-1] // 8,) and \
        p.dtype == torch.uint8                        # 8 rows a byte
    assert np.array_equal(p.numpy(), np.asarray(JB.pack_bits(
        jnp.asarray(x))))
    assert np.array_equal(PB.unpack_bits(p).numpy(), x)


FOR_CASES = [(0, 200, np.uint8), (1000, 1255, np.uint8),
             (-5, 60_000, np.uint16), (0, 2 ** 31, np.uint32),
             (0, 2 ** 33, np.int64), (-2 ** 40, 2 ** 40, np.int64),
             (7, 7, np.uint8)]


@pytest.mark.parametrize("lo,hi,want", FOR_CASES)
def test_for_encode_narrow_widths_and_roundtrip(lo, hi, want):
    wd = PB.wire_dtype_for(lo, hi, np.int64)
    assert np.dtype(wd) == np.dtype(want) == \
        np.dtype(JB.wire_dtype_for(lo, hi, np.int64)), (lo, hi, wd)
    vals = np.linspace(lo, hi, 17).astype(np.int64)
    enc = PB.for_encode(torch.from_numpy(vals), lo, wd)
    assert enc.element_size() == np.dtype(wd).itemsize
    # the word's bits are the reference's unsigned word
    ref = np.asarray(JB.for_encode(jnp.asarray(vals), jnp.int64(lo), wd))
    assert np.array_equal(enc.numpy().view(ref.dtype), ref)
    dec = PB.for_decode(enc, lo, np.int64)
    assert dec.dtype == torch.int64 and np.array_equal(dec.numpy(), vals)


def test_wire_dtype_of_an_empty_lane():
    # lo > hi: no live row, the cheapest legal width
    assert np.dtype(PB.wire_dtype_for(0, -1, np.int64)) == np.uint8
    assert np.dtype(PB.wire_dtype_for(0, -1, np.int8)) == np.int8


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64, np.int8])
def test_bytes_to_words_roundtrip(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 10)) * 100).astype(dtype)
    w = PB.bytes_to_words(torch.from_numpy(x))
    ref = np.asarray(JB.bytes_to_words(jnp.asarray(x)))
    assert np.array_equal(w.numpy(), ref)
    back = PB.words_to_lane(w, dtype)
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_rle_roundtrip_and_run_counts(seed):
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 9, 20)
    x = np.repeat(rng.integers(-3, 3, 20), runs)[:96]
    x = np.pad(x, (0, 96 - len(x)), mode="edge")
    vals, lens, n = PB.rle_encode(torch.from_numpy(x))
    jv, jl, jn = map(np.asarray, JB.rle_encode(jnp.asarray(x)))
    n = int(n)
    assert n == int(jn) and n <= 40 and int(lens[:n].sum()) == 96
    assert np.array_equal(vals[:n].numpy(), jv[:n])
    assert np.array_equal(lens.numpy(), jl)
    dec = PB.rle_decode(vals, lens, 96)
    assert np.array_equal(dec.numpy(), x)
    # a constant lane collapses to one run
    _, _, n1 = PB.rle_encode(torch.zeros(64, dtype=torch.int64))
    assert int(n1) == 1


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("op", ["lt", "eq", "ge"])
def test_rle_predicate_mask_equals_decode_first(seed, op):
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 30, 40)
    x = np.repeat(rng.integers(-50, 50, 40), runs)
    cap = len(x) + 13                           # rows past the runs
    xp = np.pad(x, (0, cap - len(x)))
    vals, lens, n = PB.rle_encode(torch.from_numpy(xp[:len(x)]))
    pred = {"lt": lambda v: v < 7, "eq": lambda v: v == 3,
            "ge": lambda v: v >= -4}[op]
    got = PENC.rle_predicate_mask(vals[:int(n)], lens[:int(n)], cap, pred)
    dec = PB.rle_decode(vals[:int(n)], lens[:int(n)], cap)
    want = pred(dec) & (torch.arange(cap) < len(x))
    assert torch.equal(got, want)
    ref = JENC.rle_predicate_mask(jnp.asarray(vals[:int(n)].numpy()),
                                  jnp.asarray(lens[:int(n)].numpy()), cap,
                                  pred)
    assert np.array_equal(got.numpy(), np.asarray(ref))
