"""The port's native host runtime (spark_rapids_tpu_torch/native/): port
copies of tests/test_native.py, a block written by either package's
native library read by the other, xxhash64 equal over random buffers,
and the disk tier of runtime/memory.py framed by the native library.

Both libraries build with g++ at first use, here as on the card's
machine; the reads are exact.
"""
import os
import struct

import numpy as np
import pytest
import torch

from spark_rapids_tpu import native as JN
from spark_rapids_tpu_torch import native

torch.set_num_threads(1)


def test_native_builds():
    assert native.native_available(), "g++ toolchain should build spillio"


def test_spill_roundtrip(tmp_path):
    data = np.random.default_rng(1).bytes(100_000)
    path = str(tmp_path / "a.blk")
    n = native.spill_write(path, data)
    assert n == len(data) + 24
    assert native.spill_read(path) == data


def test_spill_empty(tmp_path):
    path = str(tmp_path / "e.blk")
    native.spill_write(path, b"")
    assert native.spill_read(path) == b""


def test_spill_corruption_detected(tmp_path):
    data = b"x" * 5000
    path = str(tmp_path / "c.blk")
    native.spill_write(path, data)
    raw = bytearray(open(path, "rb").read())
    raw[100] ^= 0xFF                      # flip a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        native.spill_read(path)


def test_bad_magic_detected(tmp_path):
    path = str(tmp_path / "m.blk")
    open(path, "wb").write(struct.pack("<QQQ", 0xDEAD, 0, 0))
    with pytest.raises(IOError):
        native.spill_read(path)


def test_shuffle_blocks_roundtrip(tmp_path):
    path = str(tmp_path / "s.dat")
    w = native.ShuffleBlockWriter(path)
    blocks = [np.random.default_rng(i).bytes(1000 + i * 37)
              for i in range(10)]
    offs = [w.append(b) for b in blocks]
    total = w.close()
    assert total == sum(24 + len(b) for b in blocks)
    # read back out of order
    for i in reversed(range(10)):
        assert native.read_shuffle_block(path, offs[i]) == blocks[i]


def test_xxhash64_known_vectors():
    """The C xxhash64 against the canonical digests."""
    assert native.xxhash64(b"") == 0xEF46DB3751D8E999
    assert native.xxhash64(b"a") == 0xD24EC4F1A98C6E5B
    assert native.xxhash64(b"abc") == 0x44BC2CF5AD770999
    h = native.xxhash64(b"0123456789abcdefghijklmnopqrstuvwxyz")
    assert isinstance(h, int) and h != 0


def test_disk_tier_uses_native(tmp_path):
    """The memory runtime's disk tier round-trips through the native
    block format, and the file is a native block either package reads."""
    from spark_rapids_tpu_torch.columnar.device import (fetch_result_batch,
                                                     to_device)
    from spark_rapids_tpu_torch.columnar.host import from_pydict
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.runtime.memory import MemoryBudget, Spillable
    conf = TpuConf({"spark.rapids.tpu.memory.tpu.budgetBytes": 1 << 20,
                    "spark.rapids.tpu.sql.shape.minBucketRows": 256})
    budget = MemoryBudget(conf, torch.device("cpu"))
    hb = from_pydict({"x": list(range(500)),
                      "s": [f"v{i % 9}" for i in range(500)]})
    before = hb.to_pydict()
    sp = Spillable(to_device(hb, conf, device="cpu"), budget)
    sp.spill()
    sp.to_disk()
    assert sp._path is not None and sp._path.endswith(".blk")
    payload = JN.spill_read(sp._path)          # the reference's reader
    assert len(payload) == budget.metrics["disk_bytes"]
    back = fetch_result_batch(sp.get())
    assert back.to_pydict() == before
    sp.close()


def test_shuffle_block_bad_offset_clean_error(tmp_path):
    path = str(tmp_path / "x.dat")
    w = native.ShuffleBlockWriter(path)
    off = w.append(b"payload" * 10)
    w.close()
    with pytest.raises(IOError):
        native.read_shuffle_block(path, off + 8)   # misaligned offset
    with pytest.raises(IOError):
        native.read_shuffle_block(path, 10**6)     # beyond EOF


@pytest.mark.parametrize("size", [0, 1, 31, 32, 4096, 100_003])
def test_blocks_cross_between_the_packages(tmp_path, size):
    data = np.random.default_rng(size).bytes(size)
    a, b = str(tmp_path / "port.blk"), str(tmp_path / "ref.blk")
    native.spill_write(a, data)
    JN.spill_write(b, data)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert JN.spill_read(a) == data
    assert native.spill_read(b) == data
    w = native.ShuffleBlockWriter(str(tmp_path / "s.dat"))
    off = w.append(data)
    w.close()
    assert JN.read_shuffle_block(str(tmp_path / "s.dat"), off) == data


def test_xxhash64_equals_the_reference_s_over_random_buffers():
    rng = np.random.default_rng(5)
    lib = JN._load()
    for n in list(range(0, 70)) + [1000, 4099, 65537]:
        buf = rng.bytes(n)
        for seed in (0, 1, 2 ** 63 + 5):
            assert native.xxhash64(buf, seed) == \
                lib.spill_xxhash64(buf, n, seed), (n, seed)


def test_disk_tier_checksum_and_truncation(tmp_path):
    from spark_rapids_tpu_torch.runtime import memory as M
    lanes = [torch.arange(10, dtype=torch.int64),
             torch.ones(10, dtype=torch.bool)]
    path = str(tmp_path / "b.blk")
    assert M.write_block(path, lanes) == 90
    assert native.spill_read(path) == b"".join(
        x.numpy().tobytes() for x in lanes)
    raw = bytearray(open(path, "rb").read())
    raw[M._HEADER.size + 3] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(M.CorruptBlockError, match="checksum"):
        M.read_block(path, [(torch.int64, 10), (torch.bool, 10)])
    M.write_block(path, lanes)
    with pytest.raises(M.CorruptBlockError, match="malformed"):
        M.read_block(path, [(torch.int64, 11), (torch.bool, 10)])


def test_a_failed_build_raises(tmp_path, monkeypatch):
    # no pure-Python stand-in: a library that does not compile raises
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setitem(native._SIGNATURES, "broken", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library("broken")
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith(".so")]
