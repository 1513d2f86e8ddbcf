"""Bloom-filter runtime join filtering.

Counterpart of spark_rapids_tpu/ops/bloom.py (the role of the
reference's BloomFilter JNI kernel with bloom_filter_agg /
bloom_filter_might_contain; Spark's InjectRuntimeFilter inserts them
around large shuffled joins).  The adaptive join (exec/adaptive.py)
installs it: the build side is fully materialized when the probe side
replays, so the filter costs one scatter pass over the build keys and
one gather pass a probe batch.

The bitset is a bool tensor of m slots (a power of two, at most 2^22:
4 MiB).  Hashing reuses the engine's row hash
(`exec/plan._agg_partition_ids`, bit-equal to the reference's, so equal
keys hash equal across batches, sides and spills) with salts 11 and 23
for the double hashing h1 + i * h2 of the k probes.

A false positive only admits a probe row the join then drops; a probe
row whose key is in the build side always passes, because every live
build row sets its bits.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..columnar.device import DeviceBatch, DeviceColumn

DEFAULT_FPP = 0.03
_MIN_SLOTS = 1 << 10
_MAX_SLOTS = 1 << 22


def optimal_slots(n_items: int, fpp: float = DEFAULT_FPP) -> int:
    """Bloom sizing (-n ln p / ln^2 2), rounded up to a power of two in
    [2^10, 2^22]."""
    n = max(1, n_items)
    m = int(-n * math.log(fpp) / (math.log(2) ** 2))
    return max(_MIN_SLOTS, min(_MAX_SLOTS, 1 << max(1, m - 1).bit_length()))


def optimal_hashes(n_items: int, m_slots: int) -> int:
    k = int(round(m_slots / max(1, n_items) * math.log(2)))
    return max(1, min(6, k))


def _double_hashes(key_cols: Sequence[DeviceColumn], db: DeviceBatch,
                   m_slots: int):
    """(h1 in [0, m), h2 in [1, m)) int64: two decorrelated row hashes."""
    from ..exec.plan import _agg_partition_ids
    kb = DeviceBatch(list(key_cols), db.num_rows,
                     [f"_k{i}" for i in range(len(key_cols))])
    h1 = _agg_partition_ids(kb, len(key_cols), m_slots, salt=11)
    h2 = _agg_partition_ids(kb, len(key_cols), m_slots - 1, salt=23)
    return h1.to(torch.int64), h2.to(torch.int64) + 1


def bloom_build(key_cols: Sequence[DeviceColumn], db: DeviceBatch,
                m_slots: int, k: int, bits: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Set the k slots of every row's key; pass `bits` to accumulate over
    several build batches.  `live` masks rows out of the insertion (the
    fused build-side filters): their keys would only widen the filter,
    losing the selectivity the build filter gives it.  The masked rows
    write to one spare slot past the bitset, which is cut off."""
    h1, h2 = _double_hashes(key_cols, db, m_slots)
    out = torch.zeros(m_slots + 1, dtype=torch.bool, device=h1.device)
    if bits is not None:
        out[:m_slots] = bits
    for i in range(k):
        idx = (h1 + i * h2) % m_slots
        if live is not None:
            idx = torch.where(live, idx, torch.full_like(idx, m_slots))
        out[idx] = True
    return out[:m_slots]


def bloom_might_contain(bits: torch.Tensor, key_cols: Sequence[DeviceColumn],
                        db: DeviceBatch, k: int) -> torch.Tensor:
    """Bool per row: False only where the key is certainly absent from
    the build side."""
    m_slots = bits.shape[0]
    h1, h2 = _double_hashes(key_cols, db, m_slots)
    out = torch.ones(db.capacity, dtype=torch.bool, device=h1.device)
    for i in range(k):
        out &= bits[(h1 + i * h2) % m_slots]
    return out
