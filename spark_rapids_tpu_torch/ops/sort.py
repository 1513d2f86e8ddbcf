"""Multi-key sort (the cuDF Table.orderBy analogue).

Counterpart of spark_rapids_tpu/ops/sort.py.  Every key column maps to
*order lanes* whose ascending order is the requested logical order, and
chained stable `torch.sort` calls — least significant lane first,
liveness last — produce the permutation:

  * ints/dates/decimals/bools: the lane is the value itself;
  * float/double: a NaN lane above the value lane (Spark orders NaN
    greatest), -0.0 and 0.0 equal;
  * strings: dictionary codes, which ARE ranks for the sorted host
    dictionaries, else a host rank table (`dictionary_ranks`);
  * nulls-first/last: a null lane ahead of the value lanes;
  * padding rows always sink to the end (liveness is the primary lane).

Descending keys sort their value lanes with `descending=True`, which
keeps the chain stable.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn
from ..config import DEFAULT_CONF, TpuConf
from ..runtime.capture import host_constant


class SortKey(NamedTuple):
    """Ordering spec for one key column (Spark SortOrder analogue)."""
    col_index: int
    ascending: bool = True
    nulls_first: bool = True     # Spark default: NULLS FIRST for ASC


def dictionary_ranks(dictionary: Optional[np.ndarray]) -> np.ndarray:
    """ranks[code] = position of the code's string in the sorted
    dictionary (code point order, Spark's string order)."""
    if dictionary is None or len(dictionary) == 0:
        return np.zeros(1, np.int32)
    order = np.argsort(np.asarray(dictionary, str), kind="stable")
    ranks = np.empty(len(dictionary), np.int32)
    ranks[order] = np.arange(len(dictionary), dtype=np.int32)
    return ranks


def order_lanes(col: DeviceColumn, asc: bool, nulls_first: bool,
                policy=None) -> List[Tuple[torch.Tensor, bool]]:
    """(lane, descending) pairs, most significant first, for one key.
    Every value lane is zero under the null lane, so null rows tie on
    this key whatever their storage holds (Spark: nulls are equal).  A
    string orders by its codes where they are ranks (an ordered
    dictionary) and the encoded policy (ops/encodings.EncodingPolicy)
    has `dict.sortOnScan`: the `sort_codes` dispatch; else by a rank
    table gathered by code (a decode)."""
    from .encodings import count_decode, count_dispatch, is_ordered_dict
    enabled = policy is not None and policy.enabled
    codes_ok = enabled and policy.dict_sort_scan
    data = col.data
    valid = col.validity
    null = torch.where(valid, torch.ones_like(valid, dtype=torch.int8),
                       torch.zeros_like(valid, dtype=torch.int8))
    null_lane = (null if nulls_first else 1 - null, False)
    if isinstance(col.dtype, t.StringType):
        d = col.dictionary
        if codes_ok and is_ordered_dict(d):
            count_dispatch("sort_codes")
        elif d is not None and len(d) > 1:
            ranks = host_constant(dictionary_ranks(d), data.device)
            data = ranks[torch.clamp(data, 0, len(d) - 1).to(torch.int64)]
            if enabled:
                count_decode("sort", data.numel() * 4)
        return [null_lane, (torch.where(valid, data, torch.zeros_like(data)),
                            not asc)]
    if data.dtype.is_floating_point:
        # NaN greatest via its own lane; -0.0 and 0.0 compare equal (the
        # reference's value-ordered f64 lanes).  +0.0 turns -0.0 into 0.0
        # so the card's radix sort cannot tell them apart either.
        isnan = torch.isnan(data) & valid
        value = torch.where(isnan | ~valid, torch.zeros_like(data),
                            data) + 0.0
        return [null_lane, (isnan.to(torch.int8), not asc),
                (value, not asc)]
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if col.hi is not None:
        # a two-lane DECIMAL: the signed high word, then the low word in
        # unsigned order (its sign bit flipped)
        zero = torch.zeros_like(data)
        return [null_lane, (torch.where(valid, col.hi, zero), not asc),
                (torch.where(valid, data ^ (-2 ** 63), zero), not asc)]
    return [null_lane, (torch.where(valid, data, torch.zeros_like(data)),
                        not asc)]


def sort_permutation(db: DeviceBatch, keys: Sequence[SortKey],
                     conf: TpuConf = DEFAULT_CONF) -> torch.Tensor:
    """int64 permutation putting live rows in key order, padding last."""
    # most significant first: liveness, then each key's lanes
    from .encodings import encoding_policy
    pol = encoding_policy(conf)
    lanes: List[Tuple[torch.Tensor, bool]] = [
        ((~db.row_mask()).to(torch.int8), False)]
    for k in keys:
        lanes.extend(order_lanes(db.columns[k.col_index], k.ascending,
                                 k.nulls_first, pol))
    perm = torch.arange(db.capacity, device=db.device)
    for lane, desc in reversed(lanes):
        step = torch.sort(lane[perm], stable=True, descending=desc).indices
        perm = perm[step]
    return perm


def permute_batch(db: DeviceBatch, perm: torch.Tensor) -> DeviceBatch:
    """Gather every lane of every column through a row permutation."""
    cols = [c.take(perm) for c in db.columns]
    return DeviceBatch(cols, db.num_rows, list(db.names))


def sort_batch(db: DeviceBatch, keys: Sequence[SortKey],
               conf: TpuConf = DEFAULT_CONF) -> DeviceBatch:
    """Fully sort one device batch by the given keys (a sink of a thin or
    masked join output: it resolves to a row prefix first)."""
    from .batch_ops import ensure_prefix
    db = ensure_prefix(db, conf)
    db.assert_prefix()
    return permute_batch(db, sort_permutation(db, keys, conf))
