"""Hash-table equi-join on Hopper: murmur3 open addressing, the kernel
wrappers and their plain PyTorch versions.

Counterpart of spark_rapids_tpu/ops/pallas/hashjoin.py (its module
docstring gives the layout).  In short: a build lane's rows sort by
(dead, fmix64 hash) — fmix64 is a bijection, so equal hashes mean
equal keys — and row i of that order lands in slot
i + prefix_max(ideal - i) of a table of S = 2^nbits home slots plus a
cap-slot overflow tail; equal keys sit in consecutive slots in
ascending build-row order.  A slot is 16 bytes of one int64[span, 2]
buffer: the key at byte 0, the build row as int32 at byte 8 (-1 =
empty, whose key is 0) and zero at byte 12, so the kernels read a slot
in one 16-byte load.  The reference keeps two arrays, `keys` and
`rows`; `HashTable.keys` and `HashTable.rows` are strided views of the
buffer that equal them.

  * `build_table` replaces `_build_trace` (hashjoin.py:111).  The
    hash-order sort stays in PyTorch, as the reference computes it
    outside its kernel; the kernel is the layout (`build_layout`), in
    two launches that write every slot once (no fill of the buffer).
  * `probe_first` replaces `_probe_first_trace` (hashjoin.py:182): per
    probe row the first build row with an equal key, -1 and False when
    there is none, in one launch that walks only the valid rows.
    `probe_matched` is its `ok` lane.
  * `probe_counts` replaces `_probe_counts_trace` (hashjoin.py:253): per
    probe row the first table slot of its key's run and the run's
    length, and their int32 inclusive prefix sum `cum`, all three from
    one launch (a decoupled look-back scan inside the kernel; the plain
    version takes `inclusive_cumsum`).
  * `expand_pairs` replaces `_expand_trace` (hashjoin.py:324): per
    output slot of a sized expansion its probe row, build row and
    liveness, in the reference's pair order (probe-major, build rows
    ascending within a key), in one launch: a merge path of the slots
    against `cum` in place of the reference's search a slot.  `total`
    is a host int here.
  * `build_matched_flags` (hashjoin.py:373, jnp in the reference, not a
    Pallas kernel) is plain PyTorch: per build row, whether a counted
    probe run covers its slot (right and full outer joins).

Unsigned 64-bit arithmetic runs on int64 tensors (torch has no usable
uint64 on CUDA): constants as their signed images, logical right shifts
as `(x >> s) & (2^(64-s) - 1)`, unsigned order as `h ^ INT64_MIN`.

The kernels are hand-written CUDA (csrc/hashjoin.cu; the design and
what bounds them are noted there).  A wrapper given CUDA tensors checks
them, allocates outputs and scratch, launches on PyTorch's current
stream and raises if the launch fails; given CPU tensors it runs the
plain version.  Nothing falls back from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from ..segments import lexsort_capped
from . import (LAUNCHES, check_launch, library, mask_tiles, stream_ptr,
               stream_scratch)

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "hashjoin_build_layout": [_VP, _VP, _VP, _LL, _VP, _LL, _VP, _I, _I,
                              _VP, _VP, ctypes.c_uint, _VP],
    "hashjoin_probe_first": [_VP, _LL, _I, _VP, _VP, _LL, _I, _I, _VP, _VP,
                             _VP],
    "hashjoin_probe_counts": [_VP, _LL, _I, _VP, _VP, _LL, _I, _I, _VP, _VP,
                              _VP, _VP, _VP, ctypes.c_uint, _VP],
    "hashjoin_expand_pairs": [_VP, _LL, _VP, _VP, _VP, _LL, _LL, _LL, _VP,
                              _VP, _VP, _VP],
}

INT64_MIN = -(1 << 63)
_FMIX1 = 0xFF51AFD7ED558CCD - (1 << 64)     # signed images of the
_FMIX2 = 0xC4CEB9FE1A85EC53 - (1 << 64)     # fmix64 constants
_CARRY_SEED = -(1 << 31) + 1
#: rows of one look-back tile of build_layout's scan of the finals, and
#: the slots of one chunk of its slot pass (csrc/hashjoin.cu
#: kFinalTileRows, kChunkSlots): the wrapper sizes its scratch with them
FINAL_TILE_ROWS = 4096
CHUNK_SLOTS = 2048
#: probe rows of one look-back tile of probe_counts (csrc/hashjoin.cu
#: kProbeTileRows: 256 threads, 16 rows each)
PROBE_TILE_ROWS = 4096
#: probe rows of one tile of probe_first (kFirstTileRows: 128 threads,
#: 16 rows each)
FIRST_TILE_ROWS = 2048
#: the second int64 of an empty slot: row -1 at byte 8, zero at byte 12
EMPTY_ROW_WORD = 0xFFFFFFFF
#: an empty slot's 16 bytes as one complex128: the real part's bits are
#: key 0, the imaginary part's the row word (a subnormal double)
_EMPTY_SLOT = complex(0.0, struct.unpack("<d", struct.pack(
    "<q", EMPTY_ROW_WORD))[0])


def _fn(name: str):
    f = getattr(library("hashjoin"), name)
    if f.argtypes is None:
        f.argtypes = _SIGNATURES[name]
        f.restype = _I
    return f


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix64 over int64 lanes, as the uint64 result's bits."""
    x = x.to(torch.int64)
    x = (x ^ _shr(x, 33)) * _FMIX1
    x = (x ^ _shr(x, 33)) * _FMIX2
    return x ^ _shr(x, 33)


def empty_slots(span: int, device) -> torch.Tensor:
    """A slot buffer of `span` empty slots (key 0, row -1), for the plain
    layout: one fill of a complex128 lane whose bits are the empty
    slot's."""
    return torch.empty(span, dtype=torch.complex128, device=device) \
        .fill_(_EMPTY_SLOT).view(torch.int64).view(span, 2)


def slot_views(slots: torch.Tensor):
    """(keys int64[span], rows int32[span]): strided views of the key and
    the build row of every slot of a slot buffer."""
    return slots[:, 0], slots.view(torch.int32)[:, 2]


class HashTable:
    """slots: int64[span, 2], one 16-byte slot each (module docstring);
    nbits: home-slot width (S = 1 << nbits); span: physical slots (S +
    build capacity).  `keys[s]` is the key at slot s (meaningful only
    where rows[s] >= 0), `rows[s]` its build row id, -1 = empty.

    `HashTable(keys, rows, nbits, span)` interleaves two arrays into a
    new buffer; `HashTable.of_slots` takes a buffer as it is."""
    __slots__ = ("slots", "nbits", "span", "_runs")

    def __init__(self, keys: torch.Tensor, rows: torch.Tensor, nbits: int,
                 span: int):
        slots = torch.zeros((span, 2), dtype=torch.int64,
                            device=keys.device)
        k, r = slot_views(slots)
        k.copy_(keys)
        r.copy_(rows)
        self.slots, self.nbits, self.span = slots, nbits, span
        self._runs = None

    @classmethod
    def of_slots(cls, slots: torch.Tensor, nbits: int,
                 span: int) -> "HashTable":
        table = cls.__new__(cls)
        table.slots, table.nbits, table.span = slots, nbits, span
        table._runs = None
        return table

    @property
    def keys(self) -> torch.Tensor:
        return slot_views(self.slots)[0]

    @property
    def rows(self) -> torch.Tensor:
        return slot_views(self.slots)[1]


def table_geometry(capacity: int):
    """(nbits, span) of the table over a build lane of `capacity` rows:
    load factor at most 0.5, a capacity-slot overflow tail."""
    nbits = max(4, (2 * max(capacity, 1) - 1).bit_length())
    return nbits, (1 << nbits) + capacity


def hash_order(lane: torch.Tensor, valid: torch.Tensor, nbits: int):
    """The layout's inputs in hash order: (ideal int32, key int64, build
    row int32) per sorted row.  Rows sort stably by unsigned hash, then
    stably by deadness; dead rows get ideal S and row -1."""
    h = mix64(lane)
    dead = ~valid
    perm = lexsort_capped([h ^ INT64_MIN, dead])
    hs, dead_s = h[perm], dead[perm]
    home = _shr(hs, 64 - nbits)
    ideal = torch.where(dead_s, torch.full_like(home, 1 << nbits), home)
    rid = torch.where(dead_s, torch.full_like(perm, -1), perm)
    return (ideal.to(torch.int32), lane.to(torch.int64)[perm],
            rid.to(torch.int32))


def build_layout_plain(ideal, lane_s, rid, span: int):
    """Plain version of build_layout: one cummax over the whole lane.
    Where the clip stacks rows on one slot (inputs built by hand; the
    hash order never does), the last of them keeps it, as the kernel
    does: a scatter of equal indices keeps any one."""
    i = torch.arange(ideal.numel(), dtype=torch.int64, device=ideal.device)
    prefix = torch.clamp(torch.cummax(ideal.to(torch.int64) - i, 0).values,
                         min=_CARRY_SEED)
    final = torch.clamp(i + prefix, 0, span - 1)
    last = torch.ones_like(final, dtype=torch.bool)
    last[:-1] = final[1:] != final[:-1]
    # the rows a later row displaces land on one spare slot past the end,
    # so the scatter's shape does not depend on the data
    slots = empty_slots(span + 1, ideal.device)
    keys, rows = slot_views(slots)
    dest = torch.where(last, final, torch.full_like(final, span))
    keys[dest] = lane_s
    rows[dest] = rid.to(rows.dtype)
    return slots[:span]


def build_layout(ideal, lane_s, rid, span: int):
    """The slot buffer int64[span, 2] (module docstring): row i of the
    hash order stored at clip(i + max(-2^31 + 1, prefix max of ideal -
    i), 0, span - 1).  On the card two launches write every slot once,
    so the buffer needs no fill."""
    if ideal.device.type == "cpu":
        return build_layout_plain(ideal, lane_s, rid, span)
    if ideal.device.type != "cuda":
        raise ValueError(f"build_layout: unsupported device {ideal.device}")
    cap = ideal.numel()
    for t, dt in ((ideal, torch.int32), (lane_s, torch.int64),
                  (rid, torch.int32)):
        if t.device != ideal.device or t.dtype != dt or t.dim() != 1 or \
                t.numel() != cap or not t.is_contiguous():
            raise ValueError(f"build_layout: expected contiguous {dt}[{cap}] "
                             f"on {ideal.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if cap == 0 or span < cap or span > 1 << 31:
        raise ValueError(f"build_layout: bad capacity {cap} / span {span}")
    dev = ideal.device
    slots = torch.empty((span, 2), dtype=torch.int64, device=dev)
    final = torch.empty(cap, dtype=torch.int32, device=dev)
    ntiles = -(-cap // FINAL_TILE_ROWS)
    nchunks = -(-span // CHUNK_SLOTS)
    st = stream_ptr(dev)
    status, counter, epoch = stream_scratch(dev, st).lookback(ntiles +
                                                              nchunks)
    err = _fn("hashjoin_build_layout")(
        ideal.data_ptr(), lane_s.data_ptr(), rid.data_ptr(), cap,
        final.data_ptr(), span, slots.data_ptr(), ntiles, nchunks, status,
        counter, epoch, st)
    # two device launches: the look-back scan of the finals and the
    # chunked slot pass (csrc/hashjoin.cu)
    LAUNCHES["build_table"] += 2
    check_launch(err, "build_table")
    return slots


def build_table(lane: torch.Tensor, valid: torch.Tensor) -> HashTable:
    """The hash table over one canonical int64 build lane; rows where
    `valid` is False (dead or null keys) never match."""
    nbits, span = table_geometry(lane.numel())
    ideal, lane_s, rid = hash_order(lane, valid, nbits)
    return HashTable.of_slots(build_layout(ideal, lane_s, rid, span), nbits,
                              span)


def _table_runs(table: HashTable):
    """What `_runs_sorted` reads of the table alone: (slot order, its
    occupancy, the sorted keys, each key's dense rank, the position key,
    the run numbers, the empty slots before each slot).  Kept on the
    table, keyed by its buffer and the buffer's version, so the probe
    batches of one build sort the table once."""
    slots = table.slots
    key = (slots.data_ptr(), slots._version)
    if table._runs is not None and table._runs[0] == key:
        return table._runs[1]
    dev, span = slots.device, table.span
    keys, occ = table.keys, table.rows >= 0
    top = torch.iinfo(torch.int64).max
    # the occupied slots in (key, slot) order, then the empty ones
    by_key = torch.sort(keys, stable=True).indices
    order = by_key[torch.sort((~occ[by_key]).to(torch.int8),
                              stable=True).indices]
    live = occ[order]
    skeys = torch.where(live, keys[order], torch.full_like(keys, top))
    # position key: the key's dense rank, then its slot (empties last)
    rank = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64,
                                               device=dev),
                                   (skeys[1:] != skeys[:-1]).long()]), 0)
    pos = torch.where(live, rank * (span + 1) + order,
                      torch.full_like(rank, top))
    # runs of consecutive slots of one key, numbered in position order
    start = torch.ones(span, dtype=torch.bool, device=dev)
    start[1:] = pos[1:] != pos[:-1] + 1
    run = torch.cumsum(start.to(torch.int64), 0)
    # empty slots before each slot
    empties = torch.zeros(span + 1, dtype=torch.int64, device=dev)
    empties[1:] = torch.cumsum((~occ).to(torch.int64), 0)
    out = (order, live, skeys, rank, pos, run, empties)
    table._runs = (key, out)
    return out


def _runs_sorted(table: HashTable, lane: torch.Tensor,
                 valid: torch.Tensor):
    """(first slot int64, count int64) of each probe row as the kernels'
    walk finds them (csrc/hashjoin.cu `count_run`), by sort and search:
    from the key's home slot, the first slot holding the key before an
    empty slot, then the consecutive slots that hold it; a run that
    reaches the last slot counts `home` more, the reference's re-reads
    of its clamped walk there (the layout never stores a live row in
    that slot).  No step count depends on the data, which a captured
    graph could not hold (runtime/capture.py).  (0, 0) without a
    match."""
    lane = lane.to(torch.int64)
    span = table.span
    order, live, skeys, rank, pos, run, empties = _table_runs(table)
    home = _shr(mix64(lane), 64 - table.nbits)
    lo = torch.clamp(torch.searchsorted(skeys, lane), max=span - 1)
    has = valid & (skeys[lo] == lane) & live[lo]
    p = torch.clamp(torch.searchsorted(pos, rank[lo] * (span + 1) + home),
                    max=span - 1)
    f = order[p]
    found = has & live[p] & (rank[p] == rank[lo]) & \
        (empties[f] == empties[home])
    # the run holding p ends where the next one starts
    n = torch.searchsorted(run, run[p] + 1) - p
    n = n + torch.where(order[p + n - 1] == span - 1, home,
                        torch.zeros_like(home))
    zero = torch.zeros_like(lo)
    return torch.where(found, f, zero), torch.where(found, n, zero)


def probe_first_plain(table: HashTable, lane: torch.Tensor,
                      valid: torch.Tensor):
    """Plain version of probe_first: each row's run by `_runs_sorted`,
    its first slot's build row (-1 without one)."""
    first, n = _runs_sorted(table, lane, valid)
    row = table.rows[first]
    row = torch.where(n > 0, row, torch.full_like(row, -1))
    return row, row >= 0


def _check_table(kernel: str, table: HashTable, device) -> None:
    """Raise unless the table is a contiguous slot buffer of its span on
    `device`."""
    s = table.slots
    if s.device != device or s.dtype != torch.int64 or \
            s.shape != (table.span, 2) or not s.is_contiguous():
        raise ValueError(f"{kernel}: the table is not a contiguous "
                         f"int64[{table.span}, 2] slot buffer on {device}")


def _check_probe(kernel: str, table: HashTable, lane: torch.Tensor,
                 valid: torch.Tensor) -> int:
    """Raise unless a CUDA probe's inputs are what its kernel takes;
    returns the probe capacity."""
    cap = lane.numel()
    if lane.dtype != torch.int64 or valid.dtype != torch.bool or \
            lane.dim() != 1 or valid.shape != lane.shape or \
            not lane.is_contiguous() or not valid.is_contiguous() or \
            valid.device != lane.device or cap == 0:
        raise ValueError(f"{kernel}: lane must be contiguous int64[n] and "
                         "valid contiguous bool[n] on one device, n > 0")
    _check_table(kernel, table, lane.device)
    return cap


def probe_first(table: HashTable, lane: torch.Tensor, valid: torch.Tensor):
    """(build row int32, found bool) per probe row: the first build row
    (ascending row id) whose key equals the probe lane, -1 where none
    does or the probe row is not valid."""
    if lane.device.type == "cpu":
        return probe_first_plain(table, lane, valid)
    if lane.device.type != "cuda":
        raise ValueError(f"probe_first: unsupported device {lane.device}")
    cap = _check_probe("probe_first", table, lane, valid)
    row = torch.empty(cap, dtype=torch.int32, device=lane.device)
    ok = torch.empty(cap, dtype=torch.bool, device=lane.device)
    mis, tiles = mask_tiles(valid.data_ptr(), cap, FIRST_TILE_ROWS)
    err = _fn("hashjoin_probe_first")(
        table.slots.data_ptr(), table.span, table.nbits, lane.data_ptr(),
        valid.data_ptr(), cap, mis, tiles, row.data_ptr(), ok.data_ptr(),
        stream_ptr(lane.device))
    LAUNCHES["probe_first"] += 1
    check_launch(err, "probe_first")
    return row, ok


def probe_matched(table: HashTable, lane: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Per probe row matched flag (semi/anti joins): probe_first's `ok`
    lane."""
    return probe_first(table, lane, valid)[1]


def probe_counts_plain(table: HashTable, lane: torch.Tensor,
                       valid: torch.Tensor):
    """Plain version of the probe_counts kernel, (first, counts): the
    slot where each row's run starts (0 without one) and its count, by
    `_runs_sorted`."""
    first, n = _runs_sorted(table, lane, valid)
    return first.to(torch.int32), n.to(torch.int32)


def inclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    """int32 inclusive prefix sum of a 1-D count lane (the reference's
    `blocked_cumsum`); 1-D, so the card runs it through cub."""
    return torch.cumsum(counts, 0, dtype=torch.int32)


def probe_counts(table: HashTable, lane: torch.Tensor, valid: torch.Tensor):
    """(first int32, counts int32, cum int32) per probe row: the table slot
    where the probe key's run of matches starts (0 without one), the
    run's length (0 for invalid or unmatched rows) and the inclusive
    prefix sum of the lengths.  On the card the three are views of one
    buffer."""
    if lane.device.type == "cpu":
        first, counts = probe_counts_plain(table, lane, valid)
        return first, counts, inclusive_cumsum(counts)
    if lane.device.type != "cuda":
        raise ValueError(f"probe_counts: unsupported device {lane.device}")
    cap = _check_probe("probe_counts", table, lane, valid)
    dev = lane.device
    mis, tiles = mask_tiles(valid.data_ptr(), cap, PROBE_TILE_ROWS)
    # each output starts 16-byte aligned, for the kernel's vector stores
    pad = -(-cap // 4) * 4
    out = torch.empty(3 * pad, dtype=torch.int32, device=dev)
    first, counts, cum = (out[i * pad:i * pad + cap] for i in range(3))
    st = stream_ptr(dev)
    status, counter, epoch = stream_scratch(dev, st).lookback(tiles)
    err = _fn("hashjoin_probe_counts")(
        table.slots.data_ptr(), table.span, table.nbits, lane.data_ptr(),
        valid.data_ptr(), cap, mis, tiles,
        first.data_ptr(), counts.data_ptr(), cum.data_ptr(), status,
        counter, epoch, st)
    # one device launch: the walks and the scan of their counts
    LAUNCHES["probe_counts"] += 1
    check_launch(err, "probe_counts")
    return first, counts, cum


def search_rounds(pcap: int) -> int:
    """Binary-search rounds over a probe capacity (the reference's, and
    the plain version's)."""
    return max(1, (max(pcap, 1) - 1).bit_length() + 1)


def expand_pairs_plain(table: HashTable, first: torch.Tensor,
                       counts: torch.Tensor, cum: torch.Tensor,
                       out_cap: int, total: int):
    """Plain version of the expand_pairs kernel: the vectorized binary
    search of every output slot's probe row, then one gather of its
    build row."""
    dev = first.device
    pcap = first.numel()
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    tgt = j + 1
    lo = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    hi = torch.full((out_cap,), pcap, dtype=torch.int64, device=dev)
    cum64 = cum.to(torch.int64)
    for _ in range(search_rounds(pcap)):
        mid = torch.clamp((lo + hi) // 2, max=pcap - 1)
        go_hi = cum64[mid] < tgt
        lo, hi = torch.where(go_hi, mid + 1, lo), torch.where(go_hi, hi, mid)
    p = torch.clamp(lo, max=pcap - 1)
    start = cum64[p] - counts.to(torch.int64)[p]
    pos = torch.clamp(first.to(torch.int64)[p] + (j - start), 0,
                      table.span - 1)
    live = j < total
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    probe_idx = torch.where(live, p, zero).to(torch.int32)
    build_idx = torch.where(live, torch.clamp(table.rows[pos], min=0)
                            .to(torch.int64), zero).to(torch.int32)
    return probe_idx, build_idx, live


def expand_pairs(table: HashTable, first: torch.Tensor, counts: torch.Tensor,
                 cum: torch.Tensor, out_cap: int, total: int):
    """(probe_idx int32, build_idx int32, ok bool) at `out_cap` slots for
    the `total` pairs that probe_counts sized: slot j < total pairs the
    probe row whose run covers j with the build row at its run position;
    slots past `total` are (0, 0, False)."""
    if first.device.type == "cpu":
        return expand_pairs_plain(table, first, counts, cum, out_cap, total)
    if first.device.type != "cuda":
        raise ValueError(f"expand_pairs: unsupported device {first.device}")
    pcap = first.numel()
    for t in (first, counts, cum):
        if t.device != first.device or t.dtype != torch.int32 or \
                t.dim() != 1 or t.numel() != pcap or not t.is_contiguous():
            raise ValueError(f"expand_pairs: expected contiguous int32[{pcap}]"
                             f" on {first.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if pcap == 0 or out_cap <= 0 or not 0 <= total <= out_cap:
        raise ValueError(f"expand_pairs: bad probe capacity {pcap}, output "
                         f"capacity {out_cap} or total {total}")
    _check_table("expand_pairs", table, first.device)
    dev = first.device
    probe_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    build_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    ok = torch.empty(out_cap, dtype=torch.bool, device=dev)
    err = _fn("hashjoin_expand_pairs")(
        table.slots.data_ptr(), table.span, first.data_ptr(),
        counts.data_ptr(), cum.data_ptr(), pcap, total, out_cap,
        probe_idx.data_ptr(), build_idx.data_ptr(), ok.data_ptr(),
        stream_ptr(dev))
    LAUNCHES["expand_pairs"] += 1
    check_launch(err, "expand_pairs")
    return probe_idx, build_idx, ok


def build_matched_flags(table: HashTable, first: torch.Tensor,
                        counts: torch.Tensor,
                        build_capacity: int) -> torch.Tensor:
    """Per build row, whether some counted probe run covers its slot
    (right and full outer joins), without the expanded pairs: +1 at each
    run's first slot and -1 past its end, a prefix sum > 0 marks covered
    slots, and the table's row lane carries them to build rows.  The
    reference's `.at[].add(mode="drop")` drops index span + 1; here the
    delta lane has one spare slot that takes those adds and is never
    read, and the flags scatter into one spare row that is cut off."""
    span = table.span
    dev = first.device
    has = counts > 0
    first = first.to(torch.int64)
    ends = first + counts.to(torch.int64)
    spare = torch.full_like(first, span + 1)
    delta = torch.zeros(span + 2, dtype=torch.int32, device=dev)
    ones = torch.ones_like(counts)
    delta.index_add_(0, torch.where(has, first, spare), ones)
    delta.index_add_(0, torch.where(has & (ends <= span), ends, spare), -ones)
    occ = inclusive_cumsum(delta[:span]) > 0
    tgt = torch.where(occ & (table.rows >= 0), table.rows.to(torch.int64),
                      torch.full_like(first[:1], build_capacity))
    flags = torch.zeros(build_capacity + 1, dtype=torch.bool, device=dev)
    flags[tgt] = True
    return flags[:build_capacity]
