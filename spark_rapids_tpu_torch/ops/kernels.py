"""The port's hand-written kernels and their plain versions (counterpart of
the JAX package's ``ops/pallas_kernels.py``, with its torch function over
B3, ``hash_group_ids``).

All eight of the JAX package's Pallas kernels have a counterpart here:

  * ``compact_permutation`` (B1; TPU kernel ``_dual_prefix_kernel``): the
    stable-partition permutation of a keep mask, run by every filter, every
    fused concat and every aggregate slot compaction. CUDA source
    ``csrc/compact.cu``.
  * ``hash_grouped_aggregate`` (B2; TPU kernel ``_hash_agg_kernel``): the
    one-pass open-addressing group-by. CUDA source ``csrc/hash_agg.cu``.
  * ``hash_table_build`` (B3; TPU kernel ``_hash_build_kernel``) and
    ``hash_table_probe`` (B4; TPU kernel ``_hash_probe_kernel``): the hash
    join's table build and read-only probe, composed by
    ``hash_join_probe``. CUDA source ``csrc/hash_join.cu``.
  * the device Parquet decode (``ops/parquet_decode.py``), CUDA source
    ``csrc/parquet_decode.cu``: ``hybrid_expand`` (B5;
    ``_hybrid_expand_kernel``) expands RLE/bit-packed hybrid streams
    (definition levels, dictionary indices, PLAIN booleans), and
    ``hybrid_expand_many`` a row group's hybrid streams in one launch;
    ``delta_unpack`` (B6; ``_delta_unpack_kernel``) decodes a whole
    DELTA_BINARY_PACKED column chunk, its pages as segments, and
    ``delta_unpack_many`` a row group's DELTA chunks in one launch;
    ``plain_fixed`` (B7; ``_plain_fixed_kernel``) re-blocks PLAIN words
    into i32/i64/f32/f64/bool, and ``plain_fixed_many`` decodes a row
    group's PLAIN streams in one launch; ``slab_pack`` (B8;
    ``_slab_pack_kernel``) packs PLAIN byte arrays into char slabs.

Each public function takes the kernel's plain PyTorch version for a tensor
that lies on the CPU, and launches the CUDA kernel for a CUDA tensor, or
raises: there is no switch and no fallback. The plain versions
(``*_plain``) copy the JAX package's jnp twins (``_dual_prefix_jnp``,
``_hash_build_jnp``, ``_hash_probe_jnp``, ``_hash_agg_jnp``,
``_hybrid_expand_jnp``, ``_delta_unpack_jnp``, ``_plain_fixed_jnp``,
``_slab_pack_jnp``) and are the yardstick the kernels are held to on the
card. The three hash kernels share
the plain versions' hash and slot chain but claim slots in another order,
so their outputs compare by key, not by slot. ``LAUNCHES`` counts kernel
launches per wrapper, exactly under concurrent threads (one lock); a
launch of the pre-warm pass (``serving/prewarm.py``, inside
``prewarm_launches()``) counts in ``PREWARM_LAUNCHES`` instead. With the
fleet's warm manifest on (``obs/compilecache.py``) each wrapper's first
launch of a signature in the process is recorded there with its
arguments' spec (``utils/argspec.py``): B1-B4 and B8 replay on zero-filled
all-invalid inputs; the decode wrappers B5-B7, whose descriptor tables
cannot be made up, are recorded without one.

64-bit key images are int64 tensors holding uint64 bit patterns (see
ops/hashing.py). The decode kernels take the encoded streams as int32
tensors holding the uint32 words, and slabs are int64 tensors holding the
uint64 words: torch has no general unsigned 32/64-bit arithmetic, so the
plain versions widen words to int64 and mask them with 0xFFFFFFFF.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.obs.compilecache import SHARED as COMPILE_CACHE
from spark_rapids_tpu_torch.ops import cudalib
from spark_rapids_tpu_torch.ops.hashing import as_signed, splitmix64

LAUNCHES: Dict[str, int] = {"compact_permutation": 0,
                            "hash_grouped_aggregate": 0,
                            "hash_table_build": 0,
                            "hash_table_probe": 0,
                            "hybrid_expand": 0,
                            "delta_unpack": 0,
                            "plain_fixed": 0,
                            "slab_pack": 0}


# the pre-warm pass's launches, apart from the main path's
PREWARM_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
_COUNT_LOCK = threading.Lock()
_TLS = threading.local()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def prewarm_launches():
    """Count this thread's launches in ``PREWARM_LAUNCHES`` (and record
    none in the warm manifest) for the duration."""
    prev = getattr(_TLS, "prewarm", False)
    _TLS.prewarm = True
    try:
        yield
    finally:
        _TLS.prewarm = prev


def _launched(name: str, fn: str, library: str,
              args: Optional[tuple]) -> None:
    """One launch of kernel ``name`` by wrapper ``fn``: its count, and its
    record in the warm manifest where that is on (``args`` None: not
    replayable)."""
    if getattr(_TLS, "prewarm", False):
        with _COUNT_LOCK:
            PREWARM_LAUNCHES[name] += 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    if COMPILE_CACHE.warm_manifest_path:
        COMPILE_CACHE.note_launch(name, fn, library, args)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, got {t.device}")


def _stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``, without
    building a Python Stream object (the call Triton makes)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# B1: stream compaction
# ---------------------------------------------------------------------------

def compact_permutation_plain(keep: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``compact_permutation`` (the jnp twin's two
    cumsums plus the destination scatter)."""
    n = keep.shape[0]
    k = keep.to(torch.int32)
    incl = torch.cumsum(k, 0, dtype=torch.int32)
    kept_ex = incl - k
    total = incl[-1] if n else torch.zeros((), dtype=torch.int32,
                                           device=keep.device)
    idx = torch.arange(n, dtype=torch.int32, device=keep.device)
    dead_ex = idx - kept_ex
    dest = torch.where(keep, kept_ex, total + dead_ex)
    perm = torch.empty(n, dtype=torch.int32, device=keep.device)
    perm[dest.long()] = idx
    return perm, total


# rows per B1 tile (csrc/compact.cu kTile)
COMPACT_TILE_ROWS = 4096
# B1's ticket counters, one zeroed int32 per (device, stream), kept: the
# last count block of a call resets its ticket for the next call
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def compact_permutation(keep: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition permutation: kept row indices first (in order), then
    the rest. Returns (perm int32 (n,), kept_total int32 0-d); on the card
    both are views of one allocation with the kernel's tile scratch."""
    if keep.is_cpu:
        return compact_permutation_plain(keep)
    _require_cuda(keep, "compact_permutation")
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(f"compact_permutation takes a 1-d bool mask, got "
                        f"{keep.dtype} {tuple(keep.shape)}")
    n = keep.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"compact_permutation: {n} rows exceed int32")
    lib = cudalib.load("compact")
    keep = keep.contiguous()
    dev = keep.device
    stream = _stream(dev)
    ticket = _TICKETS.get((dev.index, stream))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = ticket
    ntiles = max(1, -(-n // COMPACT_TILE_ROWS))
    # [perm (n) | total | tile counts (ntiles) | tile offsets (ntiles)]
    buf = torch.empty(n + 1 + 2 * ntiles, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    tiles = base + 4 * (n + 1)
    err = lib.srt_compact_permutation(
        keep.data_ptr(), n, tiles, tiles + 4 * ntiles, base + 4 * n,
        ticket.data_ptr(), base, stream)
    cudalib.check(lib, err, "compact_permutation")
    _launched("compact_permutation", "compact_permutation", "compact",
              (keep,))
    return buf[:n], buf[n]


# ---------------------------------------------------------------------------
# Open-addressing hash tables
# ---------------------------------------------------------------------------

_HASH_SEED = as_signed(0x243F6A8885A308D3)


def hash_table_size(capacity: int) -> int:
    """Power-of-two table size at load factor <= 1/2."""
    t = 16
    while t < 2 * max(int(capacity), 1):
        t <<= 1
    return t


def _check_keys(images: Sequence[torch.Tensor], valid: torch.Tensor,
                max_keys: int, what: str) -> None:
    if not 0 < len(images) <= max_keys:
        raise ValueError(f"{what}: {len(images)} key images")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise TypeError(f"{what}: valid must be a 1-d bool mask")
    n = valid.shape[0]
    dev = valid.device
    for im in images:
        if im.dtype != torch.int64 or im.shape != (n,) or im.device != dev:
            raise TypeError(f"{what}: images must be int64 (n,) on {dev}")


def _key_array(images: Sequence[torch.Tensor]) -> torch.Tensor:
    """The (k, n) key words of checked images; one image is the (1, n)
    array itself, with no stacked copy."""
    return (images[0].contiguous() if len(images) == 1
            else torch.stack(list(images)))


def _check_table_size(T: int, n: int, what: str) -> None:
    if T & (T - 1) or T <= n or T >= 1 << 31:
        raise ValueError(f"{what}: table size {T} must be a power of two "
                         f"above the {n} rows and below 2^31")


def _mix_images(images: Sequence[torch.Tensor]) -> torch.Tensor:
    h = torch.full_like(images[0], _HASH_SEED, dtype=torch.int64)
    for img in images:
        h = splitmix64(h ^ img.to(torch.int64))
    return h


def _hash_slots_plain(images: Sequence[torch.Tensor], valid: torch.Tensor,
                      table_size: int
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(slot of each valid row (invalid -> T) int64, the table's key words:
    k (T + 1,) int64 with a spill entry at T) by the jnp twin's round-based
    claiming: each round every pending row tries slot (h + probe) % T; rows
    whose slot holds their key join it, rows at an empty slot race a
    scatter-min claim (one winner per slot per round) and losers retry the
    same slot; a row at a slot holding another key advances."""
    T = table_size
    n = valid.shape[0]
    dev = valid.device
    h = _mix_images(images)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    # one spill slot at index T gives masked scatters a harmless target
    tab = [torch.zeros(T + 1, dtype=torch.int64, device=dev) for _ in images]
    occ = torch.zeros(T + 1, dtype=torch.bool, device=dev)
    slot = torch.full((n,), T, dtype=torch.int64, device=dev)
    pending = valid.clone()
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    spill = torch.full((), T, dtype=torch.int64, device=dev)
    while bool(pending.any()):
        s = (h + probe) & (T - 1)
        o = occ[s]
        eq = torch.ones(n, dtype=torch.bool, device=dev)
        for t, img in zip(tab, images):
            eq &= t[s] == img
        found = pending & o & eq
        empty = pending & ~o
        cand = torch.where(empty, s, spill)
        winner = torch.full((T + 1,), n, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(0, cand, rows, "amin")
        placed = empty & (winner[s] == rows)
        wslot = torch.where(placed, s, spill)
        for t, img in zip(tab, images):
            t[wslot] = img.to(torch.int64)
        occ[wslot] = True
        occ[T] = False
        done = found | placed
        slot = torch.where(done, s, slot)
        probe += (pending & ~done & o).to(torch.int64)
        pending &= ~done
    return slot, tab


# ---------------------------------------------------------------------------
# B3 / B4: hash join table build and probe
# ---------------------------------------------------------------------------

def hash_table_build_plain(images: Sequence[torch.Tensor],
                           valid: torch.Tensor, table_size: int):
    """Plain version of ``hash_table_build`` (the jnp twin
    ``_hash_build_jnp``: round-based claiming, then a count per slot)."""
    T = table_size
    slot, tab = _hash_slots_plain(images, valid, T)
    counts = torch.zeros(T + 1, dtype=torch.int32, device=valid.device)
    counts.index_add_(0, slot, valid.to(torch.int32))
    table = torch.stack([t[:T] for t in tab])
    return slot.to(torch.int32), None, table, counts[:T]


def hash_table_build(images: Sequence[torch.Tensor], valid: torch.Tensor,
                     table_size: int):
    """Build the open-addressing table over exact 64-bit key images (int64
    holding uint64) of the rows where ``valid``.

    Returns (slot (n,) int32 with invalid rows -> T, rank: None, table (k,
    T) int64 key words, counts (T,) int32 rows per slot). A slot is used
    where its count is above 0; the key words of an unused slot are -1 (all
    ones) on the card and 0 in the plain version. The TPU kernel's exact
    arrival rank needs its sequential insert; a parallel build has none, so
    ``rank`` is None as in the jnp twin. On the card a one-word key claims
    its slot on the key word itself, a longer key on a state word of its
    own (``csrc/hash_join.cu``)."""
    if valid.is_cpu:
        return hash_table_build_plain(images, valid, table_size)
    what = "hash_table_build"
    _require_cuda(valid, what)
    lib = cudalib.load("hash_join")
    T = table_size
    k = len(images)
    _check_keys(images, valid, lib.srt_hash_join_max_keys(), what)
    keys = _key_array(images)
    valid = valid.contiguous()
    n = valid.shape[0]
    dev = valid.device
    _check_table_size(T, n, what)
    table = torch.full((k, T), -1, dtype=torch.int64, device=dev)
    state = (torch.zeros(T, dtype=torch.int32, device=dev) if k > 1
             else None)
    # counts[T] is the kernel's scratch: rows keyed by the all-ones image
    counts = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.srt_hash_build(keys.data_ptr(), k, n, valid.data_ptr(),
                             table.data_ptr(),
                             None if state is None else state.data_ptr(), T,
                             counts.data_ptr(), slot.data_ptr(), _stream(dev))
    cudalib.check(lib, err, what)
    _launched("hash_table_build", "hash_table_build", "hash_join",
              (list(images), valid, table_size))
    return slot, None, table, counts[:T]


def hash_table_probe_plain(table: torch.Tensor, counts: torch.Tensor,
                           images: Sequence[torch.Tensor],
                           valid: torch.Tensor,
                           table_size: int) -> torch.Tensor:
    """Plain version of ``hash_table_probe`` (the jnp twin
    ``_hash_probe_jnp``: every pending row steps its chain once a round)."""
    T = table_size
    n = valid.shape[0]
    dev = valid.device
    h = _mix_images(images)
    slot = torch.full((n,), T, dtype=torch.int64, device=dev)
    pending = valid.clone()
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    while bool(pending.any()):
        s = (h + probe) & (T - 1)
        occ = counts[s] > 0
        eq = torch.ones(n, dtype=torch.bool, device=dev)
        for j, img in enumerate(images):
            eq &= table[j][s] == img
        found = pending & occ & eq
        absent = pending & ~occ  # an empty slot ends the chain
        slot = torch.where(found, s, slot)
        probe += pending.to(torch.int64)
        pending &= ~(found | absent)
    return slot.to(torch.int32)


def _probe_launch(table: torch.Tensor, counts: torch.Tensor,
                  starts, images: Sequence[torch.Tensor],
                  valid: torch.Tensor, table_size: int, what: str):
    """B4 on the card: the slot of each row (``starts`` None), or each
    row's (match count, first bperm position) (``starts`` given)."""
    _require_cuda(valid, what)
    lib = cudalib.load("hash_join")
    T = table_size
    k = len(images)
    _check_keys(images, valid, lib.srt_hash_join_max_keys(), what)
    n = valid.shape[0]
    dev = valid.device
    if (T & (T - 1) or T >= 1 << 31 or table.shape != (k, T)
            or table.dtype != torch.int64 or counts.shape != (T,)
            or counts.dtype != torch.int32 or table.device != dev
            or counts.device != dev
            or (starts is not None and (starts.shape != (T,)
                                        or starts.dtype != torch.int32
                                        or starts.device != dev))):
        raise ValueError(f"{what}: table must be int64 (k, T), counts (and "
                         "starts) int32 (T,) from hash_table_build, T a "
                         "power of two")
    keys = _key_array(images)
    valid = valid.contiguous()
    table = table.contiguous()
    counts = counts.contiguous()
    if starts is None:
        slot = torch.empty(n, dtype=torch.int32, device=dev)
        outs = (slot.data_ptr(), None, None)
    else:
        starts = starts.contiguous()
        both = torch.empty((2, n), dtype=torch.int32, device=dev)
        outs = (None, both[0].data_ptr(), both[1].data_ptr())
    err = lib.srt_hash_probe(
        table.data_ptr(), counts.data_ptr(),
        None if starts is None else starts.data_ptr(), keys.data_ptr(), k, n,
        valid.data_ptr(), T, *outs, _stream(dev))
    cudalib.check(lib, err, what)
    _launched("hash_table_probe", "hash_table_lookup", "hash_join",
              (table, counts, starts, list(images), valid, table_size))
    return slot if starts is None else (both[0], both[1])


def hash_table_probe(table: torch.Tensor, counts: torch.Tensor,
                     images: Sequence[torch.Tensor], valid: torch.Tensor,
                     table_size: int) -> torch.Tensor:
    """Slot of each probe row's key in a ``hash_table_build`` table, or
    ``table_size`` where the key is absent or the row invalid. On the card
    a chain step reads the key word first and the count only where that
    word is the all-ones fill, so the table must come from the card's
    build (unused key words all ones); the plain version reads the count
    first and takes either build's table."""
    return hash_table_lookup(table, counts, None, images, valid,
                             table_size)


class JoinTable:
    """A built join table: the B3 table and counts, each slot's first
    position in ``bperm`` (``starts``), and ``bperm``, the build rows
    grouped by slot (ascending within a slot, dead rows last)."""

    def __init__(self, table: torch.Tensor, counts: torch.Tensor,
                 starts: torch.Tensor, bperm: torch.Tensor):
        self.table = table
        self.counts = counts
        self.starts = starts
        self.bperm = bperm

    @property
    def size(self) -> int:
        return int(self.counts.shape[0])


def _placement(slot_b: torch.Tensor, counts: torch.Tensor,
               build_valid: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, bperm) of a build: each slot's first position in bperm, and
    the build rows stably sorted by slot with dead rows keyed T (the jnp
    twin's placement, :581-585)."""
    T = counts.shape[0]
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    off_key = torch.where(build_valid, slot_b, torch.full_like(slot_b, T))
    bperm = torch.sort(off_key, stable=True).indices.to(torch.int32)
    return starts, bperm


def _lookup(slot_s: torch.Tensor, counts_t: torch.Tensor,
            starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(match count, first bperm position) of every probed stream row."""
    T = counts_t.shape[0]
    hit = slot_s < T
    safe = slot_s.clamp(0, T - 1).long()
    zero = torch.zeros_like(slot_s)
    return (torch.where(hit, counts_t[safe], zero),
            torch.where(hit, starts[safe], zero))


def hash_table_lookup(table: torch.Tensor, counts: torch.Tensor,
                      starts, images: Sequence[torch.Tensor],
                      valid: torch.Tensor, table_size: int):
    """B4 in either of its forms: with ``starts`` None each row's slot
    (``hash_table_probe``), else each row's (match count, first bperm
    position) (``hash_join_lookup``): on the CPU the plain probe (then
    ``_lookup``), on the card one launch. The pre-warm replays B4
    through it."""
    if valid.is_cpu:
        slot = hash_table_probe_plain(table, counts, images, valid,
                                      table_size)
        return slot if starts is None else _lookup(slot, counts, starts)
    return _probe_launch(table, counts, starts, images, valid, table_size,
                         "hash_table_probe" if starts is None
                         else "hash_join_lookup")


def hash_join_build(build_images: Sequence[torch.Tensor],
                    build_valid: torch.Tensor,
                    table_size: int) -> JoinTable:
    """Build side of ``hash_join_probe``: B3, then the placement."""
    slot_b, _rank, table, counts = hash_table_build(build_images,
                                                    build_valid, table_size)
    starts, bperm = _placement(slot_b, counts, build_valid)
    return JoinTable(table, counts, starts, bperm)


def hash_join_lookup(jt: JoinTable, stream_images: Sequence[torch.Tensor],
                     stream_valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream side of ``hash_join_probe``: per stream row its match count
    and the first ``bperm`` position of its group (both int32, 0 where it
    has no match). On the card one B4 launch, which reads a hit's count and
    start itself; on the CPU the plain probe, then ``_lookup``."""
    return hash_table_lookup(jt.table, jt.counts, jt.starts, stream_images,
                             stream_valid, jt.size)


def hash_join_probe(build_images: Sequence[torch.Tensor],
                    build_valid: torch.Tensor,
                    stream_images: Sequence[torch.Tensor],
                    stream_valid: torch.Tensor, table_size: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-table join probe with the (counts, bstart, bperm) contract of
    the JAX package's ``ops/joins.join_probe``: counts[i] build matches of
    stream row i, bstart[i] the first position of its group in bperm, bperm
    the build rows grouped by key (ascending within a group, dead rows
    last). A join that probes several stream batches builds once
    (``hash_join_build``) and looks up each batch (``hash_join_lookup``)."""
    jt = hash_join_build(build_images, build_valid, table_size)
    counts, bstart = hash_join_lookup(jt, stream_images, stream_valid)
    return counts, bstart, jt.bperm


def hash_group_ids(images: Sequence[torch.Tensor], valid: torch.Tensor,
                   table_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A dense group id per row from one B3 build (the JAX package's
    ``hash_group_ids``; torch over ``hash_table_build``, no kernel of its
    own). Returns (gid (n,) int32, -1 for invalid rows; num_groups 0-d
    int32; rep_rows (n,) int32, rep_rows[g] the first row of group g for
    g < num_groups). Used slots are read as ``counts > 0``, so the card's
    table (unused key words -1) and the plain one (0) serve alike; a
    parallel build has no arrival rank, so a group's first row is the
    least row of its slot."""
    n = valid.shape[0]
    T = table_size
    dev = valid.device
    slot, _rank, _table, counts_t = hash_table_build(images, valid, T)
    slot = slot.long()
    used = counts_t > 0
    gid_of_slot = torch.cumsum(used.to(torch.int32), 0,
                               dtype=torch.int32) - 1
    hit = valid & (slot < T)
    gid = torch.where(hit, gid_of_slot[slot.clamp(0, T - 1)],
                      torch.full((n,), -1, dtype=torch.int32, device=dev))
    num_groups = used.sum(dtype=torch.int32)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    first_of_slot = torch.full((T + 1,), n, dtype=torch.int64, device=dev)
    first_of_slot.scatter_reduce_(0, torch.where(hit, slot, T), rows, "amin")
    rep_rows = torch.zeros(n + 1, dtype=torch.int32, device=dev).scatter_(
        0, torch.where(used, gid_of_slot.long(), n),
        first_of_slot[:T].to(torch.int32))
    return gid, num_groups, rep_rows[:n]


def hash_join_probe_plain(build_images: Sequence[torch.Tensor],
                          build_valid: torch.Tensor,
                          stream_images: Sequence[torch.Tensor],
                          stream_valid: torch.Tensor, table_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hash_join_probe`` on the plain build and probe, wherever the
    tensors lie (the yardstick of the kernel route on the card)."""
    slot_b, _rank, table, counts_t = hash_table_build_plain(
        build_images, build_valid, table_size)
    starts, bperm = _placement(slot_b, counts_t, build_valid)
    slot_s = hash_table_probe_plain(table, counts_t, stream_images,
                                    stream_valid, table_size)
    counts, bstart = _lookup(slot_s, counts_t, starts)
    return counts, bstart, bperm


def _minmax_init(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _job_outputs(jobs, T: int, dev):
    accs, nels = [], []
    for kind, data, _elig in jobs:
        init = 0 if kind == "sum" else _minmax_init(data.dtype, kind)
        accs.append(torch.full((T,), init, dtype=data.dtype, device=dev))
        nels.append(torch.zeros(T, dtype=torch.int32, device=dev))
    return accs, nels


def hash_grouped_aggregate_plain(images: Sequence[torch.Tensor],
                                 valid: torch.Tensor, jobs,
                                 table_size: int):
    """Plain version of ``hash_grouped_aggregate`` (the jnp twin: the
    round-claiming build assigns slots, then each job is one segment op at
    table width)."""
    T = table_size
    n = valid.shape[0]
    dev = valid.device
    slot, _tab = _hash_slots_plain(images, valid, T)
    sid = torch.where(valid, slot, torch.full_like(slot, T))
    counts = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, sid, valid.to(torch.int32))
    rep = torch.full((T + 1,), n, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(0, sid, torch.arange(n, dtype=torch.int32,
                                             device=dev), "amin")
    accs, nels = _job_outputs(jobs, T + 1, dev)
    for (kind, data, elig), acc, nel in zip(jobs, accs, nels):
        el = elig & valid
        nel.index_add_(0, sid, el.to(torch.int32))
        if kind == "sum":
            acc.index_add_(0, sid, torch.where(el, data,
                                               torch.zeros_like(data)))
        else:
            fill = torch.full_like(data, _minmax_init(data.dtype, kind))
            acc.scatter_reduce_(0, sid, torch.where(el, data, fill),
                                "amin" if kind == "min" else "amax")
    return (counts[:T], rep[:T], [a[:T] for a in accs],
            [ne[:T] for ne in nels])


_KIND_CODE = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.int64: 0, torch.float64: 1, torch.int32: 2}
_NP_DTYPE = {torch.int64: np.int64, torch.float64: np.float64,
             torch.int32: np.int32}


class AggRecord:
    """B2's slot record (``csrc/hash_agg.cu``): every field a live row
    updates, in one record a slot. Byte offsets: the k key words from 0,
    then, for k > 2, the claim's state word (with 4 bytes of pad), the
    8-byte accumulators, count and rep, the 4-byte accumulators and each
    job's eligible count; ``stride`` rounds that up to a multiple of 16
    bytes, so the key words of a slot start 16-byte aligned (k = 2 claims
    on both with one 16-byte CAS). ``state`` is -1 where the key words
    claim their slot (k <= 2)."""

    def __init__(self, k: int, dtypes: Sequence[torch.dtype]):
        off = 8 * k
        self.state = -1
        if k > 2:
            self.state, off = off, off + 8
        self.accs: List[int] = [0] * len(dtypes)
        for j, dt in enumerate(dtypes):
            if dt.itemsize == 8:
                self.accs[j], off = off, off + 8
        self.count, self.rep, off = off, off + 4, off + 8
        for j, dt in enumerate(dtypes):
            if dt.itemsize == 4:
                self.accs[j], off = off, off + 4
        self.nels = list(range(off, off + 4 * len(dtypes), 4))
        off += 4 * len(dtypes)
        self.k = k
        self.dtypes = list(dtypes)
        self.stride = -(-off // 16) * 16

    def init(self, kinds: Sequence[str], n: int) -> np.ndarray:
        """A record's initial pattern, int64 (stride / 8,): key words all
        ones, state 0, count 0, rep n, each accumulator its kind's neutral,
        eligible counts 0."""
        words = np.zeros(self.stride // 8, np.int64)
        raw = words.view(np.uint8)
        words[:self.k] = -1
        raw[self.rep:self.rep + 4] = np.array([n], np.int32).view(np.uint8)
        for kind, dt, off in zip(kinds, self.dtypes, self.accs):
            init = 0 if kind == "sum" else _minmax_init(dt, kind)
            raw[off:off + dt.itemsize] = np.array(
                [init], _NP_DTYPE[dt]).view(np.uint8)
        return words

    def views(self, rec: torch.Tensor, T: int):
        """(counts, rep, accs, nels) of the first T records of ``rec``, a
        (T + 1, stride / 8) int64 tensor: strided views, no copies."""
        i32 = rec.view(torch.int32)
        by_dtype = {torch.int64: rec, torch.float64: rec.view(torch.float64),
                    torch.int32: i32}
        accs = [by_dtype[dt][:T, off // dt.itemsize]
                for dt, off in zip(self.dtypes, self.accs)]
        nels = [i32[:T, off // 4] for off in self.nels]
        return i32[:T, self.count // 4], i32[:T, self.rep // 4], accs, nels


def hash_grouped_aggregate(images: Sequence[torch.Tensor],
                           valid: torch.Tensor, jobs, table_size: int):
    """One-pass grouped aggregation over an open-addressing slot table.

    ``images``: exact 64-bit key-image columns (int64 holding uint64; nulls
    already sentineled and validity folded in by the caller); ``valid``:
    live-row mask (dead rows never enter the table); ``jobs``: list of
    (kind, data (n,), eligible (n,) bool) with kind in {sum, min, max} and
    data int64, float64 or int32.

    Returns slot-space results: (counts (T,) int32 rows per slot, rep (T,)
    int32 first-arrival row per used slot (n where unused), accs: per-job
    (T,) accumulators, nels: per-job (T,) int32 eligible counts). acc holds
    the kind's neutral where its nel == 0; the caller compacts used slots
    (counts > 0) into group rows and masks by nel. On the card they are
    strided views of one record a slot (``AggRecord``), at most 8 key
    images and 16 jobs."""
    if valid.is_cpu:
        return hash_grouped_aggregate_plain(images, valid, jobs, table_size)
    what = "hash_grouped_aggregate"
    _require_cuda(valid, what)
    T = table_size
    k = len(images)
    lib = cudalib.load("hash_agg")
    _check_keys(images, valid, lib.srt_hash_agg_max_keys(), what)
    if len(jobs) > lib.srt_hash_agg_max_jobs():
        raise ValueError(f"{what}: {len(jobs)} jobs, at most "
                         f"{lib.srt_hash_agg_max_jobs()} a call")
    n = valid.shape[0]
    dev = valid.device
    _check_table_size(T, n, what)
    for kind, data, elig in jobs:
        if kind not in _KIND_CODE or data.dtype not in _DTYPE_CODE:
            raise TypeError(f"{what}: job ({kind}, {data.dtype}) is not "
                            "supported")
        if (data.shape != (n,) or elig.shape != (n,)
                or elig.dtype != torch.bool or data.device != dev
                or elig.device != dev):
            raise TypeError(f"{what}: job data and eligible masks must be "
                            f"(n,) on {dev}")
    # every pointer handed to the kernel stays referenced until its launch
    inputs = [valid.contiguous()] + [im.contiguous() for im in images]
    for _kind, data, elig in jobs:
        inputs += [data.contiguous(), elig.contiguous()]
    layout = AggRecord(k, [data.dtype for _kind, data, _e in jobs])
    rec = torch.empty((T + 1, layout.stride // 8), dtype=torch.int64,
                      device=dev)
    desc = array.array("q", (n, k, T, len(jobs), inputs[0].data_ptr(),
                             rec.data_ptr(), layout.stride, layout.state,
                             layout.count, layout.rep))
    desc.extend(im.data_ptr() for im in inputs[1:k + 1])
    for j, (kind, data, _e) in enumerate(jobs):
        desc.extend((_KIND_CODE[kind], _DTYPE_CODE[data.dtype],
                     inputs[k + 1 + 2 * j].data_ptr(),
                     inputs[k + 2 + 2 * j].data_ptr(), layout.accs[j],
                     layout.nels[j]))
    desc.extend(layout.init([kind for kind, _d, _e in jobs], n).tolist())
    err = lib.srt_hash_agg(desc.buffer_info()[0], _stream(dev))
    cudalib.check(lib, err, what)
    _launched("hash_grouped_aggregate", "hash_grouped_aggregate",
              "hash_agg", (list(images), valid,
                           [tuple(j) for j in jobs], table_size))
    return layout.views(rec, T)


# ---------------------------------------------------------------------------
# B5-B8: device Parquet decode
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _u64_window(words: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """words (W,) int32 holding u32, w word indices -> the u64 little-endian
    window words[w] | words[w + 1] << 32 as an int64 bit pattern, both
    indices clipped to the stream (the jnp twin's ``_u64_window``)."""
    top = words.shape[0] - 1
    wc = w.clamp(0, top)
    lo = words[wc].to(torch.int64) & _U32
    hi = words[(wc + 1).clamp(0, top)].to(torch.int64) & _U32
    return lo | (hi << 32)


def _extract_bits(words: torch.Tensor, bit: torch.Tensor,
                  bw: torch.Tensor) -> torch.Tensor:
    """bw-bit little-endian fields (bw <= 32, int64) at absolute bit
    positions ``bit`` (int64), as int64 (the jnp twin's ``_extract_bits``).
    The right shift of a negative window is arithmetic, but the mask keeps
    at most 32 bits of a shift by at most 31, below any sign fill."""
    bit = bit.clamp(min=0)
    w = (bit >> 5).to(torch.int32).to(torch.int64)
    window = _u64_window(words, w)
    mask = (torch.ones_like(bw) << bw) - 1
    return (window >> (bit & 31)) & mask


def _decode_check(what: str, tensors) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    _require_cuda(tensors[0], what)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _check_dtypes(what: str, pairs) -> None:
    for name, t, dtype in pairs:
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"{what}: {name} must be 1-d {dtype}, got "
                            f"{t.dtype} {tuple(t.shape)}")


def hybrid_expand_plain(words, out_start, kind, value, bit_start, bw,
                        n: int) -> torch.Tensor:
    """Plain version of ``hybrid_expand`` (the jnp twin
    ``_hybrid_expand_jnp``)."""
    dev = words.device
    k = torch.arange(n, dtype=torch.int32, device=dev)
    r = torch.searchsorted(out_start, k, right=True) - 1
    r = r.clamp(0, kind.shape[0] - 1)
    rel = (k - out_start[r]).to(torch.int64)
    bwr = bw[r].to(torch.int64)
    bp = _extract_bits(words, bit_start[r] + rel * bwr, bwr).to(torch.int32)
    return torch.where(kind[r] == 1, bp, value[r])


def hybrid_expand_many_plain(streams) -> List[torch.Tensor]:
    """Plain version of ``hybrid_expand_many``: ``hybrid_expand_plain`` of
    each stream."""
    return [hybrid_expand_plain(*s) for s in streams]


# streams per B5 launch (csrc/parquet_decode.cu kMaxHybridStreams)
HYBRID_MAX_STREAMS = 32
# dtypes of a stream's words, out_start, kind, value, bit_start and bw
_HYBRID_DTYPES = (torch.int32, torch.int32, torch.uint8, torch.int32,
                  torch.int64, torch.int32)


def hybrid_expand_many(streams) -> List[torch.Tensor]:
    """``hybrid_expand`` of each ``(words, out_start, kind, value,
    bit_start, bw, n)`` of ``streams``, all in one launch (one per 32
    streams). On the card the outputs are views of one int32 allocation,
    each starting on a 16-byte boundary."""
    if not streams:
        return []
    first = streams[0][0]
    if first.is_cpu:
        return hybrid_expand_many_plain(streams)
    what = "hybrid_expand"
    _require_cuda(first, what)
    dev = first.device
    index = dev.index
    # the host's share of a call is these checks, once per stream
    desc = array.array("q")  # 11 int64 a launched stream (the C layout)
    sizes, off = [], 0
    on_dev, flat = (index,) * 6, ((1,),) * 6
    for words, out_start, kind, value, bit_start, bw, n in streams:
        if (words.dtype, out_start.dtype, kind.dtype, value.dtype,
                bit_start.dtype, bw.dtype) != _HYBRID_DTYPES:
            raise TypeError(f"{what}: words, out_start, kind, value, "
                            "bit_start, bw must be int32, int32, uint8, "
                            "int32, int64, int32")
        if ((words.get_device(), out_start.get_device(), kind.get_device(),
             value.get_device(), bit_start.get_device(), bw.get_device())
                != on_dev
                or (words.stride(), out_start.stride(), kind.stride(),
                    value.stride(), bit_start.stride(), bw.stride())
                != flat):
            raise ValueError(f"{what}: tensors must be 1-d, contiguous and "
                             f"on {dev}")
        nruns = kind.shape[0]
        if (value.shape[0] != nruns or bit_start.shape[0] != nruns
                or bw.shape[0] != nruns or nruns == 0
                or words.shape[0] == 0 or not 0 <= n < 1 << 31):
            raise ValueError(f"{what}: run table rows differ, or no runs, no "
                             f"words, or {n} outputs outside int32")
        if n:
            desc.extend((words.data_ptr(), words.shape[0],
                         out_start.data_ptr(), out_start.shape[0],
                         kind.data_ptr(), value.data_ptr(),
                         bit_start.data_ptr(), bw.data_ptr(), nruns,
                         4 * off, n))
        sizes.append(n + -n % 4)
        off += sizes[-1]
    buf = torch.empty(off, dtype=torch.int32, device=dev)
    outs = list(buf.split(sizes)) if len(sizes) > 1 else [buf]
    for i, (size, s) in enumerate(zip(sizes, streams)):
        if size != s[6]:
            outs[i] = outs[i][:s[6]]
    base = buf.data_ptr()
    for i in range(9, len(desc), 11):
        desc[i] += base
    lib = cudalib.load("parquet_decode")
    stream = _stream(dev)
    addr = desc.buffer_info()[0]
    nrows = len(desc) // 11
    for i in range(0, nrows, HYBRID_MAX_STREAMS):
        part = min(HYBRID_MAX_STREAMS, nrows - i)
        err = lib.srt_hybrid_expand_many(addr + 88 * i, part, stream)
        cudalib.check(lib, err, what)
        _launched("hybrid_expand", "hybrid_expand_many", "parquet_decode",
                  None)
    return outs


def hybrid_expand(words, out_start, kind, value, bit_start, bw,
                  n: int) -> torch.Tensor:
    """Expand an RLE/bit-packed hybrid stream to (n,) int32.

    ``words`` (W,) int32 holding the stream's u32 words; the run table has
    R + 1 rows, the last a guard row: ``out_start`` int32 (R + 2,) (each
    run's first output index, the guard row's, then INT32_MAX), ``kind``
    uint8 (0 RLE, 1 bit-packed), ``value`` int32, ``bit_start`` int64 and
    ``bw`` int32 (<= 32, per run). Output k takes run
    searchsorted(out_start, k, right) - 1 clipped to the guard row. On the
    card, ``hybrid_expand_many`` with one stream."""
    if words.is_cpu:
        return hybrid_expand_plain(words, out_start, kind, value, bit_start,
                                   bw, n)
    return hybrid_expand_many([(words, out_start, kind, value, bit_start,
                                bw, n)])[0]


def delta_unpack_plain(words, mstart, bwid, min_delta, bit_start,
                       page_start, first, n: int) -> torch.Tensor:
    """Plain version of ``delta_unpack``: the jnp twin ``_delta_unpack_jnp``
    over every page of a chunk at once. Each element is its page's first
    value (at a page head) or raw + min_delta of its miniblock; one cumsum
    over the chunk, less the cumsum before each page's head, gives every
    page's own running sum (int64 sums wrap, as the twin's)."""
    dev = words.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    k = torch.arange(n, dtype=torch.int32, device=dev)
    j = (torch.searchsorted(page_start, k, right=True) - 1).clamp(
        0, first.shape[0] - 1)
    ps = page_start[j].to(torch.int64)
    m = (torch.searchsorted(mstart, k, right=True) - 1).clamp(
        0, mstart.shape[0] - 1)
    rel = (k - mstart[m]).to(torch.int64)
    bwm = bwid[m].to(torch.int64)
    raw = _extract_bits(words, bit_start[m] + rel * bwm, bwm)
    x = torch.where(k.to(torch.int64) == ps, first[j], raw + min_delta[m])
    c = torch.cumsum(x, 0)
    before = torch.where(ps > 0, c[(ps - 1).clamp(min=0)],
                         torch.zeros_like(c))
    return c - before


def delta_unpack_many_plain(chunks) -> List[torch.Tensor]:
    """Plain version of ``delta_unpack_many``: ``delta_unpack_plain`` of
    each chunk."""
    return [delta_unpack_plain(*c) for c in chunks]


# dtypes of a chunk's words, mstart, bwid, min_delta, bit_start,
# page_start and first
_DELTA_DTYPES = (torch.int32, torch.int32, torch.int32, torch.int64,
                 torch.int64, torch.int32, torch.int64)
# B6's look-back states, kept per (device, stream): [int64 scratch (the
# ticket, a pad word, two words a tile), the last launch's epoch]. Each
# launch tags its states with a new epoch, so none clears the array; it
# is zeroed only when it grows.
_DELTA_STATE: Dict[Tuple[int, int], list] = {}


@functools.lru_cache(maxsize=None)
def _delta_layout() -> Tuple[int, int]:
    """(chunks a launch, elements a tile) of B6, as the library lays out
    its scratch."""
    lib = cudalib.load("parquet_decode")
    return lib.srt_delta_unpack_max_chunks(), lib.srt_delta_unpack_tile_rows()


def _delta_scratch(dev: torch.device, stream: int, tiles: int) -> list:
    key = (dev.index, stream)
    state = _DELTA_STATE.get(key)
    if state is None or state[0].shape[0] < 2 + 2 * tiles:
        size = 1 << max(12, (2 + 2 * tiles - 1).bit_length())
        state = [torch.zeros(size, dtype=torch.int64, device=dev), 0]
        _DELTA_STATE[key] = state
    return state


def delta_unpack_many(chunks) -> List[torch.Tensor]:
    """``delta_unpack`` of each ``(words, mstart, bwid, min_delta,
    bit_start, page_start, first, n)`` of ``chunks``, all in one launch (one
    per 32 chunks). Each output is its own allocation; the look-back
    states persist per stream (``_DELTA_STATE``)."""
    if not chunks:
        return []
    first_t = chunks[0][0]
    if first_t.is_cpu:
        return delta_unpack_many_plain(chunks)
    what = "delta_unpack"
    _require_cuda(first_t, what)
    dev = first_t.device
    index = dev.index
    max_chunks, tile_rows = _delta_layout()
    # the host's share of a call is these checks, once per chunk
    desc = array.array("q")  # 12 int64 a launched chunk (the C layout)
    outs, tiles = [], []
    for c in chunks:
        for t, dtype in zip(c[:7], _DELTA_DTYPES):
            if t.dtype != dtype or t.get_device() != index \
                    or t.stride() != (1,):
                raise TypeError(
                    f"{what}: words, mstart, bwid, min_delta, bit_start, "
                    "page_start, first must be 1-d, contiguous int32, int32, "
                    f"int32, int64, int64, int32, int64 on {dev}")
        words, mstart, bwid, min_delta, bit_start, page_start, first, n = c
        nmini, npages = mstart.shape[0], first.shape[0]
        if (bwid.shape[0] != nmini or min_delta.shape[0] != nmini
                or bit_start.shape[0] != nmini or nmini == 0
                or page_start.shape[0] != npages + 1 or npages == 0
                or words.shape[0] == 0 or not 0 <= n < 1 << 31):
            raise ValueError(f"{what}: miniblock or page table shapes "
                             f"differ, or {n} outputs outside int32")
        out = torch.empty(n, dtype=torch.int64, device=dev)
        outs.append(out)
        if n:
            desc.extend((words.data_ptr(), words.shape[0], mstart.data_ptr(),
                         bwid.data_ptr(), min_delta.data_ptr(),
                         bit_start.data_ptr(), nmini, page_start.data_ptr(),
                         first.data_ptr(), npages, out.data_ptr(), n))
            tiles.append(-(-n // tile_rows))
    lib = cudalib.load("parquet_decode")
    stream = _stream(dev)
    state = _delta_scratch(dev, stream, max(
        sum(tiles[i:i + max_chunks])
        for i in range(0, len(tiles), max_chunks)) if tiles else 0)
    scratch = state[0]
    addr = desc.buffer_info()[0]
    for i in range(0, len(tiles), max_chunks):
        state[1] += 1
        err = lib.srt_delta_unpack_many(
            addr + 96 * i, min(max_chunks, len(tiles) - i),
            scratch.data_ptr(), scratch.shape[0], state[1], stream)
        cudalib.check(lib, err, what)
        _launched("delta_unpack", "delta_unpack_many", "parquet_decode",
                  None)
    return outs


def delta_unpack(words, mstart, bwid, min_delta, bit_start, page_start,
                 first, n: int) -> torch.Tensor:
    """DELTA_BINARY_PACKED column chunk -> (n,) int64 values, one launch
    for all its pages.

    ``words`` (W,) int32 holding the chunk's u32 words. The miniblock table
    (``ops/parquet_decode.delta_chunk_table``) has M + 1 rows, the last a
    guard row: ``mstart`` int32 (the element index of each miniblock's
    first delta, then INT32_MAX), ``bwid`` int32 (<= 32), ``min_delta``
    int64, ``bit_start`` int64. Pages: ``page_start`` int32 (P + 1,) (the
    last entry n) and ``first`` int64 (P,). Element page_start[p] is
    first[p]; every later element of page p adds its delta to the one
    before it. The output is the JAX package's per-page ``delta_unpack``
    results concatenated. On the card, ``delta_unpack_many`` with one
    chunk."""
    if words.is_cpu:
        return delta_unpack_plain(words, mstart, bwid, min_delta, bit_start,
                                  page_start, first, n)
    return delta_unpack_many([(words, mstart, bwid, min_delta, bit_start,
                               page_start, first, n)])[0]


_PLAIN_KINDS = {"i32": (torch.int32, 4), "f32": (torch.float32, 4),
                "i64": (torch.int64, 8), "f64": (torch.float64, 8),
                "bool": (torch.bool, 1)}


def _plain_out_len(words: torch.Tensor, kind: str, n: int) -> int:
    """The jnp twin's output length: ``[:n]`` of the re-blocked words (a
    bool reads past the stream's end through clipped word indices)."""
    if kind not in _PLAIN_KINDS:
        raise ValueError(f"plain_fixed kind {kind}")
    width = _PLAIN_KINDS[kind][1]
    nw = words.shape[0]
    if width == 8 and nw % 2:
        raise ValueError("plain_fixed: 64-bit values need an even number "
                         f"of words, got {nw}")
    return n if width == 1 else min(n, nw * 4 // width)


def plain_fixed_plain(words, kind: str, n: int) -> torch.Tensor:
    """Plain version of ``plain_fixed`` (the jnp twin ``_plain_fixed_jnp``);
    a new tensor, not a view of ``words``."""
    m = _plain_out_len(words, kind, n)
    if kind in ("i32", "f32"):
        out = words[:m].clone()
        return out.view(torch.float32) if kind == "f32" else out
    if kind in ("i64", "f64"):
        lo = words[0::2].to(torch.int64) & _U32
        hi = words[1::2].to(torch.int64) & _U32
        out = (lo | (hi << 32))[:m].contiguous()
        return out.view(torch.float64) if kind == "f64" else out
    k = torch.arange(n, dtype=torch.int64, device=words.device)
    w = words[(k >> 5).clamp(max=words.shape[0] - 1)]
    return ((w >> (k & 31).to(torch.int32)) & 1).to(torch.bool)


def plain_fixed_many_plain(streams) -> List[torch.Tensor]:
    """Plain version of ``plain_fixed_many``: ``plain_fixed_plain`` of each
    stream."""
    return [plain_fixed_plain(words, kind, n) for words, kind, n in streams]


# streams per B7 launch (csrc/parquet_decode.cu kMaxPlainSegments)
PLAIN_MAX_SEGMENTS = 32


def plain_fixed_many(streams) -> List[torch.Tensor]:
    """``plain_fixed`` of each ``(words, kind, n)`` of ``streams``, all in
    one launch (one per 32 streams)."""
    if not streams:
        return []
    if streams[0][0].is_cpu:
        return plain_fixed_many_plain(streams)
    what = "plain_fixed"
    _require_cuda(streams[0][0], what)
    dev = streams[0][0].device
    index = dev.index
    outs, desc = [], []
    for words, kind, n in streams:
        if words.get_device() != index:
            raise ValueError(f"{what}: tensors on {words.device} and {dev}")
        if (words.dtype != torch.int32 or words.dim() != 1
                or not words.is_contiguous()):
            raise TypeError(f"{what}: words must be contiguous 1-d int32, "
                            f"got {words.dtype} {tuple(words.shape)}")
        m = _plain_out_len(words, kind, n)
        if words.shape[0] == 0 or m >= 1 << 31:
            raise ValueError(f"{what}: no words, or {m} outputs exceed "
                             "int32")
        dtype, width = _PLAIN_KINDS[kind]
        # its own allocation: 16-byte aligned, as the 16-byte stores want,
        # and one allocator call, cheaper on the host than a view of a
        # shared buffer cut and retyped
        out = torch.empty(m, dtype=dtype, device=dev)
        outs.append(out)
        if m:
            desc.append((words.data_ptr(), words.shape[0], width,
                         out.data_ptr(), m))
    lib = cudalib.load("parquet_decode")
    stream = _stream(dev)
    for i in range(0, len(desc), PLAIN_MAX_SEGMENTS):
        part = desc[i:i + PLAIN_MAX_SEGMENTS]
        rows = (ctypes.c_longlong * (5 * len(part)))(
            *[v for row in part for v in row])
        err = lib.srt_plain_fixed_many(rows, len(part), stream)
        cudalib.check(lib, err, what)
        _launched("plain_fixed", "plain_fixed_many", "parquet_decode",
                  None)
    return outs


def plain_fixed(words, kind: str, n: int) -> torch.Tensor:
    """Reassemble a PLAIN fixed-width value stream from its u32 words
    (int32 ``words``): ``kind`` in {i32, i64, f32, f64, bool}. Returns the
    first n values (fewer when the stream holds fewer; a bool is bit k & 31
    of word k >> 5). On the card, ``plain_fixed_many`` with one stream."""
    if words.is_cpu:
        return plain_fixed_plain(words, kind, n)
    return plain_fixed_many([(words, kind, n)])[0]


def slab_pack_plain(chars, starts, lens, cap: int,
                    stride: int) -> torch.Tensor:
    """Plain version of ``slab_pack`` (the jnp twin ``_slab_pack_jnp``)."""
    dev = chars.device
    bytepos = torch.arange(stride, dtype=torch.int32, device=dev)
    if chars.shape[0] == 0:
        return torch.zeros((cap, stride // 8), dtype=torch.int64, device=dev)
    src = (starts[:, None] + bytepos.to(torch.int64)[None, :]).clamp(
        0, chars.shape[0] - 1)
    byte = torch.where(bytepos[None, :] < lens[:, None], chars[src],
                       torch.zeros((), dtype=torch.uint8, device=dev))
    # little-endian words: byte j of a row lands at bit 8*(j%8)
    return byte.contiguous().view(torch.int64)


def slab_pack(chars, starts, lens, cap: int, stride: int) -> torch.Tensor:
    """Gather PLAIN byte-array values into a (cap, stride/8) char slab
    (int64 holding u64 words; ``np_build_slab`` packing: byte j of a row
    at bit 8*(j%8) of word j//8, zero past the row's length). ``chars``
    uint8; ``starts`` int64 and ``lens`` int32 padded to ``cap`` rows with
    0-length rows."""
    if chars.is_cpu:
        return slab_pack_plain(chars, starts, lens, cap, stride)
    what = "slab_pack"
    _decode_check(what, [chars, starts, lens])
    _check_dtypes(what, [("chars", chars, torch.uint8),
                         ("starts", starts, torch.int64),
                         ("lens", lens, torch.int32)])
    if (starts.shape[0] != cap or lens.shape[0] != cap or stride <= 0
            or stride % 8):
        raise ValueError(f"{what}: starts and lens must hold {cap} rows and "
                         f"the stride {stride} be a positive multiple of 8")
    lib = cudalib.load("parquet_decode")
    out = torch.empty((cap, stride // 8), dtype=torch.int64,
                      device=chars.device)
    err = lib.srt_slab_pack(chars.data_ptr(), chars.shape[0],
                            starts.data_ptr(), lens.data_ptr(), cap,
                            stride // 8, out.data_ptr(),
                            _stream(chars.device))
    cudalib.check(lib, err, what)
    _launched("slab_pack", "slab_pack", "parquet_decode",
              (chars, starts, lens, cap, stride))
    return out
