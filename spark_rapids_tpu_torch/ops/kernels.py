"""The port's hand-written kernels and their plain versions (counterpart of
the JAX package's ``ops/pallas_kernels.py``).

Two of the JAX package's eight Pallas kernels are on this slice's path:

  * ``compact_permutation`` (B1; TPU kernel ``_dual_prefix_kernel``): the
    stable-partition permutation of a keep mask, run by every filter, every
    fused concat and every aggregate slot compaction. CUDA source
    ``csrc/compact.cu``.
  * ``hash_grouped_aggregate`` (B2; TPU kernel ``_hash_agg_kernel``): the
    one-pass open-addressing group-by. CUDA source ``csrc/hash_agg.cu``.

Each public function takes the kernel's plain PyTorch version for a tensor
that lies on the CPU, and launches the CUDA kernel for a CUDA tensor, or
raises: there is no switch and no fallback. The plain versions
(``*_plain``) copy the JAX package's jnp twins (``_dual_prefix_jnp``,
``_hash_build_jnp``, ``_hash_agg_jnp``) and are the yardstick the kernels
are held to on the card. ``LAUNCHES`` counts kernel launches per wrapper.

64-bit key images are int64 tensors holding uint64 bit patterns (see
ops/hashing.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import host_to_device
from spark_rapids_tpu_torch.ops.hashing import as_signed, splitmix64

LAUNCHES: Dict[str, int] = {"compact_permutation": 0,
                            "hash_grouped_aggregate": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, got {t.device}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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


def compact_permutation(keep: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition permutation: kept row indices first (in order), then
    the rest. Returns (perm int32 (n,), kept_total int32 0-d)."""
    if keep.device.type == "cpu":
        return compact_permutation_plain(keep)
    _require_cuda(keep, "compact_permutation")
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(f"compact_permutation takes a 1-d bool mask, got "
                        f"{keep.dtype} {tuple(keep.shape)}")
    n = keep.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"compact_permutation: {n} rows exceed int32")
    from spark_rapids_tpu_torch.ops import cudalib
    lib = cudalib.load("compact")
    keep = keep.contiguous()
    tile = lib.srt_compact_tile_rows()
    ntiles = max(1, -(-n // tile))
    scratch = torch.empty(2 * ntiles, dtype=torch.int32, device=keep.device)
    total = torch.empty((), dtype=torch.int32, device=keep.device)
    perm = torch.empty(n, dtype=torch.int32, device=keep.device)
    err = lib.srt_compact_permutation(
        keep.data_ptr(), n, scratch.data_ptr(), scratch[ntiles:].data_ptr(),
        total.data_ptr(), perm.data_ptr(), _stream())
    cudalib.check(lib, err, "compact_permutation")
    LAUNCHES["compact_permutation"] += 1
    return perm, total


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


def _mix_images(images: Sequence[torch.Tensor]) -> torch.Tensor:
    h = torch.full_like(images[0], _HASH_SEED, dtype=torch.int64)
    for img in images:
        h = splitmix64(h ^ img.to(torch.int64))
    return h


def _hash_slots_plain(images: Sequence[torch.Tensor], valid: torch.Tensor,
                      table_size: int) -> torch.Tensor:
    """Slot of each valid row (invalid -> T) by the jnp twin's round-based
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
    return slot


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
    slot = _hash_slots_plain(images, valid, T)
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
    (counts > 0) into group rows and masks by nel."""
    if valid.device.type == "cpu":
        return hash_grouped_aggregate_plain(images, valid, jobs, table_size)
    _require_cuda(valid, "hash_grouped_aggregate")
    T = table_size
    n = valid.shape[0]
    k = len(images)
    from spark_rapids_tpu_torch.ops import cudalib
    lib = cudalib.load("hash_agg")
    if not 0 < k <= lib.srt_hash_agg_max_keys():
        raise ValueError(f"hash_grouped_aggregate: {k} key images")
    if T & (T - 1) or T <= n or T >= 1 << 31:
        raise ValueError(f"hash_grouped_aggregate: table size {T} must be a "
                         f"power of two above the {n} rows")
    if valid.dtype != torch.bool or valid.shape != (n,):
        raise TypeError("hash_grouped_aggregate: valid must be bool (n,)")
    dev = valid.device
    for im in images:
        if im.dtype != torch.int64 or im.shape != (n,) or im.device != dev:
            raise TypeError("hash_grouped_aggregate: images must be int64 "
                            f"(n,) on {dev}")
    keys = torch.stack(list(images)).contiguous()
    valid = valid.contiguous()
    eligs, datas = [], []
    for kind, data, elig in jobs:
        if kind not in _KIND_CODE or data.dtype not in _DTYPE_CODE:
            raise TypeError(f"hash_grouped_aggregate: job ({kind}, "
                            f"{data.dtype}) is not supported")
        if (data.shape != (n,) or elig.shape != (n,)
                or elig.dtype != torch.bool or data.device != dev
                or elig.device != dev):
            raise TypeError("hash_grouped_aggregate: job data and eligible "
                            f"masks must be (n,) on {dev}")
        datas.append(data.contiguous())
        eligs.append((elig & valid).contiguous())
    table = torch.empty((k, T), dtype=torch.int64, device=dev)
    state = torch.zeros(T, dtype=torch.int32, device=dev)
    counts = torch.zeros(T, dtype=torch.int32, device=dev)
    rep = torch.full((T,), n, dtype=torch.int32, device=dev)
    accs, nels = _job_outputs(jobs, T, dev)
    rows: List[List[int]] = []
    for (kind, _d, _e), data, el, acc, nel in zip(jobs, datas, eligs, accs,
                                                  nels):
        rows.append([_KIND_CODE[kind], _DTYPE_CODE[data.dtype],
                     data.data_ptr(), el.data_ptr(), acc.data_ptr(),
                     nel.data_ptr()])
    job_table = host_to_device(np.array(rows or [[0] * 6], np.int64), dev)
    err = lib.srt_hash_agg(keys.data_ptr(), k, n, valid.data_ptr(),
                           table.data_ptr(), state.data_ptr(), T,
                           counts.data_ptr(), rep.data_ptr(),
                           job_table.data_ptr(), len(rows), _stream())
    cudalib.check(lib, err, "hash_grouped_aggregate")
    LAUNCHES["hash_grouped_aggregate"] += 1
    return counts, rep, accs, nels
