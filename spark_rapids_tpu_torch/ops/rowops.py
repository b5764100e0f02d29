"""Row-level batch operations: gather, compaction (filter), concatenation,
slicing (counterpart of the JAX package's ``ops/rowops.py``).

All capacity-static: outputs share the input capacity (or a target one)
and carry a new 0-d ``num_rows`` device tensor, so none of them waits for
the host. Compaction runs on the B1 kernel (``kernels.compact_permutation``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, host_to_device, np_build_slab, slab_stride_for,
)
from spark_rapids_tpu_torch.ops.kernels import compact_permutation


def rank_of_iota(sorted_vals: torch.Tensor, out_len: int) -> torch.Tensor:
    """``searchsorted(sorted_vals, arange(out_len), side='right')`` as a
    histogram + cumsum, int32 (out_len,). Values below 0 count toward every
    position, values above out_len toward none, as searchsorted's clip
    does for an iota query vector."""
    hist = torch.zeros(out_len + 1, dtype=torch.int32,
                       device=sorted_vals.device)
    idx = sorted_vals.to(torch.int64).clamp(0, out_len)
    hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.cumsum(hist[:out_len], 0, dtype=torch.int32)


def packed_gather_vectors(vectors: Sequence[torch.Tensor],
                          perm: torch.Tensor) -> List[torch.Tensor]:
    """Gather many same-length vectors by one index vector, one gather a
    vector (the JAX package stacks them by dtype, because a 1-D gather is a
    scalar loop on the TPU; on the GPU a gather a vector moves the same
    bytes without the stacking copy)."""
    idx = perm.long()
    return [v[idx] for v in vectors]


def gather_columns(cols: Sequence[DeviceColumn], perm: torch.Tensor,
                   live: torch.Tensor) -> List[DeviceColumn]:
    """Gather many columns by one index vector. ``live`` marks which output
    slots are real rows; dead slots become invalid (codes: the NULL
    sentinel; slab rows: zero words and length)."""
    idx = perm.long()
    out: List[DeviceColumn] = []
    for c in cols:
        validity = c.validity[idx] & live
        if c.has_slab:
            # one 2-D row gather moves every word of a slab row
            slab = torch.where(live[:, None], c.slab64[idx],
                               torch.zeros((), dtype=torch.int64,
                                           device=idx.device))
            lens = torch.where(live, c.lens[idx],
                               torch.zeros((), dtype=torch.int32,
                                           device=idx.device))
            out.append(DeviceColumn(c.dtype, None, validity, slab64=slab,
                                    lens=lens))
            continue
        codes = None
        if c.dict_values is not None:
            codes = torch.where(live, c.dict_codes[idx],
                                torch.full_like(idx, c.dict_card,
                                                dtype=torch.int32))
        data = None if c.dtype.is_string else c.data[idx]
        out.append(DeviceColumn(c.dtype, data, validity, codes,
                                c.dict_values))
    return out


def gather_column(col: DeviceColumn, perm: torch.Tensor,
                  live: torch.Tensor) -> DeviceColumn:
    return gather_columns([col], perm, live)[0]


def gather_batch(batch: DeviceBatch, perm: torch.Tensor,
                 num_rows: torch.Tensor) -> DeviceBatch:
    out_cap = perm.shape[0]
    live = torch.arange(out_cap, dtype=torch.int32,
                        device=perm.device) < num_rows
    cols = gather_columns(batch.columns, perm, live)
    return DeviceBatch(batch.schema, cols, num_rows.to(torch.int32))


def filter_batch(batch: DeviceBatch, keep: torch.Tensor) -> DeviceBatch:
    """Compact rows where ``keep`` (bool capacity-vector) is True to the
    front, in order."""
    keep = keep & batch.row_mask()
    perm, new_rows = compact_permutation(keep)
    return gather_batch(batch, perm, new_rows)


# union-dictionary cardinality ceiling for the concat merge (the JAX
# package's bound): beyond it a numeric column drops its codes
DICT_MERGE_MAX_CARD = 1 << 14


def _concat_dict(parts: Sequence[DeviceColumn]):
    """(values, per-part codes) for a concat keeping dictionary codes, or
    (None, None): identical dictionaries pass through; different ones merge
    by union + an O(cardinality) remap per part."""
    d0 = parts[0].dict_values
    if d0 is None or any(p.dict_values is None for p in parts):
        return None, None
    if all(p.dict_values == d0 for p in parts):
        return d0, [p.dict_codes for p in parts]
    from spark_rapids_tpu_torch.columnar.dictionary import union_dictionaries
    vals, remaps = union_dictionaries([p.dict_values for p in parts])
    if len(vals) > DICT_MERGE_MAX_CARD:
        return None, None
    codes = []
    for p, r in zip(parts, remaps):
        table = host_to_device(r, p.device)
        codes.append(table[p.dict_codes.clamp(0, p.dict_card).long()])
    return vals, codes


def dict_to_slab(col: DeviceColumn, stride: int) -> DeviceColumn:
    """A dictionary string column as a char slab of ``stride`` bytes: the
    dictionary's slab is built on the host (one row per value plus an empty
    NULL row) and gathered by code."""
    vals = [v.encode("utf-8") for v in col.dict_values]
    card = len(vals)
    offs = np.zeros(card + 2, np.int32)
    offs[1:card + 1] = np.cumsum([len(v) for v in vals])
    offs[card + 1] = offs[card]
    slab_h, lens_h = np_build_slab(
        np.frombuffer(b"".join(vals) or b"\0", np.uint8), offs, card + 1,
        stride)
    rows = col.dict_codes.clamp(0, card).long()
    slab = host_to_device(slab_h.view(np.int64), col.device)[rows]
    lens = torch.where(col.validity,
                       host_to_device(lens_h, col.device)[rows],
                       torch.zeros((), dtype=torch.int32, device=col.device))
    return DeviceColumn(col.dtype, None, col.validity, slab64=slab, lens=lens)


def _concat_slabs(parts: Sequence[DeviceColumn]):
    """(slab, lens) of string parts of which at least one is a slab: every
    part padded to the widest stride (the JAX package's ``_widen_slab``),
    dictionary parts converted to slabs first. (None, None) when no part is
    a slab."""
    if not any(p.has_slab for p in parts):
        return None, None
    max_len = max(max((len(v.encode("utf-8")) for v in p.dict_values),
                      default=0) if not p.has_slab else p.char_stride
                  for p in parts)
    stride = slab_stride_for(max_len, 1 << 30)  # no cap: parts fit already
    slabs, lens = [], []
    for p in parts:
        if not p.has_slab:
            p = dict_to_slab(p, stride)
        pad = (stride - p.char_stride) // 8
        slabs.append(torch.nn.functional.pad(p.slab64, (0, pad))
                     if pad else p.slab64)
        lens.append(p.lens)
    return torch.cat(slabs), torch.cat(lens)


def concat_batches(batches: Sequence[DeviceBatch], out_capacity: int,
                   keep_masks: Optional[Sequence[torch.Tensor]] = None
                   ) -> DeviceBatch:
    """Concatenate batches into one of ``out_capacity`` rows (the device
    analogue of cuDF Table.concatenate under GpuCoalesceBatches).

    Part row counts are device tensors, so the source index of every output
    slot is arithmetic over the per-part bases (no host sync), and every
    column moves with one gather from the statically concatenated buffers.

    ``keep_masks``: optional per-part bool keep vectors (a fused Filter
    below the concat): kept rows compact to the front in part order through
    ONE compact_permutation over the flat mask."""
    schema = batches[0].schema
    dev = batches[0].device
    idx = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    if keep_masks is not None:
        flat_keep = torch.cat([k & b.row_mask()
                               for k, b in zip(keep_masks, batches)])
        perm, total = compact_permutation(flat_keep)
        flat_n = perm.shape[0]
        if flat_n >= out_capacity:
            src = perm[:out_capacity]
        else:
            src = torch.cat([perm, torch.zeros(out_capacity - flat_n,
                                               dtype=torch.int32,
                                               device=dev)])
    else:
        total = torch.zeros((), dtype=torch.int32, device=dev)
        src = torch.zeros(out_capacity, dtype=torch.int32, device=dev)
        static_off = 0
        for b in batches:
            rel = idx - total
            in_p = (rel >= 0) & (rel < b.num_rows)
            src = torch.where(in_p, rel + static_off, src)
            total = total + b.num_rows
            static_off += b.capacity
    total = total.to(torch.int32)
    live = idx < total

    flat_cols: List[DeviceColumn] = []
    for ci, dt in enumerate(schema.dtypes):
        parts = [b.columns[ci] for b in batches]
        validity = torch.cat([p.validity for p in parts])
        slab, lens = _concat_slabs(parts) if dt.is_string else (None, None)
        if slab is not None:
            flat_cols.append(DeviceColumn(dt, None, validity, slab64=slab,
                                          lens=lens))
            continue
        vals, codes = _concat_dict(parts)
        data = None if dt.is_string else torch.cat([p.data for p in parts])
        flat_cols.append(DeviceColumn(
            dt, data, validity,
            torch.cat(codes) if codes is not None else None, vals))
    cols = gather_columns(flat_cols, src, live)
    return DeviceBatch(schema, cols, total)


Count = Union[int, torch.Tensor]


def _dev_int(v: Count, dev) -> torch.Tensor:
    """0-d int32 on ``dev``; a host int is filled on the device (a copy
    from pageable memory would synchronize the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=dev)


def slice_batch(batch: DeviceBatch, start: Count, count: Count
                ) -> DeviceBatch:
    """Rows [start, start + count) compacted to the front, at the input
    capacity (the limit's slice)."""
    return slice_batch_to(batch, start, count, batch.capacity)


def slice_batch_to(batch: DeviceBatch, start: Count, count: Count,
                   out_capacity: int) -> DeviceBatch:
    """``slice_batch`` gathering into an ``out_capacity``-row batch. ``start``
    and ``count`` are host ints or 0-d device tensors; the row count stays
    on the device."""
    dev = batch.device
    idx = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    start, count = _dev_int(start, dev), _dev_int(count, dev)
    perm = (idx + start).clamp(0, batch.capacity - 1)
    n = torch.minimum(count, (batch.num_rows - start).clamp(min=0))
    live = idx < n
    cols = gather_columns(batch.columns, perm, live)
    return DeviceBatch(batch.schema, cols, n.to(torch.int32))
