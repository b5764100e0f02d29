"""Row-level batch operations: gather, compaction (filter), concatenation
(counterpart of the JAX package's ``ops/rowops.py``).

All capacity-static: outputs share the input capacity (or a target one)
and carry a new 0-d ``num_rows`` device tensor, so none of them waits for
the host. Compaction runs on the B1 kernel (``kernels.compact_permutation``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, host_to_device
from spark_rapids_tpu_torch.ops.kernels import compact_permutation


def gather_columns(cols: Sequence[DeviceColumn], perm: torch.Tensor,
                   live: torch.Tensor) -> List[DeviceColumn]:
    """Gather many columns by one index vector. ``live`` marks which output
    slots are real rows; dead slots become invalid (codes: the NULL
    sentinel)."""
    idx = perm.long()
    out: List[DeviceColumn] = []
    for c in cols:
        validity = c.validity[idx] & live
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
        vals, codes = _concat_dict(parts)
        data = None if dt.is_string else torch.cat([p.data for p in parts])
        flat_cols.append(DeviceColumn(
            dt, data, torch.cat([p.validity for p in parts]),
            torch.cat(codes) if codes is not None else None, vals))
    cols = gather_columns(flat_cols, src, live)
    return DeviceBatch(schema, cols, total)
