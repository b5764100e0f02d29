"""Sort-based grouping (counterpart of the JAX package's ``ops/groupby.py``).

  1. hash each key column to two independent 64-bit hashes and combine
     them per row (``row_hashes``);
  2. one stable sort of (dead, h1, h2) with the row index carried as the
     permutation (``group_rows``; LSD passes of ``torch.sort`` through
     ``ops/sortops.lexsort_permutation``, the same permutation as the JAX
     package's stable ``lax.sort``);
  3. group boundaries where the hash pair changes, group ids by prefix sum;
  4. segment reductions per aggregate (``segment_reduce``,
     ``segment_select_string``).

Group counts stay 0-d device tensors: nothing here waits for the host.
Null keys form their own group; float keys hash their normalized bits
(-0.0 == 0.0, one NaN).

``segment_select_string`` differs from the JAX package in how it orders
strings, with the same result: a dictionary column's codes are in sorted
value order (``columnar/column.host_dict_encode``), so within one batch the
code is an exact image; a char slab's images are all of its words and its
length; a plain column's are ``sortops.string_images``, exact past 64
bytes. The JAX package's full-length refinement of prefix ties (a
``lax.cond``) is the plain images' tie settling here, behind one counted
sync.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtype import torch_dtype
from spark_rapids_tpu_torch.ops import hashing


def minmax_operands(vs: torch.Tensor, kind: str):
    """Shared (values, neutral) selection for min/max reductions."""
    if vs.dtype.is_floating_point:
        return vs, (float("inf") if kind == "min" else float("-inf"))
    if vs.dtype == torch.bool:
        return vs.to(torch.int32), (1 if kind == "min" else 0)
    info_ = torch.iinfo(vs.dtype)
    return vs, (info_.max if kind == "min" else info_.min)


# parking slots past the last group for the rows outside every group: on
# the card, millions of dead rows folding into one slot serialise on its
# address (a merge of padded partials is mostly padding)
PARK_SLOTS = 1024


def park_ids(seg_id: torch.Tensor, live: torch.Tensor,
             width: int) -> torch.Tensor:
    """int64 segment ids: ``seg_id`` where ``live``, else one of PARK_SLOTS
    parking slots from ``width`` on (a segment op over them takes
    ``width + PARK_SLOTS`` segments and drops the parking slots)."""
    pos = torch.arange(seg_id.shape[0], device=seg_id.device)
    return torch.where(live, seg_id.long(), width + (pos & (PARK_SLOTS - 1)))


def _identity(op: str, dtype: torch.dtype):
    """The identity of a segment op, as jax.ops.segment_* fill empty
    segments: 0 for a sum, the dtype's largest (smallest) value for a min
    (max)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "amin" else float("-inf")
    if dtype == torch.bool:
        return op == "amin"
    info_ = torch.iinfo(dtype)
    return info_.max if op == "amin" else info_.min


def segment_op(op: str, x: torch.Tensor, seg_id: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """(num_segments,) segment reduction ("sum", "amin" or "amax") of ``x``
    by ``seg_id`` in [0, num_segments); empty segments hold the op's
    identity, as in ``jax.ops.segment_*``."""
    out = torch.full((num_segments,), _identity(op, x.dtype), dtype=x.dtype,
                     device=x.device)
    if op == "sum":
        return out.index_add_(0, seg_id.long(), x)
    return out.scatter_reduce_(0, seg_id.long(), x, op)


def row_hashes(batch: DeviceBatch, key_indices: Sequence[int],
               batch_local: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent 64-bit row hashes over the key columns.

    ``batch_local``: the caller needs consistency only within this batch
    (grouping), so dictionary string columns hash their codes. Never for
    partitioning across batches or tables: two dictionaries give equal
    values different codes. Otherwise a string column hashes its values
    (``hashing.string_poly_hashes_col``)."""
    h1s, h2s = [], []
    for ki in key_indices:
        col = batch.columns[ki]
        if col.dtype.is_string and not (
                batch_local and col.dict_values is not None):
            h1, h2 = hashing.string_poly_hashes_col(col)
        else:
            data = col.dict_codes if col.dtype.is_string else col.data
            h1 = hashing.hash_fixed_width(data, col.validity)
            h2 = hashing.splitmix64(h1 ^ hashing.as_signed(hashing.SALT2))
        h1s.append(h1)
        h2s.append(h2)
    return hashing.combine_hashes(h1s), hashing.combine_hashes(h2s)


class GroupInfo:
    """Result of the grouping phase, all on the device."""

    def __init__(self, perm, group_id_sorted, boundary, num_groups, rep_rows,
                 live_sorted):
        self.perm = perm                    # sorted row order, int32 (cap,)
        self.group_id_sorted = group_id_sorted  # group id per sorted slot
        self.boundary = boundary            # bool: first row of its group
        self.num_groups = num_groups        # 0-d int32
        self.rep_rows = rep_rows            # original row of each group's
                                            # first sorted row (cap,)
        # the segment ids of the group ops: dead slots parked past the end
        self.seg_ids = park_ids(group_id_sorted, live_sorted, perm.shape[0])

    def segment(self, op: str, x: torch.Tensor) -> torch.Tensor:
        """(capacity,) segment op of sorted-space ``x`` over the groups."""
        cap = self.perm.shape[0]
        return segment_op(op, x, self.seg_ids, cap + PARK_SLOTS)[:cap]


def group_rows(batch: DeviceBatch, key_indices: Sequence[int],
               compute_rep: bool = True, live=None) -> GroupInfo:
    """Sort the rows by (dead, h1, h2), stably, and mark the groups."""
    from spark_rapids_tpu_torch.ops.sortops import lexsort_permutation
    capacity = batch.capacity
    if live is None:
        live = batch.row_mask()
    h1, h2 = row_hashes(batch, key_indices, batch_local=True)
    # dead rows sort last
    perm = lexsort_permutation([(~live).to(torch.int64), h1, h2])
    idx = perm.long()
    live_s = live[idx]
    h1_s, h2_s = h1[idx], h2[idx]
    prev_h1 = torch.cat([h1_s[:1] ^ 1, h1_s[:-1]])
    prev_h2 = torch.cat([h2_s[:1], h2_s[:-1]])
    boundary = ((h1_s != prev_h1) | (h2_s != prev_h2)) & live_s
    boundary[0] = live_s[0]
    group_id = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    group_id = torch.where(live_s, group_id, capacity - 1)  # park dead rows
    num_groups = boundary.sum(dtype=torch.int32)
    info = GroupInfo(perm, group_id, boundary, num_groups, None, live_s)
    if compute_rep:
        info.rep_rows = info.segment("sum", torch.where(boundary, perm, 0))
    return info


def gather_keys(batch: DeviceBatch, key_indices: Sequence[int],
                info: GroupInfo) -> List[DeviceColumn]:
    """Key columns with one row per group (the group's first row)."""
    from spark_rapids_tpu_torch.ops.rowops import gather_columns
    live = torch.arange(batch.capacity, dtype=torch.int32,
                        device=batch.device) < info.num_groups
    return gather_columns([batch.columns[ki] for ki in key_indices],
                          info.rep_rows, live)


def segment_reduce(kind: str, values: torch.Tensor, validity: torch.Tensor,
                   info: GroupInfo, out_dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One reduction over groups: (data, validity) of capacity size with
    the first num_groups entries real. ``out_dtype``: a numpy dtype.

    kinds: sum, min, max, count_valid, first, last, first_valid,
    last_valid, any."""
    capacity = values.shape[0]
    tdt = torch_dtype(out_dtype)
    idx = info.perm.long()
    vs = values[idx]
    val_s = validity[idx]
    seg = info.segment
    group_has_valid = seg("amax", val_s.to(torch.int32)) > 0
    ones = torch.ones(capacity, dtype=torch.bool, device=vs.device)
    if kind == "count_valid":
        return seg("sum", val_s.to(torch.int64)).to(tdt), ones
    if kind == "sum":
        x = torch.where(val_s, vs.to(tdt), torch.zeros((), dtype=tdt,
                                                        device=vs.device))
        return seg("sum", x), group_has_valid
    if kind in ("min", "max"):
        v2, neutral = minmax_operands(vs, kind)
        x = torch.where(val_s, v2, torch.full_like(v2, neutral))
        data = seg("amin" if kind == "min" else "amax", x)
        if tdt == torch.bool:
            data = data != 0
        return data.to(tdt), group_has_valid
    if kind in ("first", "last", "first_valid", "last_valid"):
        sel_c, picked = _segment_pick_pos(kind, val_s, info)
        sel = sel_c.long()
        return vs[sel].to(tdt), picked & val_s[sel]
    if kind == "any":
        data = seg("amax", (vs & val_s).to(torch.int32)) > 0
        return data.to(tdt), ones
    raise ValueError(f"unknown reduction kind: {kind}")


def _segment_pick_pos(kind: str, val_s: torch.Tensor, info: GroupInfo
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First/last position selection in sorted-slot space: (the clipped
    sorted slot of each group's pick, picked bool per group)."""
    capacity = val_s.shape[0]
    pos = torch.arange(capacity, dtype=torch.int32, device=val_s.device)
    eligible = val_s if kind.endswith("_valid") else torch.ones_like(val_s)
    if kind.startswith("first"):
        sel = info.segment("amin", torch.where(eligible, pos, capacity + 1))
    else:
        sel = info.segment("amax", torch.where(eligible, pos, -1))
    picked = (sel >= 0) & (sel < capacity)
    return sel.clamp(0, capacity - 1), picked


def segment_select_string(kind: str, col: DeviceColumn, info: GroupInfo
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The winning original row of each group for a string reduction (the
    value itself moves later with one gather): (rows int32 (capacity,),
    has_valid bool (capacity,)). min/max are exact byte order; first/last
    are positional."""
    from spark_rapids_tpu_torch.ops.sortops import (
        _string_prefix_chunks, lexsort_permutation, string_images,
    )
    capacity = col.capacity
    gid = info.group_id_sorted
    idx = info.perm.long()
    val_s = col.validity[idx]
    has = info.segment("amax", val_s.to(torch.int32)) > 0

    if kind in ("min", "max"):
        if col.dict_values is not None and col.dict_codes is not None:
            src = [col.dict_codes.to(torch.int64)]
        elif col.has_slab:
            src = _string_prefix_chunks(col)[:col.slab64.shape[1]] \
                + [col.lens.to(torch.int64)]
        else:
            src = string_images([col])[0]
        imgs = [c[idx] for c in src]
        if kind == "max":
            imgs = [~img for img in imgs]
        imgs = [torch.where(val_s, img, torch.full_like(img, -1))
                for img in imgs]
        # invalid rows sort last within their group: the all-ones image
        # alone cannot promise it for max, where a valid empty string's
        # inverted image is all ones too
        invalid_key = (~val_s).to(torch.int64)
        p2 = lexsort_permutation([gid.to(torch.int64), invalid_key] + imgs)
        orig_new = info.perm[p2.long()]
        # the group ids are unchanged by the re-sort, so the boundaries
        # still mark each group's first (winning) slot
        rows = info.segment("sum", torch.where(info.boundary, orig_new, 0))
        return rows, has

    if kind in ("first", "last", "first_valid", "last_valid"):
        sel_c, picked = _segment_pick_pos(kind, val_s, info)
        sel = sel_c.long()
        return info.perm[sel], picked & val_s[sel]
    raise ValueError(f"unknown string reduction kind: {kind}")
