"""Slot-layout-free comparisons of hash tables and join probes.

The CUDA build claims slots in another order than the plain version's
round-based claiming, so two builds of the same keys agree on what the table
holds, not where. These helpers reduce each output to what must be equal:

  * ``table_by_key``: the multiset of (key words..., count) over used slots;
  * ``check_build``: every valid row's slot holds the row's key, invalid rows
    get T, and each slot's count is the number of rows that landed there;
  * ``join_matches``: per stream row, its match count and the build rows of
    its group in ``bperm`` order (the stable sort keeps them ascending, so
    this is the same whatever the slot layout).

All are vectorized torch code that runs where the tensors lie.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _sort_rows(mat: torch.Tensor) -> torch.Tensor:
    """Rows of an int64 (m, c) matrix in ascending lexicographic order
    (LSD passes of a stable sort, last column first)."""
    perm = torch.arange(mat.shape[0], device=mat.device)
    for c in reversed(range(mat.shape[1])):
        order = torch.sort(mat[perm, c], stable=True).indices
        perm = perm[order]
    return mat[perm]


def table_by_key(table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(used slots, k + 1) int64: each used slot's key words and count,
    sorted."""
    used = counts > 0
    mat = torch.cat([table[:, used].t(), counts[used].to(torch.int64)[:, None]],
                    dim=1)
    return _sort_rows(mat)


def check_build(images: Sequence[torch.Tensor], valid: torch.Tensor,
                slot: torch.Tensor, table: torch.Tensor,
                counts: torch.Tensor) -> None:
    """Raise AssertionError unless (slot, table, counts) is a consistent
    build of ``images`` over the rows where ``valid``."""
    T = counts.shape[0]
    if not torch.equal(slot[~valid], torch.full_like(slot[~valid], T)):
        raise AssertionError("an invalid row got a slot")
    s = slot[valid].long()
    if s.numel() and not bool(((s >= 0) & (s < T)).all()):
        raise AssertionError("a valid row's slot lies outside the table")
    for j, img in enumerate(images):
        if not torch.equal(table[j][s], img[valid]):
            raise AssertionError(f"key word {j} of a row differs from its "
                                 "slot's")
    per_slot = torch.zeros(T, dtype=torch.int32, device=counts.device)
    per_slot.index_add_(0, s, torch.ones_like(s, dtype=torch.int32))
    if not torch.equal(per_slot, counts):
        raise AssertionError("slot counts differ from the rows per slot")


def join_matches(counts: torch.Tensor, bstart: torch.Tensor,
                 bperm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts int64, the build rows of every stream row's group in bperm
    order, concatenated in stream row order)."""
    c = counts.to(torch.int64)
    total = int(c.sum())
    excl = torch.cumsum(c, 0) - c
    first = torch.repeat_interleave(bstart.to(torch.int64), c,
                                    output_size=total)
    base = torch.repeat_interleave(excl, c, output_size=total)
    pos = first + torch.arange(total, device=c.device) - base
    return c, bperm.to(torch.int64)[pos]
