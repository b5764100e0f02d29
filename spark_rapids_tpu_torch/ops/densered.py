"""Per-slot counts and sums for the dictionary aggregation path
(counterpart of the JAX package's ``ops/densered.py``).

The JAX package splits every value into small float32 limbs so that one
one-hot matmul on the TPU's matrix unit computes every count and sum of an
aggregation exactly; that exists only because the MXU is float32. Here the
same per-slot results come from ``index_add_`` in int64 and float64:
integer sums wrap mod 2^64 (Spark's overflow semantics), float sums follow
IEEE per group (a NaN, or both infinities, give NaN; else an infinity's
sign wins) without one stray NaN touching the other groups.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# kinds this module evaluates; everything else (min/max/first/last/any)
# takes T-width segment ops in the caller
DENSE_KINDS = ("sum", "count_valid")

# the JAX package's f32-exactness bound on the batch size, kept so that
# both packages take the dictionary path for the same batches
MAX_EXACT_CAPACITY = 1 << 23


def dense_supported(kind: str, dtype: torch.dtype) -> bool:
    """Can this (reduction kind, input dtype) run here?"""
    if kind == "count_valid":
        return True
    if kind != "sum":
        return False
    return dtype != torch.bool


def _slot_sum(slot: torch.Tensor, x: torch.Tensor, T: int) -> torch.Tensor:
    """(T,) per-slot sums of ``x``; rows at slot T are dropped."""
    out = torch.zeros(T + 1, dtype=x.dtype, device=x.device)
    out.index_add_(0, slot, x)
    return out[:T]


def slot_reduce_dense(slot: torch.Tensor, live: torch.Tensor, T: int,
                      jobs: Sequence[Tuple[str, torch.Tensor, torch.Tensor,
                                           torch.dtype]]):
    """Evaluate ``jobs`` — (kind, values, validity, out dtype) with kind in
    DENSE_KINDS — per slot. ``slot`` is int64 in [0, T] (T parks dead rows).

    Returns (results, row_count): results is a list of (data (T,),
    has_valid (T,) bool); row_count (T,) int32 counts LIVE rows per slot."""
    row_count = _slot_sum(slot, live.to(torch.int32), T)
    results: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for kind, values, validity, out_dt in jobs:
        contribute = validity & live
        count = _slot_sum(slot, contribute.to(torch.int64), T)
        has_valid = count > 0
        if kind == "count_valid":
            results.append((count.to(out_dt), torch.ones_like(has_valid)))
            continue
        assert kind == "sum", kind
        # float64 addition already gives the per-group IEEE rule in any
        # order, and each slot's sum sees only its own rows
        x = values.to(torch.float64 if values.dtype.is_floating_point
                      else torch.int64)
        data = _slot_sum(slot, torch.where(contribute, x,
                                           torch.zeros_like(x)), T)
        results.append((data.to(out_dt), has_valid))
    return results, row_count
