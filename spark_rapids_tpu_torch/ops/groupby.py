"""Grouping helpers (counterpart of the JAX package's ``ops/groupby.py``;
only ``minmax_operands`` is ported)."""

from __future__ import annotations

import torch


def minmax_operands(vs: torch.Tensor, kind: str):
    """Shared (values, neutral) selection for min/max reductions."""
    if vs.dtype.is_floating_point:
        return vs, (float("inf") if kind == "min" else float("-inf"))
    if vs.dtype == torch.bool:
        return vs.to(torch.int32), (1 if kind == "min" else 0)
    info_ = torch.iinfo(vs.dtype)
    return vs, (info_.max if kind == "min" else info_.min)
