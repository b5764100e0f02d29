"""Bridge between DeviceBatch and expression evaluation contexts
(counterpart of the JAX package's ``sql/exprs/evalbridge.py``)."""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)


def make_context(batch: DeviceBatch) -> EvalContext:
    cols = [DevCol(c.dtype, c.data, c.validity, dict_codes=c.dict_codes,
                   dict_values=c.dict_values, slab64=c.slab64, lens=c.lens)
            for c in batch.columns]
    return EvalContext(cols, batch.row_mask(), batch.capacity, batch.device)


def to_device_column(ctx: EvalContext, v: DevValue) -> DeviceColumn:
    c = ctx.broadcast(v)
    # mask out padding rows so stale values never leak past num_rows
    validity = c.validity & ctx.row_mask
    if c.dtype.is_string and c.dict_values is None:
        # a char slab: masked rows get zero words and length
        slab = torch.where(validity[:, None], c.slab64,
                           torch.zeros_like(c.slab64))
        lens = torch.where(validity, c.lens, torch.zeros_like(c.lens))
        return DeviceColumn(c.dtype, None, validity, slab64=slab, lens=lens)
    if c.dtype.is_string:
        # dictionary metadata survives the projection: codes re-normalized
        # so masked rows carry the NULL sentinel (= card)
        card = len(c.dict_values)
        codes = torch.where(validity, c.dict_codes,
                            torch.full_like(c.dict_codes, card))
        return DeviceColumn(c.dtype, None, validity, codes, c.dict_values)
    return DeviceColumn(c.dtype, c.data, validity)


def eval_projection(batch: DeviceBatch, exprs: List[Expression],
                    names: List[str]) -> DeviceBatch:
    """Evaluate bound expressions into a new DeviceBatch."""
    ctx = make_context(batch)
    out_cols = [to_device_column(ctx, e.eval_device(ctx)) for e in exprs]
    schema = Schema(names, [c.dtype for c in out_cols])
    return DeviceBatch(schema, out_cols, batch.num_rows)
