"""String equality on device columns (counterpart of the JAX package's
``ops/strings.py``; only ``string_equal_literal``'s dictionary case and
``string_equal``'s column/literal dispatch are ported).

String columns reach device code as dictionary codes in this slice, so a
comparison with a literal resolves the literal to its code on the host and
compares int32 codes: no char is read. Plain (non-dictionary) strings and
column/column equality wait for the strings slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch.columnar.column import plain_strings_unsupported
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevScalar, DevValue, EvalContext,
)


def _validity(ctx: EvalContext, v: DevValue) -> torch.Tensor:
    if isinstance(v, DevScalar):
        return torch.full((ctx.capacity,), bool(v.valid), dtype=torch.bool,
                          device=ctx.device)
    return v.validity


def string_equal_literal(ctx: EvalContext, col: DevCol,
                         lit: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """col == literal. Returns (eq bool vec, validity). The literal's code
    is found in the column's static dictionary on the host; a literal the
    dictionary lacks matches no row."""
    if col.dict_values is None:
        raise plain_strings_unsupported("string_equal_literal")
    try:
        code = col.dict_values.index(lit)
    except ValueError:
        return torch.zeros_like(col.validity), col.validity
    return col.dict_codes == code, col.validity


def string_equal(ctx: EvalContext, lv: DevValue, rv: DevValue
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """String equality, column/literal either way round or literal/literal.
    Returns (eq bool vec, validity)."""
    if isinstance(rv, DevScalar) and isinstance(lv, DevCol):
        eq, _ = string_equal_literal(ctx, lv, str(rv.value))
        return eq, lv.validity & _validity(ctx, rv)
    if isinstance(lv, DevScalar) and isinstance(rv, DevCol):
        eq, _ = string_equal_literal(ctx, rv, str(lv.value))
        return eq, rv.validity & _validity(ctx, lv)
    if isinstance(lv, DevScalar) and isinstance(rv, DevScalar):
        eq = torch.full((ctx.capacity,), lv.value == rv.value,
                        dtype=torch.bool, device=ctx.device)
        return eq, _validity(ctx, lv) & _validity(ctx, rv)
    raise NotImplementedError(
        "string_equal: column/column string equality is not ported yet")
