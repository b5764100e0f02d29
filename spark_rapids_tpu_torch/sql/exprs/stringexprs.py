"""String expressions (counterpart of the JAX package's
``sql/exprs/stringexprs.py``: ``Substring``, the literal-pattern predicates
``StartsWith``, ``EndsWith`` and ``Contains``, and ``Like``). The device
operations are ``ops/strings.py``'s, over dictionary codes and char slabs.

As in the JAX package, a LIKE pattern that reduces to an exact match, a
prefix, a suffix or one contained needle runs on the device; a pattern
with ``_`` or an interior ``%`` needs general regex and is tagged off the
device with the JAX package's reason. The host evaluates every pattern
by regex.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.ops import strings as string_ops
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
)


class Substring(Expression):
    """substring(s, pos, length): 1-based ``pos``, negative from the end,
    ``length`` < 0 to the end; byte-oriented."""

    def __init__(self, child: Expression, pos: int, length: int = -1):
        super().__init__([child])
        self.pos = pos
        self.length = length

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"substring({self.children[0]!r}, {self.pos}, {self.length})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        assert isinstance(v, DevCol)
        return string_ops.substring(ctx, v, self.pos, self.length)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([string_ops.host_substring(x, self.pos, self.length)
                        if ok else None
                        for x, ok in zip(values, validity)], dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class _LiteralPatternPredicate(Expression):
    """Base of startswith/endswith/contains with a literal pattern."""
    fn_name = "?"

    def __init__(self, child: Expression, pattern: str):
        super().__init__([child])
        self.pattern = pattern

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"{self.fn_name}({self.children[0]!r}, {self.pattern!r})"

    def device_kernel(self, ctx, col):
        raise NotImplementedError

    def host_match(self, s: str) -> bool:
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        assert isinstance(v, DevCol)
        data, validity = self.device_kernel(ctx, v)
        return DevCol(dtypes.BOOL, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = np.array([self.host_match(x) if ok else False
                         for x, ok in zip(values, validity)],
                        dtype=np.bool_)
        return rebuild_series(data, validity, dtypes.BOOL, index)


class StartsWith(_LiteralPatternPredicate):
    fn_name = "startswith"

    def device_kernel(self, ctx, col):
        return string_ops.starts_with(ctx, col, self.pattern)

    def host_match(self, s: str) -> bool:
        return s.startswith(self.pattern)


class EndsWith(_LiteralPatternPredicate):
    fn_name = "endswith"

    def device_kernel(self, ctx, col):
        return string_ops.ends_with(ctx, col, self.pattern)

    def host_match(self, s: str) -> bool:
        return s.endswith(self.pattern)


class Contains(_LiteralPatternPredicate):
    fn_name = "contains"

    def device_kernel(self, ctx, col):
        return string_ops.contains(ctx, col, self.pattern)

    def host_match(self, s: str) -> bool:
        return self.pattern in s


class Like(Expression):
    """SQL LIKE with a literal pattern: exact, prefix, suffix and
    contains patterns run on the device, any other is tagged off."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__([child])
        self.pattern = pattern
        self._kind, self._needle = _classify_like(pattern)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"({self.children[0]!r} LIKE {self.pattern!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self._kind is None:
            return (f"LIKE pattern {self.pattern!r} needs general regex, "
                    "which is not supported on TPU")
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        assert isinstance(v, DevCol)
        fn = {"exact": string_ops.string_equal_literal,
              "prefix": string_ops.starts_with,
              "suffix": string_ops.ends_with,
              "contains": string_ops.contains}[self._kind]
        data, validity = fn(ctx, v, self._needle)
        return DevCol(dtypes.BOOL, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        import re
        regex = re.compile(_like_to_regex(self.pattern), re.DOTALL)
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = np.array([bool(regex.fullmatch(x)) if ok else False
                         for x, ok in zip(values, validity)],
                        dtype=np.bool_)
        return rebuild_series(data, validity, dtypes.BOOL, index)


def _classify_like(p: str):
    """Map a LIKE pattern to (kind, needle) if it avoids general regex."""
    if "_" in p:
        return None, None
    body = p.strip("%")
    if "%" in body:
        return None, None  # interior wildcard
    starts = p.startswith("%")
    ends = p.endswith("%")
    if starts and ends:
        return "contains", body
    if ends:
        return "prefix", body
    if starts:
        return "suffix", body
    return "exact", body


def _like_to_regex(p: str) -> str:
    import re
    out = []
    for ch in p:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)
