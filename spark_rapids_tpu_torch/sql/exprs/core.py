"""Expression framework core (counterpart of the JAX package's
``sql/exprs/core.py``).

Expressions evaluate columnar, on whole batches: ``eval_device(ctx)``
returns a ``DevCol`` (data + validity tensors, plus dictionary metadata
carried through from scanned columns) or a ``DevScalar``; ``eval_host(df)``
evaluates over a pandas frame for the session's CPU path. Null discipline:
``validity`` is a bool tensor, True = valid; invalid slots hold a canonical
fill value so arithmetic never traps.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType, torch_dtype


class DevCol:
    """Device column value during expression evaluation. String values
    (``data`` None) are dictionary codes or a char slab (``slab64``,
    ``lens``); a slab passes through evaluation unchanged, and string
    expressions read only dictionary codes in this slice."""

    __slots__ = ("dtype", "data", "validity", "dict_codes", "dict_values",
                 "slab64", "lens")

    def __init__(self, dtype: DType, data, validity, dict_codes=None,
                 dict_values=None, slab64=None, lens=None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.dict_codes = dict_codes
        self.dict_values = dict_values
        self.slab64 = slab64
        self.lens = lens


class DevScalar:
    """Device scalar value (literal), possibly null. ``value`` is a 0-d
    tensor on the batch's device (a python str for strings)."""

    __slots__ = ("dtype", "value", "valid")

    def __init__(self, dtype: DType, value, valid=True):
        self.dtype = dtype
        self.value = value
        self.valid = valid


DevValue = Union[DevCol, DevScalar]


class EvalContext:
    """Binds a batch to expression evaluation: ``cols`` are the input
    DevCols (one per input schema field), ``row_mask`` marks live rows."""

    def __init__(self, cols: List[DevCol], row_mask, capacity: int,
                 device):
        self.cols = cols
        self.row_mask = row_mask
        self.capacity = capacity
        self.device = device

    def broadcast(self, v: DevValue) -> DevCol:
        """Materialize a scalar into a column of this batch's capacity."""
        if isinstance(v, DevCol):
            return v
        if v.dtype.is_string:
            raise NotImplementedError(
                "string literals as columns are not ported yet")
        data = torch.full((self.capacity,), 0, dtype=torch_dtype(
            v.dtype.np_dtype), device=self.device)
        data[:] = v.value
        validity = torch.full((self.capacity,), bool(v.valid),
                              dtype=torch.bool, device=self.device)
        return DevCol(v.dtype, data, validity)


class Expression:
    """Base class. Subclasses define children, typing and device eval."""

    def __init__(self, children: Sequence["Expression"] = ()):
        self.children: List[Expression] = list(children)

    def dtype(self, schema: Schema) -> DType:
        raise NotImplementedError

    @property
    def pretty_name(self) -> str:
        return type(self).__name__

    def __repr__(self) -> str:
        if self.children:
            return f"{self.pretty_name}({', '.join(map(repr, self.children))})"
        return self.pretty_name

    def eval_device(self, ctx: EvalContext) -> DevValue:
        raise NotImplementedError(f"{self.pretty_name} has no device kernel")

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        raise NotImplementedError(f"{self.pretty_name} has no host eval")

    def device_supported(self, schema: Schema) -> Optional[str]:
        """None if this node can run on the device, else the reason."""
        return None

    def map_children(self, fn) -> "Expression":
        import copy
        new = copy.copy(self)
        new.children = [fn(c) for c in self.children]
        return new


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class Literal(Expression):
    def __init__(self, value: Any, dtype_: Optional[DType] = None):
        super().__init__()
        if dtype_ is None:
            dtype_ = _infer_literal_dtype(value)
        self.value = _canonicalize_literal(value, dtype_)
        self._dtype = dtype_

    def dtype(self, schema: Schema) -> DType:
        return self._dtype

    def __repr__(self) -> str:
        return f"lit({self.value!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        if self._dtype.is_string:
            return DevScalar(self._dtype, self.value,
                             valid=self.value is not None)
        if self.value is None:
            return DevScalar(self._dtype, torch.zeros(
                (), dtype=torch_dtype(self._dtype.np_dtype),
                device=ctx.device), valid=False)
        # torch.full fills on the device: no host-to-device copy, no sync
        return DevScalar(self._dtype, torch.full(
            (), self.value, dtype=torch_dtype(self._dtype.np_dtype),
            device=ctx.device))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        n = len(df)
        if self.value is None:
            return pd.Series([pd.NA] * n, dtype=self._dtype.pandas_nullable,
                             index=df.index)
        if self._dtype.is_string:
            return pd.Series([self.value] * n, dtype="str", index=df.index)
        if self._dtype == dtypes.TIMESTAMP_US:
            return pd.Series(np.full(n, self.value, dtype="datetime64[us]"),
                             index=df.index)
        if self._dtype == dtypes.DATE32:
            return pd.Series(
                np.full(n, self.value, dtype="datetime64[D]").astype(
                    "datetime64[s]"), index=df.index)
        return pd.Series(np.full(n, self.value, dtype=self._dtype.np_dtype),
                         index=df.index)


def _infer_literal_dtype(value: Any) -> DType:
    import datetime
    if isinstance(value, bool):
        return dtypes.BOOL
    if isinstance(value, (int, np.integer)):
        return dtypes.INT64 if not isinstance(value, np.int32) else dtypes.INT32
    if isinstance(value, (float, np.floating)):
        return dtypes.FLOAT64
    if isinstance(value, str):
        return dtypes.STRING
    if isinstance(value, (datetime.datetime, pd.Timestamp, np.datetime64)):
        return dtypes.TIMESTAMP_US
    if isinstance(value, datetime.date):
        return dtypes.DATE32
    if value is None:
        raise TypeError("null literal needs an explicit dtype")
    raise TypeError(f"cannot infer literal type for {value!r}")


def _canonicalize_literal(value: Any, dt: DType) -> Any:
    """Store date/timestamp literals in their physical representation
    (days / microseconds since epoch)."""
    import datetime
    if value is None:
        return None
    if dt == dtypes.DATE32 and isinstance(value, datetime.date) \
            and not isinstance(value, datetime.datetime):
        return int((np.datetime64(value, "D")
                    - np.datetime64(0, "D")).astype(int))
    if dt == dtypes.TIMESTAMP_US and isinstance(
            value, (datetime.datetime, pd.Timestamp, np.datetime64)):
        return int(np.datetime64(value, "us").astype(np.int64))
    return value


class Col(Expression):
    """Unresolved column reference by name."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def dtype(self, schema: Schema) -> DType:
        return schema.dtype_of(self.name)

    def __repr__(self) -> str:
        return f"col({self.name!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        raise RuntimeError(f"unbound column reference {self.name!r}; "
                           "bind_references must run before execution")

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        return df[self.name]


class BoundRef(Expression):
    """Column reference bound to an input ordinal (the reference's
    GpuBoundReference)."""

    def __init__(self, index: int, dtype_: DType, name: str = ""):
        super().__init__()
        self.index = index
        self._dtype = dtype_
        self.name = name

    def dtype(self, schema: Schema) -> DType:
        return self._dtype

    def __repr__(self) -> str:
        return f"input[{self.index}]"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return ctx.cols[self.index]

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        return df.iloc[:, self.index]


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        super().__init__([child])
        self.name = name

    def dtype(self, schema: Schema) -> DType:
        return self.children[0].dtype(schema)

    def __repr__(self) -> str:
        return f"{self.children[0]!r} AS {self.name}"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return self.children[0].eval_device(ctx)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        return self.children[0].eval_host(df)


# ---------------------------------------------------------------------------
# Binding / traversal helpers
# ---------------------------------------------------------------------------

def bind_references(expr: Expression, schema: Schema) -> Expression:
    """Replace Col(name) with BoundRef(ordinal) against ``schema``."""
    if isinstance(expr, Col):
        idx = schema.index_of(expr.name)
        return BoundRef(idx, schema.dtypes[idx], expr.name)
    return expr.map_children(lambda c: bind_references(c, schema))


# ---------------------------------------------------------------------------
# Shared device helpers
# ---------------------------------------------------------------------------

def valid_and(ctx: EvalContext, *vals: DevValue):
    """Conjunction of validity across operands (standard SQL null
    propagation for non-Kleene ops)."""
    out = None
    for v in vals:
        if isinstance(v, DevScalar):
            cur = torch.full((ctx.capacity,), bool(v.valid),
                             dtype=torch.bool, device=ctx.device)
        else:
            cur = v.validity
        out = cur if out is None else (out & cur)
    return out


def data_of(ctx: EvalContext, v: DevValue):
    """Raw data tensor (a 0-d tensor for scalars, broadcasting)."""
    if isinstance(v, DevScalar):
        return v.value
    if v.data is None:
        raise NotImplementedError(
            "string values in arithmetic/comparisons are not ported yet")
    return v.data


def walk(expr: Expression):
    yield expr
    for c in expr.children:
        yield from walk(c)


def first_unsupported(expr: Expression, schema: Schema) -> Optional[str]:
    """The first node (pre-order) that cannot run on the device, as a
    reason string, or None."""
    for node in walk(expr):
        reason = node.device_supported(schema)
        if reason is None and type(node).eval_device is Expression.eval_device:
            reason = "has no TPU implementation"
        if reason is not None:
            if reason == "has no TPU implementation":
                return f"{node.pretty_name} has no TPU implementation"
            return f"{node.pretty_name}: {reason}"
    return None
