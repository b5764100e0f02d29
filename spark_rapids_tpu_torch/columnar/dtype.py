"""SQL data-type system with mappings to numpy/torch/pyarrow.

Copy of the JAX package's ``columnar/dtype.py`` (the type gate and the
Spark<->cuDF dtype mapping of the reference, GpuOverrides.scala:383-395 and
GpuColumnVector.java:134-199), plus the numpy -> torch dtype map the port
needs. Supported: bool, int8/16/32/64, float32/64, date (int32 days),
timestamp (int64 microseconds, UTC), string.

On device:
  * fixed-width types are one torch tensor of the physical dtype plus a
    validity mask (True = valid);
  * strings are dictionary codes (int32) against a static host tuple of
    values; plain (non-dictionary) strings wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import pyarrow as pa
import torch


@dataclass(frozen=True)
class DType:
    name: str
    np_dtype: Optional[np.dtype]  # physical numpy dtype (None for string)
    pa_type: Any                  # pyarrow logical type
    pandas_nullable: str          # pandas extension dtype name for the host path

    def __repr__(self) -> str:
        return self.name

    @property
    def is_string(self) -> bool:
        return self.name == "string"

    @property
    def is_floating(self) -> bool:
        return self.name in ("float32", "float64")

    @property
    def is_integral(self) -> bool:
        return self.name in ("int8", "int16", "int32", "int64")

    @property
    def is_numeric(self) -> bool:
        return self.is_floating or self.is_integral

    @property
    def is_datetime(self) -> bool:
        return self.name in ("date32", "timestamp_us")

    @property
    def itemsize(self) -> int:
        return 1 if self.is_string else self.np_dtype.itemsize


BOOL = DType("bool", np.dtype(np.bool_), pa.bool_(), "boolean")
INT8 = DType("int8", np.dtype(np.int8), pa.int8(), "Int8")
INT16 = DType("int16", np.dtype(np.int16), pa.int16(), "Int16")
INT32 = DType("int32", np.dtype(np.int32), pa.int32(), "Int32")
INT64 = DType("int64", np.dtype(np.int64), pa.int64(), "Int64")
FLOAT32 = DType("float32", np.dtype(np.float32), pa.float32(), "Float32")
FLOAT64 = DType("float64", np.dtype(np.float64), pa.float64(), "Float64")
# days since unix epoch
DATE32 = DType("date32", np.dtype(np.int32), pa.date32(), "object")
# microseconds since unix epoch, UTC only (reference supports UTC timestamps
# only, GpuOverrides.scala:389-393)
TIMESTAMP_US = DType("timestamp_us", np.dtype(np.int64), pa.timestamp("us"), "object")
STRING = DType("string", None, pa.string(), "str")

ALL_DTYPES = [BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, DATE32,
              TIMESTAMP_US, STRING]
_BY_NAME = {d.name: d for d in ALL_DTYPES}


def by_name(name: str) -> DType:
    return _BY_NAME[name]


def from_arrow(t: pa.DataType) -> DType:
    if pa.types.is_boolean(t): return BOOL
    if pa.types.is_int8(t): return INT8
    if pa.types.is_int16(t): return INT16
    if pa.types.is_int32(t): return INT32
    if pa.types.is_int64(t): return INT64
    if pa.types.is_float32(t): return FLOAT32
    if pa.types.is_float64(t): return FLOAT64
    if pa.types.is_date32(t): return DATE32
    if pa.types.is_timestamp(t): return TIMESTAMP_US
    if pa.types.is_string(t) or pa.types.is_large_string(t): return STRING
    if pa.types.is_decimal(t):
        raise TypeError("decimal is not supported (the reference also lacks "
                        "decimal support at v0)")
    raise TypeError(f"unsupported arrow type: {t}")


def from_numpy(dt: np.dtype) -> DType:
    dt = np.dtype(dt)
    if dt == np.bool_: return BOOL
    if dt == np.int8: return INT8
    if dt == np.int16: return INT16
    if dt == np.int32: return INT32
    if dt == np.int64: return INT64
    if dt == np.float32: return FLOAT32
    if dt == np.float64: return FLOAT64
    if dt.kind == "M":  # datetime64
        if dt == np.dtype("datetime64[D]"):
            return DATE32
        return TIMESTAMP_US
    if dt.kind in ("U", "S", "O"):
        return STRING
    raise TypeError(f"unsupported numpy dtype: {dt}")


def common_type(a: DType, b: DType) -> DType:
    """Numeric type promotion following Spark's binary-op coercion."""
    if a == b:
        return a
    order = [INT8, INT16, INT32, INT64, FLOAT32, FLOAT64]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    if BOOL in (a, b):
        other = b if a == BOOL else a
        if other in order:
            return other
    if {a, b} == {DATE32, TIMESTAMP_US}:
        return TIMESTAMP_US  # Spark widens date to timestamp
    raise TypeError(f"no common type for {a} and {b}")


def null_fill_value(d: DType):
    """Canonical value stored in invalid slots so device math is deterministic."""
    if d == BOOL:
        return False
    if d.is_floating:
        return 0.0
    return 0


_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype holding a physical numpy dtype on the device."""
    return _TORCH[np.dtype(np_dtype)]
