"""hash() and hex() (counterpart of the JAX package's
``sql/exprs/miscexprs.py``; reference: Spark's Murmur3Hash / Hex, used
by the Mortgage workload's loan anonymization,
integration_tests/.../mortgage/MortgageSpark.scala:370,394).

hash() is the framework's own 64 -> 32-bit mixer (splitmix64 over
fixed-width bits, the dual polynomial hashes for strings,
``ops/hashing.py``), NOT Spark's murmur3_32: the contract the workloads
need is "deterministic, well mixed, identical on the CPU and the device",
and the port's torch and numpy twins give the JAX package's bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.ops import hashing
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
)


class Hash(Expression):
    """hash(c1, c2, ...) -> INT32, never NULL (a NULL input feeds a fixed
    sentinel into the mix)."""

    def __init__(self, children):
        super().__init__(list(children))

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def __repr__(self) -> str:
        return f"hash({', '.join(map(repr, self.children))})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        hs = []
        for c in self.children:
            v = ctx.broadcast(c.eval_device(ctx))
            if v.dtype.is_string:
                hs.append(hashing.hash_string_col(v))
            else:
                hs.append(hashing.hash_fixed_width(v.data, v.validity))
        # the low 32 bits, as the JAX package's uint64 -> uint32 -> int32
        low = hashing.combine_hashes(hs) & 0xFFFFFFFF
        data = torch.where(low >= 1 << 31, low - (1 << 32), low).to(
            torch.int32)
        return DevCol(dtypes.INT32, data, torch.ones_like(v.validity))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        hs = []
        index = df.index
        for c in self.children:
            s = c.eval_host(df)
            values, validity, index = host_unary_values(s)
            if values.dtype == object or str(values.dtype) in ("str",
                                                               "string"):
                hs.append(hashing.np_string_hashes(list(values), validity))
                continue
            if s.attrs.get("srt_logical_dtype") == "date32":
                # host dates ride as midnight micros; the device hashes
                # the day number
                values = values.astype(np.int64) // 86_400_000_000
            hs.append(hashing.np_hash_fixed_width(values, validity))
        combined = hashing.np_combine_hashes(hs)
        data = np.asarray(combined).astype(np.uint32).view(np.int32)
        return rebuild_series(data, np.ones(len(data), np.bool_),
                              dtypes.INT32, index)


class Hex(Expression):
    """hex(n) -> uppercase hex string (negatives as 16-digit two's
    complement, Spark semantics). It produces variable-length strings, so
    it runs on the CPU, tagged with the JAX package's reason."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"hex({self.children[0]!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        return "hex produces variable-length strings; runs on CPU"

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = (format(int(v) & 0xFFFFFFFFFFFFFFFF, "X")
                      if validity[i] else None)
        return rebuild_series(out, validity, dtypes.STRING, index)
