"""Nondeterministic expressions (counterpart of the JAX package's
``sql/exprs/nondet.py``; reference: GpuRandomExpressions.scala,
GpuMonotonicallyIncreasingID.scala, GpuSparkPartitionID.scala,
GpuInputFileBlock.scala): ``rand``, ``spark_partition_id``,
``monotonically_increasing_id`` and ``input_file_name``.

They read task-scoped state (the partition index, the rows earlier
batches of the partition emitted, the current input file) from
``exec/taskctx.py``, which the projection or filter evaluating them sets
for each batch (``has_nondeterministic`` tells it to).

``Rand`` is the JAX package's stateless splitmix64 counter hash of (seed,
partition, row index): the top 53 bits of the mix over 2^53, bit-equal to
the JAX package's stream for the same partitions and rows. torch has no
unsigned 64-bit shift, so the mix runs in int64: multiplication and xor
give the same bits mod 2^64, and a logical right shift is the arithmetic
one masked (``bitwise.logical_shift_right``).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.exec import taskctx
from spark_rapids_tpu_torch.sql.exprs.bitwise import logical_shift_right
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevScalar, DevValue, EvalContext, Expression, walk,
)


def _signed64(u: int) -> int:
    """The int64 with the bits of the unsigned 64-bit ``u``."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >> 63 else u


_GOLDEN = _signed64(0x9E3779B97F4A7C15)
_MIX1 = _signed64(0xBF58476D1CE4E5B9)
_MIX2 = _signed64(0x94D049BB133111EB)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 bit patterns."""
    x = x + _GOLDEN
    x = (x ^ logical_shift_right(x, 30)) * _MIX1
    x = (x ^ logical_shift_right(x, 27)) * _MIX2
    return x ^ logical_shift_right(x, 31)


class Rand(Expression):
    """rand(seed): a uniform double in [0, 1), a function of (seed,
    partition index, row position in the partition)."""

    is_nondeterministic = True

    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed = int(seed)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.FLOAT64

    def __repr__(self) -> str:
        return f"rand({self.seed})"

    def _uniform(self, idx: torch.Tensor) -> torch.Tensor:
        key = _signed64(self.seed) ^ _signed64(taskctx.partition_id() << 32)
        mixed = splitmix64(idx ^ key)
        # the top 53 bits: a double in [0, 1)
        return logical_shift_right(mixed, 11).to(torch.float64) \
            / float(1 << 53)

    def eval_device(self, ctx: EvalContext) -> DevValue:
        idx = torch.arange(ctx.capacity, dtype=torch.int64,
                           device=ctx.device) + taskctx.row_base()
        data = self._uniform(idx)
        return DevCol(dtypes.FLOAT64, data, torch.ones_like(ctx.row_mask))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        idx = torch.arange(len(df), dtype=torch.int64) + taskctx.row_base()
        return pd.Series(self._uniform(idx).numpy(), index=df.index)


class SparkPartitionID(Expression):
    """spark_partition_id()."""

    is_nondeterministic = True

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def __repr__(self) -> str:
        return "SPARK_PARTITION_ID()"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        pid = torch.full((ctx.capacity,), taskctx.partition_id(),
                         dtype=torch.int32, device=ctx.device)
        return DevCol(dtypes.INT32, pid, torch.ones_like(ctx.row_mask))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        return pd.Series(np.full(len(df), taskctx.partition_id(),
                                 dtype=np.int32), index=df.index)


class MonotonicallyIncreasingID(Expression):
    """(partition index << 33) + the row's position in its partition,
    Spark's layout."""

    is_nondeterministic = True

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT64

    def __repr__(self) -> str:
        return "monotonically_increasing_id()"

    @staticmethod
    def _base() -> int:
        return (taskctx.partition_id() << 33) + taskctx.row_base()

    def eval_device(self, ctx: EvalContext) -> DevValue:
        data = torch.arange(ctx.capacity, dtype=torch.int64,
                            device=ctx.device) + self._base()
        return DevCol(dtypes.INT64, data, torch.ones_like(ctx.row_mask))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        return pd.Series(np.arange(len(df), dtype=np.int64) + self._base(),
                         index=df.index)


class InputFileName(Expression):
    """input_file_name(): the path of the file the batch was read from,
    the empty string elsewhere."""

    is_nondeterministic = True

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return "input_file_name()"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return ctx.broadcast(DevScalar(dtypes.STRING, taskctx.input_file()))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        return pd.Series([taskctx.input_file()] * len(df), dtype="str",
                         index=df.index)


def has_nondeterministic(expr: Expression) -> bool:
    return any(getattr(n, "is_nondeterministic", False) for n in walk(expr))


def reads_input_file(expr: Expression) -> bool:
    return any(isinstance(n, InputFileName) for n in walk(expr))
