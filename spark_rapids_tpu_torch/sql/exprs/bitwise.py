"""Bitwise expressions (counterpart of the JAX package's
``sql/exprs/bitwise.py``): and, or, xor, not and the three shifts, over
integral operands only. Shifts follow Java: the amount is masked to the
operand's width (63 for a long, 31 otherwise) and the result keeps the
left operand's type.

torch has no unsigned 64-bit shift, so ``>>>`` is an arithmetic shift
masked with (1 << (width - k)) - 1 in the signed type, which gives the
same bits. One torch formula serves the device and the host path (there
over CPU tensors).
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.sql.exprs.arithmetic import (
    BinaryArithmetic, _UnaryArithmetic,
)


class BinaryBitwise(BinaryArithmetic):
    def __repr__(self) -> str:
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        for c in self.children:
            if not c.dtype(schema).is_integral:
                return (f"bitwise {self.symbol} requires integral operands, "
                        f"got {c.dtype(schema)}")
        return None


class BitwiseAnd(BinaryBitwise):
    symbol = "&"

    def compute(self, a, b):
        return a & b, None


class BitwiseOr(BinaryBitwise):
    symbol = "|"

    def compute(self, a, b):
        return a | b, None


class BitwiseXor(BinaryBitwise):
    symbol = "^"

    def compute(self, a, b):
        return a ^ b, None


class _Shift(BinaryBitwise):
    """The left operand's type; the amount masked to its width."""

    def dtype_from_children(self, lt: DType, rt: DType) -> DType:
        return lt

    @staticmethod
    def _mask(a: torch.Tensor) -> int:
        return 63 if a.dtype == torch.int64 else 31


class ShiftLeft(_Shift):
    symbol = "<<"

    def compute(self, a, b):
        return a << (b & self._mask(a)), None


class ShiftRight(_Shift):
    symbol = ">>"

    def compute(self, a, b):
        return a >> (b & self._mask(a)), None


class ShiftRightUnsigned(_Shift):
    symbol = ">>>"

    def compute(self, a, b):
        return logical_shift_right(a, b & self._mask(a)), None


def logical_shift_right(a: torch.Tensor, k) -> torch.Tensor:
    """Unsigned ``a >>> k`` (0 <= k < width; an int or a tensor) in a
    signed integer type: the arithmetic shift with its sign-filled high
    bits cleared."""
    width = 64 if a.dtype == torch.int64 else 32
    if isinstance(k, int):
        return a if k == 0 else (a >> k) & ((1 << (width - k)) - 1)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    # k == 0 would shift one by the full width: the mask is all ones then
    mask = torch.where(k == 0, -one, (one << (width - k).clamp(max=width - 1))
                       - one)
    return (a >> k) & mask


class BitwiseNot(_UnaryArithmetic):
    fname = "~"

    def __repr__(self) -> str:
        return f"~{self.children[0]!r}"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if not self.children[0].dtype(schema).is_integral:
            return "bitwise ~ requires an integral operand"
        return None

    def compute(self, x):
        return torch.bitwise_not(x)

