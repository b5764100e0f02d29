"""64-bit mixing (counterpart of the JAX package's ``ops/hashing.py``; only
``splitmix64`` is ported).

All values are int64 tensors holding uint64 bit patterns. Adds and
multiplies wrap mod 2^64 exactly like uint64; right shifts are arithmetic
on int64, so a logical shift masks off the sign-extended bits. Results are
bit-identical to the JAX package's uint64 arithmetic.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def as_signed(c: int) -> int:
    """The int64 value holding the uint64 bit pattern ``c``."""
    c &= _M64
    return c - (1 << 64) if c >= 1 << 63 else c


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


_GAMMA = as_signed(0x9E3779B97F4A7C15)
_MUL1 = as_signed(0xBF58476D1CE4E5B9)
_MUL2 = as_signed(0x94D049BB133111EB)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: a strong 64-bit mixer."""
    x = x.to(torch.int64) + _GAMMA
    x = (x ^ srl(x, 30)) * _MUL1
    x = (x ^ srl(x, 27)) * _MUL2
    return x ^ srl(x, 31)
