"""float64 -> IEEE-754 bits (counterpart of the JAX package's
``ops/floatbits.py``).

The JAX package rebuilds the bits arithmetically because its TPU compiler
rejects float64 bitcasts. PyTorch bitcasts on the CPU and the GPU alike
(``Tensor.view(torch.int64)``), so the port normalizes and views. The
normalization is the JAX package's, so the bits are identical: -0.0 and
denormals become +0.0 bits and every NaN becomes the canonical quiet NaN.

Bits are returned as int64 holding the uint64 pattern: torch on the CPU
lacks uint64 shifts, adds and remainders, so the port keeps every 64-bit
image in int64 with wrap-around arithmetic.
"""

from __future__ import annotations

import torch

_CANONICAL_NAN_BITS = 0x7FF8 << 48


def f64_bits(f: torch.Tensor) -> torch.Tensor:
    """int64 holding the IEEE bits of ``f`` as float64, with -0.0 and
    denormals normalized to +0.0 and NaN to the canonical quiet NaN."""
    f = f.to(torch.float64).contiguous()
    bits = f.view(torch.int64)
    bits = torch.where(torch.isnan(f),
                       torch.full_like(bits, _CANONICAL_NAN_BITS), bits)
    return torch.where(f.abs() < 2.0 ** -1022, torch.zeros_like(bits), bits)
