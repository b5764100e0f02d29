"""64-bit hashing (counterpart of the JAX package's ``ops/hashing.py``):
the splitmix64 mixer, fixed-width column hashes, the two polynomial
string hashes of dictionary and char-slab columns, and their combination
into row hashes. The packed-chars ``string_poly_hashes`` and the numpy
twins of the host expression path wait for the string slice (ROADMAP A.5).

All values are int64 tensors holding uint64 bit patterns. Adds and
multiplies wrap mod 2^64 exactly like uint64; right shifts are arithmetic
on int64, so a logical shift masks off the sign-extended bits. Results are
bit-identical to the JAX package's uint64 arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
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


# FNV-64 prime and a second independent odd multiplier, and their salts
P1 = 1099511628211
P2 = 6364136223846793005
SALT1 = 14695981039346656037  # FNV offset basis
SALT2 = 9600629759793949339
# modular inverses of the poly multipliers (both odd, so invertible mod
# 2^64): the slab hash evaluates sum c_j * q^j densely over the words and
# multiplies by p^(len-1) once per row, bit-identical to the char-path
# polynomial
Q1 = pow(P1, -1, 1 << 64)
Q2 = pow(P2, -1, 1 << 64)
NULL_HASH = 0x7E57AB1E5EED5EED
COMBINE_SEED = 0x243F6A8885A308D3


def hash_fixed_width(data: torch.Tensor,
                     validity: torch.Tensor) -> torch.Tensor:
    """64-bit hash of a fixed-width column; nulls hash to NULL_HASH. Floats
    hash their normalized bits (-0.0 == 0.0, one NaN), as grouping needs."""
    if data.dtype == torch.bool:
        bits = data.to(torch.int64)
    elif data.dtype.is_floating_point:
        from spark_rapids_tpu_torch.ops.floatbits import f64_bits
        bits = f64_bits(data)
    else:
        bits = data.to(torch.int64)
    return torch.where(validity, splitmix64(bits),
                       torch.full_like(bits, as_signed(NULL_HASH)))


def combine_hashes(hs) -> torch.Tensor:
    """Combine per-column 64-bit hashes into one row hash."""
    out = None
    for h in hs:
        seed = (torch.full_like(h, as_signed(COMBINE_SEED)) if out is None
                else out)
        out = splitmix64(seed ^ h)
    return out


@functools.lru_cache(maxsize=64)
def _slab_tables(stride: int):
    """Per salt: (q^j for j < stride, p^(l-1) for l <= stride) as int64
    numpy arrays holding the uint64 powers."""
    out = []
    for p, q, salt in ((P1, Q1, SALT1), (P2, Q2, SALT2)):
        qtab, acc = [], 1
        for _ in range(stride):
            qtab.append(as_signed(acc))
            acc = (acc * q) & _M64
        ptab, acc = [1], 1  # len 0 -> the sum is 0, multiplier irrelevant
        for _ in range(stride):
            ptab.append(as_signed(acc))
            acc = (acc * p) & _M64
        out.append((np.asarray(qtab, np.int64), np.asarray(ptab, np.int64),
                    as_signed(salt)))
    return tuple(out)


def slab_poly_hashes(slab64: torch.Tensor, lens: torch.Tensor,
                     validity: torch.Tensor):
    """The two polynomial hashes of a char-slab string column, from its
    words: dense ops only, no per-char gathers. Bit-identical to the JAX
    package's ``slab_poly_hashes`` (bytes past a row's length are zero by
    the slab invariant, so they add nothing to the q-polynomial)."""
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    cap, w = int(slab64.shape[0]), int(slab64.shape[1])
    stride = w * 8
    dev = slab64.device
    lens_c = lens.to(torch.int64).clamp(0, stride)
    out = []
    for qtab, ptab, salt in _slab_tables(stride):
        qt = host_to_device(qtab, dev).view(w, 8)
        s = torch.zeros(cap, dtype=torch.int64, device=dev)
        for b in range(8):  # byte j of a row: bit 8*(j%8) of word j//8
            s += (((slab64 >> (8 * b)) & 0xFF) * qt[:, b]).sum(dim=1)
        pl = host_to_device(ptab, dev)[lens_c]
        h = splitmix64(s * pl + salt + lens_c)
        out.append(torch.where(validity, h,
                               torch.full_like(h, as_signed(NULL_HASH))))
    return out[0], out[1]


def string_poly_hashes_col(col):
    """The two polynomial hashes of a string column: a dictionary column
    gathers its per-value tables by code (``columnar/dictionary.py``), a
    slab column hashes its words. Both are bit-identical to the JAX
    package's char-scanning hashes of the same values. The packed-chars
    layout is not ported (ROADMAP A.5)."""
    from spark_rapids_tpu_torch.columnar.column import (
        host_to_device, plain_strings_unsupported,
    )
    if col.dict_values is not None and col.dict_codes is not None:
        from spark_rapids_tpu_torch.columnar.dictionary import (
            value_hash_tables,
        )
        card = len(col.dict_values)
        code = col.dict_codes.to(torch.int64).clamp(0, card)
        null_h = torch.full(code.shape, as_signed(NULL_HASH),
                            dtype=torch.int64, device=code.device)
        return tuple(
            torch.where(col.validity, host_to_device(t, col.device)[code],
                        null_h)
            for t in value_hash_tables(col.dict_values))
    if col.has_slab:
        return slab_poly_hashes(col.slab64, col.lens, col.validity)
    raise plain_strings_unsupported("string_poly_hashes_col")
