"""64-bit hashing (counterpart of the JAX package's ``ops/hashing.py``):
the splitmix64 mixer, fixed-width column hashes, the two polynomial
string hashes of dictionary, char-slab and plain (offsets and chars)
columns, and their combination into row hashes; ``hash_string_col``, the
combined string hash of the ``hash()`` expression, and the numpy twins its
host path uses (copies of the JAX package's). A value hashes to the same
bits in every form.

All values are int64 tensors holding uint64 bit patterns. Adds and
multiplies wrap mod 2^64 exactly like uint64; right shifts are arithmetic
on int64, so a logical shift masks off the sign-extended bits. Results are
bit-identical to the JAX package's uint64 arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dictionary as _dictionary

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


# exponents a plain column's hash raises its multipliers to stay below
# 2^31 (int32 offsets): base^e = LO[e & 0xFFFF] * HI[e >> 16]
_POW_SPLIT = 16


@functools.lru_cache(maxsize=8)
def _pow_tables(base: int):
    """(LO, HI) int64 numpy tables of base^e for e < 2^16 and of
    base^(e * 2^16) for e < 2^15, uint64 powers as int64."""
    lo, acc = [], 1
    for _ in range(1 << _POW_SPLIT):
        lo.append(as_signed(acc))
        acc = (acc * base) & _M64
    step, hi, acc = acc, [], 1
    for _ in range(1 << (31 - _POW_SPLIT)):
        hi.append(as_signed(acc))
        acc = (acc * step) & _M64
    return np.asarray(lo, np.int64), np.asarray(hi, np.int64)


def _pow(tables, e: torch.Tensor) -> torch.Tensor:
    """base^e (mod 2^64) for int64 exponents 0 <= e < 2^31."""
    lo, hi = tables
    return lo[e & ((1 << _POW_SPLIT) - 1)] * hi[e >> _POW_SPLIT]


def string_poly_hashes(offsets: torch.Tensor, chars: torch.Tensor,
                       validity: torch.Tensor):
    """The two polynomial hashes of a plain string column (the JAX
    package's ``string_poly_hashes``, bit for bit): a row of bytes c_j and
    length L at char offset s hashes sum c_j p^(L-1-j), computed as
    p^(L-1+s) * sum c_i q^i over its global char positions i (q = 1/p mod
    2^64), one segment sum a salt over the chars in blocks of CHAR_BLOCK,
    no per-row loop and no host wait."""
    from spark_rapids_tpu_torch.columnar.column import (
        CHAR_BLOCK, char_rows, host_to_device,
    )
    dev = chars.device
    cap = offsets.shape[0] - 1
    starts = offsets[:-1].to(torch.int64)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    total = offsets[-1]
    nchars = int(chars.shape[0])
    out = []
    for p, q, salt in ((P1, Q1, SALT1), (P2, Q2, SALT2)):
        qt = tuple(host_to_device(t, dev) for t in _pow_tables(q))
        pt = tuple(host_to_device(t, dev) for t in _pow_tables(p))
        acc = torch.zeros(cap, dtype=torch.int64, device=dev)
        for lo in range(0, nchars, CHAR_BLOCK):
            hi = min(lo + CHAR_BLOCK, nchars)
            i = torch.arange(lo, hi, dtype=torch.int64, device=dev)
            term = chars[lo:hi].to(torch.int64) * _pow(qt, i)
            term = torch.where(i < total, term, torch.zeros_like(term))
            acc.index_add_(0, char_rows(offsets, lo, hi), term)
        e = (lens - 1 + starts).clamp(min=0)
        h = splitmix64(acc * _pow(pt, e) + as_signed(salt) + lens)
        out.append(torch.where(validity, h,
                               torch.full_like(h, as_signed(NULL_HASH))))
    return out[0], out[1]


def string_poly_hashes_col(col):
    """The two polynomial hashes of a string column: a dictionary column
    gathers its per-value tables by code (``columnar/dictionary.py``), a
    slab column hashes its words (under ``dict.hashValues=false`` a
    dictionary column hashes its decoded chars). All are bit-identical to
    the JAX package's char-scanning hashes of the same values. The
    packed-chars layout hashes its chars (``string_poly_hashes``)."""
    from spark_rapids_tpu_torch.columnar import dictionary
    from spark_rapids_tpu_torch.columnar.column import (
        host_to_device, plain_parts,
    )
    if col.dict_values is not None and col.dict_codes is not None:
        if not dictionary.hash_values_enabled():
            # spark.rapids.sql.dict.hashValues=false: the same values from
            # the decoded chars
            chars, offsets = plain_parts(col)
            return string_poly_hashes(offsets, chars, col.validity)
        from spark_rapids_tpu_torch.columnar.dictionary import (
            value_hash_tables,
        )
        card = len(col.dict_values)
        code = col.dict_codes.to(torch.int64).clamp(0, card)
        null_h = torch.full(code.shape, as_signed(NULL_HASH),
                            dtype=torch.int64, device=code.device)
        return tuple(
            torch.where(col.validity, host_to_device(t, code.device)[code],
                        null_h)
            for t in value_hash_tables(col.dict_values))
    if col.slab64 is not None:
        return slab_poly_hashes(col.slab64, col.lens, col.validity)
    return string_poly_hashes(col.offsets, col.chars, col.validity)


def hash_string_col(col) -> torch.Tensor:
    """One combined 64-bit hash per string row, splitmix64(h1 ^ h2) of the
    two polynomial hashes (``string_poly_hashes_col``: a dictionary's
    per-value tables gathered by code, a slab's words), NULL_HASH where
    invalid; bit-identical to the JAX package's ``hash_string_col`` and to
    ``np_string_hashes``."""
    h1, h2 = string_poly_hashes_col(col)
    return torch.where(col.validity, splitmix64(h1 ^ h2),
                       torch.full_like(h1, as_signed(NULL_HASH)))


# --- numpy twins (the host expression path) ---------------------------------
# Copies of the JAX package's: the same constants and bit-for-bit results
# as the torch versions above, so hash() agrees between the CPU operators
# and the device ones. uint64 numpy arrays (``np_splitmix64`` is
# ``columnar/dictionary``'s).

from spark_rapids_tpu_torch.columnar.dictionary import (  # noqa: E402
    np_splitmix64,
)

def np_f64_bits(f: np.ndarray) -> np.ndarray:
    """Normalize (-0.0 and denormals -> +0.0, NaN -> canonical) then view:
    the host twin of ``ops/floatbits.f64_bits``."""
    f64 = np.asarray(f, dtype=np.float64).copy()
    f64[np.abs(f64) < 2.0 ** -1022] = 0.0
    f64[np.isnan(f64)] = np.nan
    return f64.view(np.uint64)


def np_hash_fixed_width(data: np.ndarray, validity: np.ndarray) -> np.ndarray:
    if data.dtype == np.bool_:
        bits = data.astype(np.uint64)
    elif np.issubdtype(data.dtype, np.floating):
        bits = np_f64_bits(data)
    else:
        bits = data.astype(np.int64).view(np.uint64)
    h = np_splitmix64(bits)
    return np.where(validity, h, np.uint64(NULL_HASH))


def np_string_hashes(values, validity: np.ndarray) -> np.ndarray:
    """Combined (splitmix64 of h1 ^ h2) hash per row of python strings,
    NULL_HASH where invalid. Horner passes run on plain Python ints
    (masked to 64 bits), ~100x cheaper than boxed numpy uint64 scalars."""
    acc1 = np.empty(len(values), dtype=np.uint64)
    acc2 = np.empty(len(values), dtype=np.uint64)
    lens = np.empty(len(values), dtype=np.uint64)
    live = np.asarray(validity, dtype=bool).copy()
    for i, v in enumerate(values):
        if not live[i] or v is None:
            live[i] = False
            acc1[i] = acc2[i] = lens[i] = 0
            continue
        raw = str(v).encode("utf-8")
        a1 = a2 = 0
        for b in raw:
            a1 = (a1 * P1 + b) & _M64
            a2 = (a2 * P2 + b) & _M64
        acc1[i], acc2[i], lens[i] = a1, a2, len(raw)
    with np.errstate(over="ignore"):
        h1 = np_splitmix64(acc1 + np.uint64(SALT1) + lens)
        h2 = np_splitmix64(acc2 + np.uint64(SALT2) + lens)
    out = np_splitmix64(h1 ^ h2)
    return np.where(live, out, np.uint64(NULL_HASH))


def np_combine_hashes(hs) -> np.ndarray:
    out = np.uint64(COMBINE_SEED)
    for h in hs:
        out = np_splitmix64(np.asarray(out ^ h))
    return out


# the host splitmix64 of the dictionaries' value hashes, under the JAX
# package's name here
np_splitmix64 = _dictionary.np_splitmix64
