"""String operations on device columns (counterpart of the JAX package's
``ops/strings.py``): equality and three-way comparison against a literal
or another column, ``starts_with``, ``ends_with``, ``contains``,
``substring`` and the value tables of ``In``.

A string column reaches device code in one of two forms, and every
operation here serves both:

  * dictionary codes (``dict_codes`` against ``dict_values``, a host tuple
    in canonical sorted order, code == card the NULL sentinel): the
    operation runs over the dictionary's values on the host, once per
    dictionary (memoized), into a table of card + 1 entries that the codes
    gather on the device. No char is read on the device, and no value is
    read from it;
  * a char slab (``slab64`` int64 (capacity, stride/8), row i's byte j at
    bit 8*(j%8) of word j//8, zero past ``lens[i]``): the operation reads
    the row's bytes (``slab64.view(torch.uint8)``) or its words.

The JAX package computes these over its (offsets, chars) layout in jnp,
outside any Pallas kernel; the port's are elementwise torch code as well.
Byte order is the comparison order (UTF-8 byte order equals code-point
order, the order of Python's ``str`` comparison and of the dictionaries).
"""

from __future__ import annotations

import bisect
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, host_to_device, slab_stride_for,
)
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevScalar, DevValue, EvalContext,
)

_SIGN = -(1 << 63)  # int64 with only the sign bit set


def _validity(ctx: EvalContext, v: DevValue) -> torch.Tensor:
    if isinstance(v, DevScalar):
        return torch.full((ctx.capacity,), bool(v.valid), dtype=torch.bool,
                          device=ctx.device)
    return v.validity


def _is_dict(col: DevCol) -> bool:
    return col.dict_values is not None and col.dict_codes is not None


def _require_form(col: DevCol, what: str) -> None:
    if not _is_dict(col) and col.slab64 is None:
        raise NotImplementedError(
            f"{what}: a string column needs dictionary codes or a char "
            "slab; the packed-chars layout is not ported (ROADMAP A.5)")


def _signed64(u: int) -> int:
    """A uint64 bit pattern as the int64 holding it."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


# ---------------------------------------------------------------------------
# Dictionary columns: host tables gathered by code
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _dict_table(dict_values: tuple, kind: str, arg) -> np.ndarray:
    """bool (card + 1,): the predicate ``kind`` of each dictionary value;
    the NULL sentinel's entry is False."""
    fn: Callable[[str], bool] = {
        "eq": lambda v: v == arg,
        "starts": lambda v: v.startswith(arg),
        "ends": lambda v: v.endswith(arg),
        "contains": lambda v: arg in v,
        "in": lambda v: v in arg,
    }[kind]
    out = np.zeros(len(dict_values) + 1, np.bool_)
    for i, v in enumerate(dict_values):
        out[i] = fn(v)
    return out


def _gather_table(col: DevCol, table: np.ndarray) -> torch.Tensor:
    card = len(col.dict_values)
    dev = host_to_device(table, col.validity.device)
    return dev[col.dict_codes.to(torch.int64).clamp(0, card)]


def dict_predicate(col: DevCol, kind: str, arg) -> torch.Tensor:
    """The predicate ``kind`` (eq, starts, ends, contains, in) with ``arg``
    over a dictionary column: one host table gathered by code."""
    return _gather_table(col, _dict_table(col.dict_values, kind, arg))


# ---------------------------------------------------------------------------
# Char slabs: bytes and words
# ---------------------------------------------------------------------------

def _slab_bytes(col: DevCol) -> torch.Tensor:
    """uint8 (capacity, stride): row i's bytes in order."""
    return col.slab64.contiguous().view(torch.uint8).view(
        col.slab64.shape[0], -1)


def _stride(col: DevCol) -> int:
    return int(col.slab64.shape[1]) * 8


def _match_prefix(b: torch.Tensor, pat: bytes) -> torch.Tensor:
    """bool (rows,): the first len(pat) bytes of each row of ``b`` equal
    ``pat`` (m shifted byte compares)."""
    out = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    for j, c in enumerate(pat):
        out &= b[:, j] == c
    return out


def _slab_equal_literal(col: DevCol, pat: bytes) -> torch.Tensor:
    """Row bytes == ``pat``: the literal's words, zero-padded to the
    stride, against the row's, and the lengths. A literal longer than the
    stride matches no row."""
    stride = _stride(col)
    if len(pat) > stride:
        return torch.zeros_like(col.validity)
    padded = pat.ljust(stride, b"\0")
    eq = col.lens == len(pat)
    for w in range(stride // 8):
        word = int.from_bytes(padded[8 * w:8 * w + 8], "little", signed=True)
        eq &= col.slab64[:, w] == word
    return eq


def _be_words(col: DevCol, nwords: int):
    """The row's big-endian word images (unsigned order = byte order) with
    the sign bit flipped, so that int64 order is the bytes' order; words
    past the slab's width are zero images."""
    from spark_rapids_tpu_torch.ops.sortops import bswap64
    w = int(col.slab64.shape[1])
    zero = torch.full((col.slab64.shape[0],), _SIGN, dtype=torch.int64,
                      device=col.slab64.device)
    return [bswap64(col.slab64[:, i]) ^ _SIGN if i < w else zero
            for i in range(nwords)]


def _fold_compare(a_words, b_words, len_cmp: torch.Tensor) -> torch.Tensor:
    """Lexicographic int8 sign over word images (first differing word
    decides), ties broken by ``len_cmp``. ``b_words`` may hold python
    ints (a literal's words)."""
    cmp = len_cmp.to(torch.int8)
    one = torch.ones((), dtype=torch.int8, device=cmp.device)
    for a, b in zip(reversed(a_words), reversed(b_words)):
        cmp = torch.where(a < b, -one, torch.where(a > b, one, cmp))
    return cmp


def _slab_compare_literal(col: DevCol, pat: bytes) -> torch.Tensor:
    nwords = _stride(col) // 8
    # a literal longer than the stride: its first stride bytes decide,
    # then the length (every row is shorter)
    padded = pat[:nwords * 8].ljust(nwords * 8, b"\0")
    lit_words = [_signed64(int.from_bytes(padded[8 * w:8 * w + 8], "big")
                          ^ (1 << 63)) for w in range(nwords)]
    return _fold_compare(_be_words(col, nwords), lit_words,
                         torch.sign(col.lens.to(torch.int64) - len(pat)))


def _dict_as_slab(col: DevCol, stride: int) -> DevCol:
    """A dictionary column as a char slab of ``stride`` bytes (its values'
    slab built on the host, gathered by code)."""
    from spark_rapids_tpu_torch.ops.rowops import dict_to_slab
    c = dict_to_slab(DeviceColumn(col.dtype, None, col.validity,
                                  col.dict_codes, col.dict_values), stride)
    return DevCol(col.dtype, None, col.validity, slab64=c.slab64,
                  lens=c.lens)


def _max_value_len(values: tuple) -> int:
    return max((len(v.encode("utf-8")) for v in values), default=0)


# ---------------------------------------------------------------------------
# Equality and comparison
# ---------------------------------------------------------------------------

def string_equal_literal(ctx: EvalContext, col: DevCol,
                         lit: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """col == literal. Returns (eq bool vec, validity). A dictionary
    column compares codes against the literal's code, found on the host
    (a literal the dictionary lacks matches no row); a slab compares
    words and the length."""
    _require_form(col, "string_equal_literal")
    if _is_dict(col):
        try:
            code = col.dict_values.index(lit)
        except ValueError:
            return torch.zeros_like(col.validity), col.validity
        return col.dict_codes == code, col.validity
    return _slab_equal_literal(col, lit.encode("utf-8")), col.validity


def string_compare_literal(ctx: EvalContext, col: DevCol,
                           lit: str) -> torch.Tensor:
    """Exact per-row sign of col <=> literal in byte order, int8 in {-1, 0,
    1}. A dictionary column compares codes against the literal's
    insertion points in its sorted values (found with ``bisect`` on the
    host); a slab compares big-endian word images, then lengths."""
    _require_form(col, "string_compare_literal")
    if _is_dict(col):
        lo = bisect.bisect_left(col.dict_values, lit)
        hi = bisect.bisect_right(col.dict_values, lit)
        codes = col.dict_codes
        one = torch.ones((), dtype=torch.int8, device=codes.device)
        return torch.where(codes < lo, -one,
                           torch.where(codes >= hi, one, 0 * one))
    return _slab_compare_literal(col, lit.encode("utf-8"))


def string_compare_columns(lv: DevCol, rv: DevCol) -> torch.Tensor:
    """Exact per-row sign of lv <=> rv in byte order, int8. Two
    dictionaries compare codes remapped into their union (sorted, so codes
    order as values); two slabs compare word images at the wider stride,
    then lengths; a dictionary against a slab becomes a slab first."""
    _require_form(lv, "string_compare_columns")
    _require_form(rv, "string_compare_columns")
    if _is_dict(lv) and _is_dict(rv):
        a, b = lv.dict_codes, rv.dict_codes
        if lv.dict_values != rv.dict_values:
            from spark_rapids_tpu_torch.columnar.dictionary import (
                union_dictionaries,
            )
            _u, (ra, rb) = union_dictionaries([lv.dict_values,
                                               rv.dict_values])
            a = _gather_table(lv, ra)
            b = _gather_table(rv, rb)
        return torch.sign(a.to(torch.int64) - b.to(torch.int64)).to(
            torch.int8)
    if _is_dict(lv):
        lv = _dict_as_slab(lv, max(_stride(rv), slab_stride_for(
            _max_value_len(lv.dict_values), 1 << 30)))
    if _is_dict(rv):
        rv = _dict_as_slab(rv, max(_stride(lv), slab_stride_for(
            _max_value_len(rv.dict_values), 1 << 30)))
    nwords = max(_stride(lv), _stride(rv)) // 8
    return _fold_compare(_be_words(lv, nwords), _be_words(rv, nwords),
                         torch.sign(lv.lens.to(torch.int64)
                                    - rv.lens.to(torch.int64)))


def string_equal(ctx: EvalContext, lv: DevValue, rv: DevValue
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """String equality, column/literal either way round, literal/literal or
    column/column. Returns (eq bool vec, validity)."""
    if isinstance(rv, DevScalar) and isinstance(lv, DevCol):
        eq, _ = string_equal_literal(ctx, lv, str(rv.value))
        return eq, lv.validity & _validity(ctx, rv)
    if isinstance(lv, DevScalar) and isinstance(rv, DevCol):
        eq, _ = string_equal_literal(ctx, rv, str(lv.value))
        return eq, rv.validity & _validity(ctx, lv)
    if isinstance(lv, DevScalar) and isinstance(rv, DevScalar):
        eq = torch.full((ctx.capacity,), lv.value == rv.value,
                        dtype=torch.bool, device=ctx.device)
        return eq, _validity(ctx, lv) & _validity(ctx, rv)
    if (_is_dict(lv) and _is_dict(rv)
            and lv.dict_values == rv.dict_values):
        return lv.dict_codes == rv.dict_codes, lv.validity & rv.validity
    return (string_compare_columns(lv, rv) == 0,
            lv.validity & rv.validity)


def string_compare(ctx: EvalContext, lv: DevValue, rv: DevValue
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three-way string compare, column/literal either way round,
    literal/literal or column/column. Returns (cmp int8 vec, validity)."""
    validity = _validity(ctx, lv) & _validity(ctx, rv)
    if isinstance(rv, DevScalar) and isinstance(lv, DevCol):
        return string_compare_literal(ctx, lv, str(rv.value)), validity
    if isinstance(lv, DevScalar) and isinstance(rv, DevCol):
        return -string_compare_literal(ctx, rv, str(lv.value)), validity
    if isinstance(lv, DevScalar) and isinstance(rv, DevScalar):
        a, b = str(lv.value), str(rv.value)
        c = -1 if a < b else (1 if a > b else 0)
        return torch.full((ctx.capacity,), c, dtype=torch.int8,
                          device=ctx.device), validity
    return string_compare_columns(lv, rv), validity


# ---------------------------------------------------------------------------
# Literal-pattern predicates
# ---------------------------------------------------------------------------

def starts_with(ctx: EvalContext, col: DevCol, lit: str):
    """Returns (bool vec, validity)."""
    _require_form(col, "starts_with")
    if not lit:
        return torch.ones_like(col.validity), col.validity
    if _is_dict(col):
        return dict_predicate(col, "starts", lit), col.validity
    pat = lit.encode("utf-8")
    if len(pat) > _stride(col):
        return torch.zeros_like(col.validity), col.validity
    return (_match_prefix(_slab_bytes(col), pat) & (col.lens >= len(pat)),
            col.validity)


def ends_with(ctx: EvalContext, col: DevCol, lit: str):
    """Returns (bool vec, validity). A slab row's last m bytes are read at
    len - m."""
    _require_form(col, "ends_with")
    if not lit:
        return torch.ones_like(col.validity), col.validity
    if _is_dict(col):
        return dict_predicate(col, "ends", lit), col.validity
    pat = lit.encode("utf-8")
    m, stride = len(pat), _stride(col)
    if m > stride:
        return torch.zeros_like(col.validity), col.validity
    b = _slab_bytes(col)
    start = (col.lens.to(torch.int64) - m).clamp(min=0)
    idx = (start[:, None] + torch.arange(m, device=b.device)[None, :]
           ).clamp(max=stride - 1)
    return (_match_prefix(torch.gather(b, 1, idx), pat)
            & (col.lens >= m), col.validity)


def contains(ctx: EvalContext, col: DevCol, lit: str):
    """Returns (bool vec, validity). Over a slab: a match at position p
    compares m shifted byte windows, and a row matches where some p <=
    len - m does."""
    _require_form(col, "contains")
    if not lit:
        return torch.ones_like(col.validity), col.validity
    if _is_dict(col):
        return dict_predicate(col, "contains", lit), col.validity
    pat = lit.encode("utf-8")
    m, stride = len(pat), _stride(col)
    npos = stride - m + 1
    if npos <= 0:
        return torch.zeros_like(col.validity), col.validity
    b = _slab_bytes(col)
    hit = b[:, 0:npos] == pat[0]
    for j in range(1, m):
        hit &= b[:, j:j + npos] == pat[j]
    last = (col.lens.to(torch.int64) - m)[:, None]
    hit &= torch.arange(npos, device=b.device)[None, :] <= last
    return hit.any(dim=1), col.validity


# ---------------------------------------------------------------------------
# substring
# ---------------------------------------------------------------------------

def host_substring(x: str, pos: int, length: int) -> str:
    """Spark substring of one value: 1-based ``pos``, negative counts from
    the end, ``length`` < 0 to the end; byte-oriented (ASCII-exact)."""
    b = x.encode("utf-8")
    if pos > 0:
        start = min(pos - 1, len(b))
    elif pos == 0:
        start = 0
    else:
        start = max(len(b) + pos, 0)
    end = len(b) if length < 0 else min(start + length, len(b))
    return b[start:max(end, start)].decode("utf-8", errors="replace")


@functools.lru_cache(maxsize=256)
def _dict_substring(dict_values: tuple, pos: int, length: int):
    """(new canonical sorted values, int32 old code -> new code table of
    card + 1 entries, the NULL sentinel to the new one)."""
    subs = [host_substring(v, pos, length) for v in dict_values]
    new = tuple(sorted(set(subs)))
    at = {v: i for i, v in enumerate(new)}
    table = np.empty(len(dict_values) + 1, np.int32)
    table[:len(subs)] = [at[s] for s in subs]
    table[len(subs)] = len(new)
    return new, table


def substring(ctx: EvalContext, col: DevCol, pos: int,
              length: int) -> DevCol:
    """Spark substring: 1-based ``pos``; negative counts from the end;
    ``length`` < 0 means to the end. Byte-oriented (ASCII-exact), as the
    JAX package's. A dictionary column gets a new dictionary of the
    substrings (codes remapped on the device); a slab a new slab of the
    bytes [start, start + new length), zero past the new length, at the
    narrowest stride that holds them."""
    _require_form(col, "substring")
    if _is_dict(col):
        new, table = _dict_substring(col.dict_values, pos, length)
        return DevCol(dtypes.STRING, None, col.validity,
                      dict_codes=_gather_table(col, table), dict_values=new)
    stride = _stride(col)
    lens = col.lens.to(torch.int64)
    if pos > 0:
        start = lens.clamp(max=pos - 1)
    elif pos == 0:
        start = torch.zeros_like(lens)
    else:
        start = (lens + pos).clamp(min=0)
    new_len = lens - start if length < 0 else (lens - start).clamp(
        max=length)
    new_len = new_len.clamp(min=0)
    width = stride if length < 0 else min(length, stride)
    out_stride = slab_stride_for(max(width, 1), stride)
    b = _slab_bytes(col)
    j = torch.arange(out_stride, device=b.device)[None, :]
    got = torch.gather(b, 1, (start[:, None] + j).clamp(max=stride - 1))
    got = torch.where(j < new_len[:, None], got, torch.zeros_like(got))
    return DevCol(dtypes.STRING, None, col.validity,
                  slab64=got.contiguous().view(torch.int64),
                  lens=new_len.to(torch.int32))


# ---------------------------------------------------------------------------
# IN over strings
# ---------------------------------------------------------------------------

def string_in(ctx: EvalContext, col: DevCol, values) -> torch.Tensor:
    """bool vec: the row's value is one of ``values`` (strings). A
    dictionary column gathers one host-built membership table by code; a
    slab ORs its literal equalities."""
    _require_form(col, "string_in")
    if _is_dict(col):
        return dict_predicate(col, "in", frozenset(values))
    out = torch.zeros_like(col.validity)
    for v in values:
        out |= _slab_equal_literal(col, str(v).encode("utf-8"))
    return out
