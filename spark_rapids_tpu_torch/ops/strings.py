"""String operations on device columns (counterpart of the JAX package's
``ops/strings.py``): equality and three-way comparison against a literal
or another column, ``starts_with``, ``ends_with``, ``contains``,
``substring``, the value tables of ``In`` and ``select_strings``, the
row-wise choice behind a string-valued ``if``, CASE WHEN, ``coalesce``,
``greatest`` and ``least``; lengths, ASCII case mapping, trim, pad,
locate, literal replace, concat and ``concat_ws``, translate, reverse,
repeat, ascii and chr; the casts between strings and integers,
booleans and dates; and ``string_to_unix_ts``, unix_timestamp's parse of
the two fixed formats.

A string column reaches device code in one of three forms
(``columnar/column.py``), and every operation here takes all of them:

  * dictionary codes (``dict_codes`` against ``dict_values``, a host tuple
    in canonical sorted order, code == card the NULL sentinel): the
    operation runs over the dictionary's values on the host, once per
    dictionary (memoized), into a table of card + 1 entries that the codes
    gather on the device (a unary string function: a new dictionary and a
    code remap). No char is read on the device;
  * a char slab (``slab64`` int64 (capacity, stride/8), row i's byte j at
    bit 8*(j%8) of word j//8, zero past ``lens[i]``): the operation reads
    the row's bytes (``slab64.view(torch.uint8)``) or its words; a
    function that keeps every length keeps the slab;
  * plain offsets and chars: the operation runs in char space (the row of
    each char by binary search in the offsets), as the JAX package's
    does. A function whose output can grow (pad, repeat, concat,
    ``concat_ws``, replace, the casts to strings) makes plain chars, at the
    JAX package's static char bounds, with no host sync.

The JAX package computes these over its (offsets, chars) layout in jnp,
outside any Pallas kernel; the port's are elementwise torch code as well
(translate's deletion compacts its chars with kernel B1, as the JAX
package's does). Byte order is the comparison order (UTF-8 byte order
equals code-point order, the order of Python's ``str`` comparison and of
the dictionaries). As in the JAX package, functions are byte-oriented:
case mapping is ASCII-only, ``length`` counts bytes.
"""

from __future__ import annotations

import bisect
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.column import (
    CHAR_BLOCK, MAX_SLAB_STRIDE, DeviceColumn, as_plain, char_bucket,
    char_rows, gather_chars, host_to_device, is_plain, offsets_of,
    plain_parts, plain_prefix_words, slab_stride_for, string_lens,
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


def _plain(dtype, validity, chars, offsets) -> DevCol:
    return DevCol(dtype, None, validity, chars=chars, offsets=offsets)


def _prefix_view(col: DevCol, nbytes: int) -> DevCol:
    """A plain column's first ``nbytes`` bytes a row as a slab (its real
    lengths kept), for the operations that read no further: equality,
    comparison and prefix tests against a literal of ``nbytes`` bytes."""
    return DevCol(col.dtype, None, col.validity,
                  slab64=plain_prefix_words(col, max(nbytes, 1)),
                  lens=string_lens(col))


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
    words and the length, a plain column its first bytes as a slab."""
    if is_plain(col):
        pat = lit.encode("utf-8")
        return (_slab_equal_literal(_prefix_view(col, len(pat)), pat),
                col.validity)
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
    host); a slab compares big-endian word images, then lengths (a plain
    column as the slab of its first bytes: a literal of m bytes is decided
    by m bytes and the length)."""
    if is_plain(col):
        pat = lit.encode("utf-8")
        return _slab_compare_literal(_prefix_view(col, len(pat)), pat)
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
    then lengths; a dictionary against a slab becomes a slab first; where
    a side is plain, both sides' exact images (``sortops.string_images``)
    compare."""
    if is_plain(lv) or is_plain(rv):
        from spark_rapids_tpu_torch.ops.sortops import string_images
        a, b = string_images([lv, rv])
        return _fold_compare([x ^ _SIGN for x in a[:-1]],
                             [y ^ _SIGN for y in b[:-1]],
                             torch.sign(a[-1] - b[-1]))
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
    if not lit:
        return torch.ones_like(col.validity), col.validity
    if _is_dict(col):
        return dict_predicate(col, "starts", lit), col.validity
    pat = lit.encode("utf-8")
    if is_plain(col):
        col = _prefix_view(col, len(pat))
    if len(pat) > _stride(col):
        return torch.zeros_like(col.validity), col.validity
    return (_match_prefix(_slab_bytes(col), pat) & (col.lens >= len(pat)),
            col.validity)


def ends_with(ctx: EvalContext, col: DevCol, lit: str):
    """Returns (bool vec, validity). A slab row's last m bytes are read at
    len - m; a plain row's at its end offset - m."""
    if not lit:
        return torch.ones_like(col.validity), col.validity
    if _is_dict(col):
        return dict_predicate(col, "ends", lit), col.validity
    pat = lit.encode("utf-8")
    m = len(pat)
    if is_plain(col):
        nc = max(int(col.chars.shape[0]), 1)
        idx = (col.offsets[1:].to(torch.int64)[:, None] - m
               + torch.arange(m, device=col.chars.device)[None, :])
        return (_match_prefix(col.chars[idx.clamp(0, nc - 1)], pat)
                & (string_lens(col) >= m), col.validity)
    stride = _stride(col)
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
    len - m does; over plain chars, a match at char i must end inside its
    row."""
    if not lit:
        return torch.ones_like(col.validity), col.validity
    if _is_dict(col):
        return dict_predicate(col, "contains", lit), col.validity
    pat = lit.encode("utf-8")
    if is_plain(col):
        found = _row_reduce(("amax",), col, lambda lo, hi, rows, i, live: (
            _block_hits(col, pat, lo, hi, rows, i, live).to(torch.int64),))
        return found[0] > 0, col.validity
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
    narrowest stride that holds them; a plain column the bytes of each
    row's extent, repacked."""
    if _is_dict(col):
        new, table = _dict_substring(col.dict_values, pos, length)
        return DevCol(dtypes.STRING, None, col.validity,
                      dict_codes=_gather_table(col, table), dict_values=new)
    lens = string_lens(col).to(torch.int64)
    if is_plain(col):
        start, new_len = _substring_extent(lens, pos, length)
        new_len = torch.where(col.validity, new_len, torch.zeros_like(new_len))
        chars, offsets = gather_chars(
            col.chars, col.offsets[:-1].to(torch.int64) + start, new_len,
            int(col.chars.shape[0]))
        return _plain(dtypes.STRING, col.validity, chars, offsets)
    stride = _stride(col)
    start, new_len = _substring_extent(lens, pos, length)
    width = stride if length < 0 else min(length, stride)
    out_stride = slab_stride_for(max(width, 1), stride)
    b = _slab_bytes(col)
    j = torch.arange(out_stride, device=b.device)[None, :]
    got = torch.gather(b, 1, (start[:, None] + j).clamp(max=stride - 1))
    got = torch.where(j < new_len[:, None], got, torch.zeros_like(got))
    return DevCol(dtypes.STRING, None, col.validity,
                  slab64=got.contiguous().view(torch.int64),
                  lens=new_len.to(torch.int32))


def _substring_extent(lens: torch.Tensor, pos: int, length: int):
    """(start, new length) int64 of Spark's byte substring of rows of
    ``lens`` bytes."""
    if pos > 0:
        start = lens.clamp(max=pos - 1)
    elif pos == 0:
        start = torch.zeros_like(lens)
    else:
        start = (lens + pos).clamp(min=0)
    new_len = lens - start if length < 0 else (lens - start).clamp(
        max=length)
    return start, new_len.clamp(min=0)


# ---------------------------------------------------------------------------
# IN over strings
# ---------------------------------------------------------------------------

def string_in(ctx: EvalContext, col: DevCol, values) -> torch.Tensor:
    """bool vec: the row's value is one of ``values`` (strings). A
    dictionary column gathers one host-built membership table by code; a
    slab (a plain column, the slab of its first bytes) ORs its literal
    equalities."""
    if _is_dict(col):
        return dict_predicate(col, "in", frozenset(values))
    if is_plain(col):
        col = _prefix_view(col, max((len(str(v).encode("utf-8"))
                                     for v in values), default=0))
    out = torch.zeros_like(col.validity)
    for v in values:
        out |= _slab_equal_literal(col, str(v).encode("utf-8"))
    return out


# ---------------------------------------------------------------------------
# Row-wise selection (if / CASE WHEN / coalesce over strings)
# ---------------------------------------------------------------------------

def _widen_slab(col: DevCol, stride: int) -> DevCol:
    """A slab at a wider ``stride``: zero words appended (bytes past a
    row's length are zero, so the rows are unchanged)."""
    w = int(col.slab64.shape[1])
    if w * 8 == stride:
        return col
    pad = torch.zeros((col.slab64.shape[0], stride // 8 - w),
                      dtype=torch.int64, device=col.slab64.device)
    return DevCol(col.dtype, None, col.validity,
                  slab64=torch.cat([col.slab64, pad], dim=1), lens=col.lens)


def select_strings(cond: torch.Tensor, a: DevCol, b: DevCol,
                   validity: torch.Tensor) -> DevCol:
    """Row-wise choice between two string columns (the JAX package's
    ``select_strings``): rows where ``cond`` take ``a``'s value, the
    others ``b``'s; ``validity`` is the result's. Two dictionaries select
    codes, remapped into the union of their values first (on the host,
    once per pair) where they differ; otherwise both sides become slabs
    of the wider stride (a dictionary's values built into a slab and
    gathered by code) and the rows' words and lengths are selected; where
    a side is plain or that stride would pass the slab limit, each row's
    bytes are gathered from the side it takes into plain chars."""
    if _is_dict(a) and _is_dict(b):
        ca, cb, values = a.dict_codes, b.dict_codes, a.dict_values
        if a.dict_values != b.dict_values:
            from spark_rapids_tpu_torch.columnar.dictionary import (
                union_dictionaries,
            )
            values, (ra, rb) = union_dictionaries([a.dict_values,
                                                   b.dict_values])
            ca, cb = _gather_table(a, ra), _gather_table(b, rb)
        return DevCol(dtypes.STRING, None, validity,
                      dict_codes=torch.where(cond, ca, cb),
                      dict_values=values)
    stride = 0 if is_plain(a) or is_plain(b) else max(
        _stride(c) if not _is_dict(c) else slab_stride_for(
            _max_value_len(c.dict_values), 1 << 30) for c in (a, b))
    if not stride or stride > MAX_SLAB_STRIDE:
        (ca, oa), (cb, ob) = plain_parts(a), plain_parts(b)
        lens = torch.where(validity, torch.where(cond, string_lens(a),
                                                 string_lens(b)),
                           torch.zeros((), dtype=torch.int32,
                                       device=validity.device))
        starts = torch.where(cond, oa[:-1].to(torch.int64),
                             ob[:-1].to(torch.int64) + int(ca.shape[0]))
        chars, offsets = gather_chars(torch.cat([ca, cb]), starts, lens,
                                      int(ca.shape[0]) + int(cb.shape[0]))
        return _plain(dtypes.STRING, validity, chars, offsets)
    a, b = (_widen_slab(_dict_as_slab(c, stride) if _is_dict(c) else c,
                        stride) for c in (a, b))
    return DevCol(dtypes.STRING, None, validity,
                  slab64=torch.where(cond[:, None], a.slab64, b.slab64),
                  lens=torch.where(cond, a.lens, b.lens))


# ---------------------------------------------------------------------------
# Shared pieces of the string functions
# ---------------------------------------------------------------------------

def _bytes_str(b: bytes) -> str:
    """Bytes back to a value (a byte-oriented result may split a
    multi-byte character; it decodes as the collect's fetch does)."""
    return b.decode("utf-8", errors="replace")


def _dict_str_map(dict_values: tuple, fn: Callable[[bytes], bytes]):
    """(new canonical sorted values, int32 code remap of card + 1 entries)
    of a byte function over a dictionary's values."""
    outs = [_bytes_str(fn(v.encode("utf-8"))) for v in dict_values]
    new = tuple(sorted(set(outs)))
    at = {v: i for i, v in enumerate(new)}
    table = np.empty(len(dict_values) + 1, np.int32)
    table[:len(outs)] = [at[v] for v in outs]
    table[len(outs)] = len(new)
    return new, table


def _dict_apply(col: DevCol, fn: Callable[[bytes], bytes]) -> DevCol:
    """A unary string function over a dictionary column: a host map of
    its values and a code remap on the device."""
    new, table = _dict_str_map(col.dict_values, fn)
    return DevCol(dtypes.STRING, None, col.validity,
                  dict_codes=_gather_table(col, table), dict_values=new)


def _dict_value_table(dict_values: tuple, fn: Callable[[bytes], tuple],
                      np_dtype: str):
    """(values (card + 1,), ok (card + 1,)) of a byte function returning
    (value, ok) over a dictionary's values; the NULL entry is (0, False)."""
    vals = np.zeros(len(dict_values) + 1, np.dtype(np_dtype))
    ok = np.zeros(len(dict_values) + 1, np.bool_)
    for i, v in enumerate(dict_values):
        vals[i], ok[i] = fn(v.encode("utf-8"))
    return vals, ok


def _dict_values_of(col: DevCol, fn, np_dtype: str):
    """(values, ok) device vectors of ``fn`` over a dictionary column."""
    vals, ok = _dict_value_table(col.dict_values, fn, np_dtype)
    return _gather_table(col, vals), _gather_table(col, ok)


def _blocks(n: int):
    """[lo, hi) of each block of CHAR_BLOCK slots of ``n`` char slots: the
    char-space passes run block by block, so their int64 temporaries hold
    CHAR_BLOCK entries whatever the column's char capacity."""
    return [(lo, min(lo + CHAR_BLOCK, n)) for lo in range(0, n, CHAR_BLOCK)]


def _char_space(col: DevCol, lo: int, hi: int):
    """(row int64, index int64, live bool) of the char slots [lo, hi) of a
    plain column: their row, their position, and whether they lie before
    the total."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=col.chars.device)
    return char_rows(col.offsets, lo, hi), i, i < col.offsets[-1]


def _row_reduce(ops, col: DevCol, fn):
    """One int64 (capacity,) vector per op of ``ops`` (sum, amin, amax):
    the op over each row's char slots of a plain column of the vectors
    ``fn(lo, hi, rows, i, live)`` returns, one per op, block by block. A
    row without chars holds the op's identity."""
    cap = int(col.validity.shape[0])
    dev = col.chars.device
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    accs = [_seg(op, none, none, cap) for op in ops]
    for lo, hi in _blocks(int(col.chars.shape[0])):
        rows, i, live = _char_space(col, lo, hi)
        for op, acc, x in zip(ops, accs, fn(lo, hi, rows, i, live)):
            if op == "sum":
                acc.index_add_(0, rows, x)
            else:
                acc.scatter_reduce_(0, rows, x, op)
    return accs


def _build_chars(out_cap: int, offsets: torch.Tensor, fn) -> torch.Tensor:
    """uint8 (out_cap,) plain chars under ``offsets``: slot k of row r, at
    position rel in the row, holds ``fn(k, r, rel)``, computed block by
    block; slots past the total are zero."""
    dev = offsets.device
    out = torch.zeros(max(out_cap, 1), dtype=torch.uint8, device=dev)
    total = offsets[-1]
    for lo, hi in _blocks(out_cap):
        row = char_rows(offsets, lo, hi)
        k = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        got = fn(k, row, k - offsets[row])
        out[lo:hi] = torch.where(k < total, got,
                                 torch.zeros_like(got)).to(torch.uint8)
    return out


def _block_hits(col: DevCol, pat: bytes, lo: int, hi: int,
                rows: torch.Tensor, i: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """bool (hi - lo,): a match of ``pat`` starts at each char slot of
    [lo, hi) of a plain column and ends inside the slot's row."""
    m = len(pat)
    win = col.chars[lo:hi + m - 1]
    short = hi - lo + m - 1 - int(win.shape[0])
    if short > 0:
        win = torch.cat([win, torch.zeros(short, dtype=win.dtype,
                                          device=win.device)])
    hit = live.clone()
    for j, c in enumerate(pat):
        hit &= win[j:j + hi - lo] == c
    return hit & (i + m <= col.offsets[1:].to(torch.int64)[rows])


def _seg(op: str, x: torch.Tensor, rows: torch.Tensor, cap: int):
    from spark_rapids_tpu_torch.ops.groupby import segment_op
    return segment_op(op, x, rows, cap)


def _zero_invalid(lens: torch.Tensor, validity: torch.Tensor):
    return torch.where(validity, lens, torch.zeros_like(lens))


# ---------------------------------------------------------------------------
# Lengths, case maps, trim, pad, locate, replace
# ---------------------------------------------------------------------------

def civil_from_days(days: torch.Tensor):
    """days since the epoch -> (year, month, day), Hinnant's
    civil_from_days with floor division (``sql/exprs/datetimeexprs``)."""
    from spark_rapids_tpu_torch.sql.exprs.datetimeexprs import (
        civil_from_days as civil,
    )
    return civil(days)


def compare_extents(data_a: torch.Tensor, sa: torch.Tensor, la: torch.Tensor,
                    data_b: torch.Tensor, sb: torch.Tensor,
                    lb: torch.Tensor) -> torch.Tensor:
    """Exact elementwise lexicographic byte-order compare of string extents
    (starts + lengths into uint8 char buffers), int8 in {-1, 0, 1}: 8
    bytes at a time, as many rounds as the longest extent needs (its
    length read in one counted ``strings.compareExtents`` sync). Past-end
    bytes pack as 0x00; where every compared byte ties, the lengths
    decide, which is exact for 0-padding."""
    from spark_rapids_tpu_torch.obs.syncledger import sync_scope
    n = int(sa.shape[0])
    la, lb = la.to(torch.int64), lb.to(torch.int64)
    if n == 0:
        return torch.zeros(0, dtype=torch.int8, device=sa.device)
    with sync_scope("strings.compareExtents", nbytes=8):
        longest = int(torch.maximum(la, lb).max().item())
    sa, sb = sa.to(torch.int64), sb.to(torch.int64)

    def pack(data, starts, lens, k):
        img = torch.zeros(n, dtype=torch.int64, device=starts.device)
        last = max(int(data.shape[0]) - 1, 0)
        for b in range(8):
            pos = k * 8 + b
            idx = (starts + pos).clamp(0, last)
            byte = torch.where(pos < lens, data[idx].to(torch.int64),
                               torch.zeros_like(idx))
            img = (img << 8) | byte
        return img ^ _SIGN  # unsigned order as signed
    cmp = torch.zeros(n, dtype=torch.int8, device=sa.device)
    done = torch.zeros(n, dtype=torch.bool, device=sa.device)
    for k in range(-(-longest // 8)):
        au, bu = pack(data_a, sa, la, k), pack(data_b, sb, lb, k)
        newly = ~done & (au != bu)
        cmp = torch.where(newly, torch.where(au < bu, -1, 1).to(torch.int8),
                          cmp)
        done = done | newly
    return torch.where(done, cmp, torch.sign(la - lb).to(torch.int8))


def compare_rows(col: DevCol, rows_a: torch.Tensor,
                 rows_b: torch.Tensor) -> torch.Tensor:
    """Exact compare of row selections a against b of one string column
    (any form: its plain chars and offsets, ``plain_parts``)."""
    chars, offsets = plain_parts(col)
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    return compare_extents(chars, starts[rows_a], lens[rows_a],
                           chars, starts[rows_b], lens[rows_b])


def lengths_of(col: DevCol) -> torch.Tensor:
    """int32 byte length of each row (0 where invalid)."""
    return string_lens(col)


def _bytes_map(col: DevCol, table: np.ndarray) -> DevCol:
    """A byte-to-byte map (256 entries, 0 -> 0) over a slab's or plain
    column's bytes; lengths and layout are unchanged."""
    if _is_dict(col):
        tb = bytes(table.astype(np.uint8))
        return _dict_apply(col, lambda b: b.translate(tb))
    lut = host_to_device(table.astype(np.uint8), col.validity.device)
    if is_plain(col):
        out = torch.empty_like(col.chars)
        for lo, hi in _blocks(int(col.chars.shape[0])):
            out[lo:hi] = lut[col.chars[lo:hi].long()]
        return _plain(col.dtype, col.validity, out, col.offsets)
    b = _slab_bytes(col)
    return DevCol(col.dtype, None, col.validity,
                  slab64=lut[b.long()].contiguous().view(torch.int64),
                  lens=col.lens)


def _case_table(upper: bool) -> np.ndarray:
    t = np.arange(256, dtype=np.int32)
    if upper:
        t[97:123] -= 32
    else:
        t[65:91] += 32
    return t


def upper_ascii(col: DevCol) -> DevCol:
    return _bytes_map(col, _case_table(True))


def lower_ascii(col: DevCol) -> DevCol:
    return _bytes_map(col, _case_table(False))


def _host_initcap(b: bytes) -> bytes:
    out, prev_space = bytearray(), True
    for c in b:
        if prev_space and 97 <= c <= 122:
            c -= 32
        elif not prev_space and 65 <= c <= 90:
            c += 32
        out.append(c)
        prev_space = c == 32
    return bytes(out)


def initcap_ascii(col: DevCol) -> DevCol:
    """Upper-case the first letter of each word (a row's first byte, or
    one after a space), lower-case the rest."""
    if _is_dict(col):
        return _dict_apply(col, _host_initcap)
    up = host_to_device(_case_table(True).astype(np.uint8),
                        col.validity.device)
    low = host_to_device(_case_table(False).astype(np.uint8),
                         col.validity.device)
    if is_plain(col):
        c = col.chars
        out = torch.empty_like(c)
        starts = col.offsets[:-1].to(torch.int64)
        for lo, hi in _blocks(int(c.shape[0])):
            rows, i, _live = _char_space(col, lo, hi)
            # slot 0 starts its row whatever precedes it
            prev = c[lo - 1:hi - 1] if lo else torch.cat(
                [torch.full((1,), 32, dtype=c.dtype, device=c.device),
                 c[:hi - 1]])
            word = (i == starts[rows]) | (prev == 32)
            b = c[lo:hi].long()
            out[lo:hi] = torch.where(word, up[b], low[b])
        return _plain(col.dtype, col.validity, out, col.offsets)
    b = _slab_bytes(col)
    prev = torch.cat([torch.full_like(b[:, :1], 32), b[:, :-1]], dim=1)
    out = torch.where(prev == 32, up[b.long()], low[b.long()])
    return DevCol(col.dtype, None, col.validity,
                  slab64=out.contiguous().view(torch.int64), lens=col.lens)


def trim(ctx: EvalContext, col: DevCol, chars: str = " ",
         left: bool = True, right: bool = True) -> DevCol:
    """trim/ltrim/rtrim of a literal char set (Spark's default: spaces):
    the first and last kept byte of each row by segment min/max, then the
    kept extents repacked."""
    strip = chars.encode("utf-8")
    if _is_dict(col):
        def fn(b: bytes) -> bytes:
            if left and right:
                return b.strip(strip)
            return b.lstrip(strip) if left else b.rstrip(strip)
        return _dict_apply(col, fn)
    col = as_plain(col)
    big = 1 << 40

    def kept(lo, hi, rows, i, live):
        c = col.chars[lo:hi]
        is_trim = torch.zeros_like(live)
        for ch in strip:
            is_trim |= c == ch
        keep = ~is_trim & live
        return torch.where(keep, i, big), torch.where(keep, i, -1)
    first, last = _row_reduce(("amin", "amax"), col, kept)
    starts = col.offsets[:-1].to(torch.int64)
    ends = col.offsets[1:].to(torch.int64)
    new_start = first.clamp(max=ends) if left else starts
    new_end = (last + 1).clamp(min=starts) if right else ends
    new_start = new_start.clamp(min=starts)
    new_len = _zero_invalid((new_end.clamp(max=ends) - new_start).clamp(
        min=0), col.validity)
    out, offsets = gather_chars(col.chars, new_start, new_len,
                                int(col.chars.shape[0]))
    return _plain(dtypes.STRING, col.validity, out, offsets)


def pad(ctx: EvalContext, col: DevCol, n: int, pad_char: str,
        left: bool) -> DevCol:
    """lpad/rpad to exactly ``n`` bytes (Spark truncates longer strings);
    plain chars of capacity x n."""
    n = max(int(n), 0)
    pb = (pad_char.encode("utf-8") or b" ")[:1]
    if _is_dict(col):
        def fn(b: bytes) -> bytes:
            if len(b) >= n:
                return b[:n]
            return pb * (n - len(b)) + b if left else b + pb * (n - len(b))
        return _dict_apply(col, fn)
    col = as_plain(col)
    cap = int(col.validity.shape[0])
    lens = string_lens(col).to(torch.int64)
    out_len = _zero_invalid(torch.full_like(lens, n), col.validity)
    new_off = offsets_of(out_len.to(torch.int32))
    padlen = (n - lens).clamp(min=0)
    starts = col.offsets[:-1].to(torch.int64)
    nc = max(int(col.chars.shape[0]), 1)

    def padded(k, row, p):
        if left:
            from_src, rel = p >= padlen[row], p - padlen[row]
        else:
            from_src, rel = p < lens[row], p
        src = (starts[row] + rel).clamp(0, nc - 1)
        return torch.where(from_src, col.chars[src],
                           torch.full((), pb[0], dtype=torch.uint8,
                                      device=k.device))
    return _plain(dtypes.STRING, col.validity,
                  _build_chars(max(cap * n, 1), new_off, padded), new_off)


def locate(ctx: EvalContext, col: DevCol, lit: str,
           start_pos: int = 1) -> torch.Tensor:
    """int32 1-based byte position of the first occurrence of ``lit`` at
    or after ``start_pos``; 0 when absent (Spark locate/instr)."""
    pat = lit.encode("utf-8")
    if not pat:
        return torch.full(col.validity.shape, max(start_pos, 1),
                          dtype=torch.int32, device=col.validity.device)
    if _is_dict(col):
        def fn(b: bytes):
            return b.find(pat, max(start_pos - 1, 0)) + 1, True
        return _dict_values_of(col, fn, "int32")[0]
    col = as_plain(col)
    starts = col.offsets[:-1].to(torch.int64)
    big = 1 << 40

    def first_at(lo, hi, rows, i, live):
        rel = i - starts[rows]
        hit = (_block_hits(col, pat, lo, hi, rows, i, live)
               & (rel >= start_pos - 1))
        return (torch.where(hit, rel, big),)
    first = _row_reduce(("amin",), col, first_at)[0]
    return torch.where(first < big, first + 1,
                       torch.zeros_like(first)).to(torch.int32)


def _self_overlaps(pat: bytes) -> bool:
    """Two occurrences of ``pat`` can overlap (a proper suffix is a
    prefix)."""
    return any(pat[-k:] == pat[:k] for k in range(1, len(pat)))


def _greedy_matches(hit: torch.Tensor, row_start: torch.Tensor,
                    m: int) -> torch.Tensor:
    """The leftmost non-overlapping subset of the match starts ``hit`` of
    one block of char slots (the JAX package's sequential scan), where
    ``row_start`` is each slot's row start in the block's coordinates and
    no earlier choice reaches into the block: a chain starts at a match
    with no match in the m - 1 bytes before it in its row, and each chosen
    match's next is the first match m bytes on; the chains' members are
    found by pointer doubling."""
    n = hit.shape[0]
    dev = hit.device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    none = torch.full((), n, dtype=torch.int64, device=dev)
    never = -(1 << 40)
    cand = torch.where(hit, i, none)
    # the first match at or after each position (reverse running min)
    nxt_at = torch.flip(torch.cummin(torch.flip(cand, [0]), 0).values, [0])
    nxt_at = torch.cat([nxt_at, none.reshape(1)])
    prev = torch.cummax(torch.where(hit, i, torch.full_like(i, never)),
                        0).values
    prev_before = torch.cat([torch.full((1,), never, device=dev,
                                        dtype=torch.int64), prev[:-1]])
    chosen = hit & (prev_before < torch.maximum(i - (m - 1), row_start))
    jump = torch.where(hit, nxt_at[(i + m).clamp(max=n)], none)
    jump = torch.cat([jump, none.reshape(1)])
    reach = torch.cat([chosen, torch.zeros(1, dtype=torch.bool, device=dev)])
    for _ in range(max(n, 1).bit_length()):
        tgt = torch.where(reach[:-1], jump[:-1], none)
        add = torch.zeros_like(reach)
        add.scatter_(0, tgt, torch.ones_like(tgt, dtype=torch.bool))
        reach = reach | add
        jump = jump[jump]
    return reach[:n] & hit


def _chosen_matches(col: DevCol, pat: bytes) -> torch.Tensor:
    """bool (char capacity,): the starts of the leftmost non-overlapping
    matches of ``pat`` in each row of a plain column. Block by block; a
    pattern that can overlap itself carries the last chosen start into the
    next block, whose matches it covers are dropped before its greedy
    pass."""
    m = len(pat)
    n = int(col.chars.shape[0])
    dev = col.chars.device
    starts = col.offsets[:-1].to(torch.int64)
    sel = torch.zeros(n, dtype=torch.bool, device=dev)
    overlaps = _self_overlaps(pat)
    last = torch.full((), -(1 << 40), dtype=torch.int64, device=dev)
    for lo, hi in _blocks(n):
        rows, i, live = _char_space(col, lo, hi)
        hit = _block_hits(col, pat, lo, hi, rows, i, live)
        if overlaps:
            hit &= (i < last) | (i >= last + m)
            hit = _greedy_matches(hit, starts[rows] - lo, m)
            last = torch.maximum(last, torch.where(
                hit, i, torch.full_like(i, -(1 << 40))).max())
        sel[lo:hi] = hit
    return sel


def replace_literal(ctx: EvalContext, col: DevCol, search: str,
                    replacement: str) -> DevCol:
    """replace(str, search, replacement) with literals: the leftmost
    non-overlapping matches, each replaced; plain chars at the JAX
    package's static bound. Block by block: a kept byte moves by delta
    times the matches before it (a running count carried across blocks),
    a match's start writes the replacement."""
    pat = search.encode("utf-8")
    rep = replacement.encode("utf-8")
    m = len(pat)
    if m == 0:
        return col
    if _is_dict(col):
        return _dict_apply(col, lambda b: b.replace(pat, rep))
    col = as_plain(col)
    nchars = int(col.chars.shape[0])
    dev = col.chars.device
    sel = _chosen_matches(col, pat)
    per_row = _row_reduce(("sum",), col, lambda lo, hi, rows, i, live: (
        sel[lo:hi].to(torch.int64),))[0]
    delta = len(rep) - m
    new_len = _zero_invalid(string_lens(col).to(torch.int64)
                            + per_row * delta, col.validity)
    new_off = offsets_of(new_len.to(torch.int32))
    out_cap = max(nchars + (nchars // m + 1) * max(delta, 0), 1)
    # scatters to distinct places; the slot past the end takes the rest
    out = torch.zeros(out_cap + 1, dtype=torch.uint8, device=dev)
    before = torch.zeros((), dtype=torch.int64, device=dev)
    for lo, hi in _blocks(nchars):
        i = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        s = sel[lo:hi]
        # inside a chosen match: one starts in the m - 1 slots before
        back = min(lo, m - 1)
        win = sel[lo - back:hi]
        inside = s.clone()
        for j in range(1, m):
            if j <= back:
                inside |= win[back - j:back - j + hi - lo]
            elif j < hi - lo + back:
                inside[j - back:] |= win[:hi - lo - (j - back)]
        si = s.to(torch.int64)
        at = i + (before + torch.cumsum(si, 0) - si) * delta
        before = before + si.sum()
        dump = torch.full_like(i, out_cap)
        out.scatter_(0, torch.where(~inside & (i < col.offsets[-1]), at,
                                    dump), col.chars[lo:hi])
        for j, c in enumerate(rep):
            out.scatter_(0, torch.where(s, at + j, dump),
                         torch.full((hi - lo,), c, dtype=torch.uint8,
                                    device=dev))
    return _plain(dtypes.STRING, col.validity, out[:out_cap], new_off)


# ---------------------------------------------------------------------------
# concat, concat_ws, translate, reverse, repeat, ascii, chr
# ---------------------------------------------------------------------------

def _assemble(pieces, validity: torch.Tensor, cap: int) -> DevCol:
    """Plain rows built from ``pieces`` in order, each (chars, starts,
    lens): a piece's row r contributes lens[r] bytes of its chars from
    starts[r] (a literal piece: its bytes and starts 0). Char capacity is
    the pieces' char capacities' sum, lens x capacity for a literal."""
    dev = validity.device
    lens = [_zero_invalid(p[2].to(torch.int64), validity) for p in pieces]
    total = torch.zeros(cap, dtype=torch.int64, device=dev)
    for ln in lens:
        total = total + ln
    new_off = offsets_of(total.to(torch.int32))
    out_cap = char_bucket(sum(int(p[0].shape[0]) * (cap if p[3] else 1)
                              for p in pieces))
    src = torch.cat([p[0] for p in pieces])
    last = max(int(src.shape[0]) - 1, 0)

    def assembled(k, row, rel):
        pos = torch.zeros_like(k)
        before = torch.zeros_like(k)
        base = 0
        for (chars, starts, _l, _lit), ln in zip(pieces, lens):
            lr = ln[row]
            in_piece = (rel >= before) & (rel < before + lr)
            pos = torch.where(in_piece, base + starts.to(torch.int64)[row]
                              + rel - before, pos)
            before = before + lr
            base += int(chars.shape[0])
        return src[pos.clamp(0, last)]
    return _plain(dtypes.STRING, validity,
                  _build_chars(out_cap, new_off, assembled), new_off)


def _piece(col: DevCol):
    chars, offsets = plain_parts(col)
    return chars, offsets[:-1], string_lens(col), False


def _literal_piece(b: bytes, enabled: torch.Tensor):
    dev = enabled.device
    chars = host_to_device(np.frombuffer(b or b"\0", np.uint8).copy(), dev)
    return (chars, torch.zeros(enabled.shape, dtype=torch.int64, device=dev),
            torch.where(enabled, len(b), 0), True)


def concat_columns(ctx: EvalContext, cols) -> DevCol:
    """concat(s1, s2, ...): NULL if any input is (Spark); plain chars."""
    validity = cols[0].validity
    for c in cols[1:]:
        validity = validity & c.validity
    return _assemble([_piece(c) for c in cols], validity,
                     int(validity.shape[0]))


def concat_ws_columns(ctx: EvalContext, sep: str, cols) -> DevCol:
    """concat_ws(sep, s1, s2, ...): the non-NULL parts joined by ``sep``;
    never NULL (an all-NULL row is the empty string), Spark semantics."""
    sep_b = sep.encode("utf-8")
    pieces = []
    any_before = torch.zeros_like(cols[0].validity)
    for c in cols:
        if sep_b:
            pieces.append(_literal_piece(sep_b, any_before & c.validity))
        chars, starts, lens, lit = _piece(c)
        pieces.append((chars, starts, _zero_invalid(lens, c.validity), lit))
        any_before = any_before | c.validity
    return _assemble(pieces, ctx.row_mask.clone(), int(ctx.capacity))


def translate_string(ctx: EvalContext, col: DevCol, matching: str,
                     replace: str) -> DevCol:
    """translate(str, matching, replace): a byte map; matching bytes past
    len(replace) are deleted (Spark, ASCII-exact). Without deletions the
    layout is kept; with them the kept bytes compact with kernel B1."""
    lut = np.arange(256, dtype=np.int32)
    mb, rb = matching.encode("utf-8"), replace.encode("utf-8")
    for i, ch in enumerate(mb):
        lut[ch] = rb[i] if i < len(rb) else -1  # -1: delete
    if (lut >= 0).all():
        return _bytes_map(col, lut)
    if _is_dict(col):
        return _dict_apply(col, lambda b: bytes(int(lut[c]) for c in b
                                                if lut[c] >= 0))
    from spark_rapids_tpu_torch.ops.kernels import compact_permutation
    col = as_plain(col)
    cap = int(col.validity.shape[0])
    n = int(col.chars.shape[0])
    dev = col.chars.device
    table = host_to_device(lut, dev)
    # each block's kept bytes land after the blocks before (a running
    # count on the device); the slot past the end takes the rest
    out = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    before = torch.zeros((), dtype=torch.int64, device=dev)
    per_row = torch.zeros(cap, dtype=torch.int32, device=dev)
    for lo, hi in _blocks(n):
        rows, i, live = _char_space(col, lo, hi)
        mapped = table[col.chars[lo:hi].long()]
        keep = live & (mapped >= 0)
        perm, kept = compact_permutation(keep)
        j = i - lo
        out.scatter_(0, torch.where(j < kept, before + j, n),
                     mapped[perm.long()].clamp(min=0).to(torch.uint8))
        before = before + kept
        per_row.index_add_(0, rows, keep.to(torch.int32))
    return _plain(dtypes.STRING, col.validity, out[:n], offsets_of(per_row))


def reverse_string(ctx: EvalContext, col: DevCol) -> DevCol:
    """Byte reversal of each row (exact for ASCII, like the case maps);
    a slab stays a slab."""
    if _is_dict(col):
        return _dict_apply(col, lambda b: b[::-1])
    lens = string_lens(col).to(torch.int64)
    if is_plain(col):
        starts = col.offsets[:-1].to(torch.int64)
        nc = max(int(col.chars.shape[0]), 1)
        out = _build_chars(int(col.chars.shape[0]), col.offsets,
                           lambda k, row, rel: col.chars[(
                               starts[row] + lens[row] - 1 - rel
                           ).clamp(0, nc - 1)])
        return _plain(dtypes.STRING, col.validity, out, col.offsets)
    b = _slab_bytes(col)
    j = torch.arange(b.shape[1], device=b.device)[None, :]
    src = (lens[:, None] - 1 - j).clamp(min=0)
    got = torch.gather(b, 1, src)
    got = torch.where(j < lens[:, None], got, torch.zeros_like(got))
    return DevCol(dtypes.STRING, None, col.validity,
                  slab64=got.contiguous().view(torch.int64), lens=col.lens)


def repeat_string(ctx: EvalContext, col: DevCol, n: int) -> DevCol:
    """repeat(str, n): n <= 0 -> the empty string; plain chars of n x the
    input's char capacity."""
    n = max(int(n), 0)
    if _is_dict(col):
        return _dict_apply(col, lambda b: b * n)
    col = as_plain(col)
    lens = string_lens(col).to(torch.int64)
    new_off = offsets_of((lens * n).to(torch.int32))
    starts = col.offsets[:-1].to(torch.int64)
    nc = max(int(col.chars.shape[0]), 1)
    out = _build_chars(max(int(col.chars.shape[0]) * n, 16), new_off,
                       lambda k, row, rel: col.chars[(
                           starts[row] + rel % lens[row].clamp(min=1)
                       ).clamp(0, nc - 1)])
    return _plain(dtypes.STRING, col.validity, out, new_off)


def ascii_first(ctx: EvalContext, col: DevCol) -> DevCol:
    """ascii(str): the first byte, 0 for the empty string (int32)."""
    if _is_dict(col):
        data = _dict_values_of(col, lambda b: (b[0] if b else 0, True),
                               "int32")[0]
        return DevCol(dtypes.INT32, data, col.validity)
    lens = string_lens(col)
    if is_plain(col):
        nc = max(int(col.chars.shape[0]), 1)
        first = col.chars[col.offsets[:-1].long().clamp(0, nc - 1)]
    else:
        first = _slab_bytes(col)[:, 0]
    data = torch.where(lens > 0, first.to(torch.int32),
                       torch.zeros_like(lens))
    return DevCol(dtypes.INT32, data, col.validity)


def chr_from_int(ctx: EvalContext, data: torch.Tensor,
                 validity: torch.Tensor) -> DevCol:
    """chr(n): the character of code n % 256 (negative: the empty string),
    UTF-8 encoded (codes 128..255 take two bytes, as the host's chr())."""
    code = torch.remainder(data.to(torch.int64), 256)
    neg = data < 0
    two = (code >= 128) & ~neg
    lens = torch.where(neg | ~validity, 0, torch.where(two, 2, 1))
    new_off = offsets_of(lens.to(torch.int32))
    cap = int(data.shape[0])

    def encoded(k, row, rel):
        c = code[row]
        first = torch.where(two[row], 0xC0 | (c >> 6), c)
        return torch.where(rel == 0, first, 0x80 | (c & 0x3F))
    return _plain(dtypes.STRING, validity,
                  _build_chars(char_bucket(2 * cap), new_off, encoded),
                  new_off)


# ---------------------------------------------------------------------------
# Casts between strings and integers, booleans and dates
# ---------------------------------------------------------------------------

_POW10 = [10 ** k for k in range(20)]


def integral_to_string(ctx: EvalContext, data: torch.Tensor,
                       validity: torch.Tensor) -> DevCol:
    """Decimal rendering of an integral column: plain chars of capacity x
    21 (20 digits and a sign)."""
    cap = int(data.shape[0])
    dev = data.device
    v = data.to(torch.int64)
    neg = v < 0
    # |v| as digits, computed on the negative side so INT64_MIN stays exact
    nv = torch.where(neg, v, -v)  # <= 0
    ndig = torch.ones(cap, dtype=torch.int64, device=dev)
    for k in range(1, 19):
        ndig += (nv <= -_POW10[k]).to(torch.int64)
    lens = _zero_invalid(ndig + neg.to(torch.int64), validity)
    new_off = offsets_of(lens.to(torch.int32))
    p10 = host_to_device(np.asarray(_POW10[:19], np.int64), dev)

    def digits(k, row, pos):
        negr = neg[row]
        j = pos - negr.to(torch.int64)
        exp = (ndig[row] - 1 - j).clamp(0, 18)
        digit = -torch.remainder(torch.div(nv[row], p10[exp],
                                           rounding_mode="trunc"), -10)
        return torch.where((pos == 0) & negr, ord("-"), ord("0") + digit)
    return _plain(dtypes.STRING, validity,
                  _build_chars(max(cap * 21, 1), new_off, digits), new_off)


def strings_from_choices(ctx: EvalContext, idx: torch.Tensor, choices,
                         validity: torch.Tensor) -> DevCol:
    """Per-row choice among static literal strings (the bool rendering):
    a dictionary of the choices, the row's index remapped to its code."""
    vals = [str(c) for c in choices]
    new = tuple(sorted(set(vals)))
    table = np.asarray([new.index(v) for v in vals], np.int32)
    codes = host_to_device(table, idx.device)[
        idx.to(torch.int64).clamp(0, len(vals) - 1)]
    codes = torch.where(validity, codes, torch.full_like(codes, len(new)))
    return DevCol(dtypes.STRING, None, validity, dict_codes=codes,
                  dict_values=new)


def date_to_string(ctx: EvalContext, days: torch.Tensor,
                   validity: torch.Tensor) -> DevCol:
    """'yyyy-MM-dd' rendering: plain chars of capacity x 10; a year outside
    0..9999 has no such rendering and gives NULL (the JAX package's
    rule)."""
    from spark_rapids_tpu_torch.sql.exprs.datetimeexprs import (
        civil_from_days,
    )
    cap = int(days.shape[0])
    y, m, d = civil_from_days(days)
    validity = validity & (y >= 0) & (y <= 9999)
    y = y.clamp(0, 9999)
    zero = ord("0")
    comps = [zero + y // 1000 % 10, zero + y // 100 % 10, zero + y // 10 % 10,
             zero + y % 10, torch.full_like(y, ord("-")), zero + m // 10 % 10,
             zero + m % 10, torch.full_like(y, ord("-")), zero + d // 10 % 10,
             zero + d % 10]
    table = torch.stack(comps, dim=1).reshape(-1).to(torch.uint8)
    lens = _zero_invalid(torch.full((cap,), 10, dtype=torch.int32,
                                    device=days.device), validity)
    return _plain(dtypes.STRING, validity,
                  *gather_chars(table, torch.arange(
                      cap, dtype=torch.int64, device=days.device) * 10,
                      lens, max(cap * 10, 1)))


_WS = (32, 9, 10, 13, 11, 12)


def _nonws_span(col: DevCol):
    """(first, last) char index of each row's non-whitespace span (first
    = 2^40 and last = -1 for an all-whitespace row). Whitespace is the
    ASCII set the host parsers strip."""
    big = 1 << 40

    def nonws(lo, hi, rows, i, live):
        c = col.chars[lo:hi]
        ws = torch.zeros_like(live)
        for w in _WS:
            ws |= c == w
        non = ~ws & live
        return torch.where(non, i, big), torch.where(non, i, -1)
    first, last = _row_reduce(("amin", "amax"), col, nonws)
    # rows without chars hold the segment ops' identities: clamp them
    return first.clamp(max=big), last.clamp(min=-1)


def _host_parse_int(b: bytes):
    import re
    text = b.decode("utf-8", errors="replace").strip(" \t\n\r\v\f")
    if not re.match(r"^[+-]?\d+(\.\d*)?$", text, re.ASCII):
        return 0, False
    v = int(text.split(".")[0])
    if not -(1 << 63) <= v < 1 << 63:
        return 0, False
    return v, True


def string_to_integral(ctx: EvalContext, col: DevCol, dst):
    """Parse decimal strings -> (int64 data, ok). The JAX package's rule:
    optional surrounding ASCII whitespace, an optional sign, at least one
    integer digit, an optional '.digits*' tail (truncated); anything else
    and values out of ``dst``'s range are NULL (non-ANSI)."""
    info = np.iinfo(dst.np_dtype)
    if _is_dict(col):
        val, ok = _dict_values_of(col, _host_parse_int, "int64")
    else:
        val, ok = _plain_parse_int(as_plain(col))
    if info.bits < 64:
        ok = ok & (val >= int(info.min)) & (val <= int(info.max))
    return val, ok & col.validity


def _plain_parse_int(col: DevCol):
    data = col.chars
    nc = max(int(data.shape[0]), 1)
    first, last = _nonws_span(col)
    first_ch = data[first.clamp(0, nc - 1)]
    neg = first_ch == ord("-")
    dstart = first + (neg | (first_ch == ord("+"))).to(torch.int64)
    big = 1 << 40

    def in_span(rows, i, live):
        return live & (i >= dstart[rows]) & (i <= last[rows])
    dot = _row_reduce(("amin",), col, lambda lo, hi, rows, i, live: (
        torch.where(in_span(rows, i, live) & (data[lo:hi] == ord(".")),
                    i, big),))[0]
    int_end = torch.where(dot <= last, dot - 1, last)
    ndig = int_end - dstart + 1
    p10 = host_to_device(np.asarray(_POW10[:19], np.int64), data.device)

    def digits(lo, hi, rows, i, live):
        c = data[lo:hi]
        span = in_span(rows, i, live)
        is_digit = (c >= 48) & (c <= 57)
        ok_char = is_digit | ((c == ord(".")) & (i == dot[rows]))
        in_int = span & is_digit & (i <= int_end[rows])
        # the negative magnitude, digit by digit (exact down to
        # INT64_MIN): -d * 10^(int_end - i) over at most 19 significant
        # digits
        w = int_end[rows] - i
        contrib = torch.where(in_int & (w <= 18),
                              -(c.to(torch.int64) - 48) * p10[w.clamp(0, 18)],
                              torch.zeros((), dtype=torch.int64,
                                          device=c.device))
        return ((span & ~ok_char).to(torch.int64),
                torch.where(in_int & (c != ord("0")), i, big), contrib)
    bad, sig, negmag = _row_reduce(("amax", "amin", "sum"), col, digits)
    bad = bad > 0
    nsig = torch.where(sig <= int_end, int_end - sig + 1,
                       torch.zeros_like(sig))
    # 19 digits can pass int64: detect the wrap (the sum went positive)
    wrapped = negmag > 0
    ok = (ndig >= 1) & (nsig <= 19) & ~bad & ~wrapped
    ok = ok & (neg | (negmag != -(1 << 63)))
    val = torch.where(neg, negmag, -negmag)
    return val, ok


def _host_parse_date(b: bytes):
    import re
    text = b.decode("utf-8", errors="replace").strip(" \t\n\r\v\f")
    if not re.match(r"^\d{4}-\d{2}-\d{2}", text, re.ASCII):
        return 0, False
    try:
        return int((np.datetime64(text[:10], "D")
                    - np.datetime64(0, "D")).astype(np.int64)), True
    except ValueError:
        return 0, False


def string_to_date(ctx: EvalContext, col: DevCol):
    """Parse 'yyyy-MM-dd'-prefixed strings -> (int32 days, ok): surrounding
    whitespace stripped, the first 10 bytes \\d{4}-\\d{2}-\\d{2} (trailing
    text ignored), the calendar triple validated by a round trip (month
    lengths, leap years), as the JAX package's."""
    from spark_rapids_tpu_torch.sql.exprs.datetimeexprs import (
        civil_from_days, days_from_civil,
    )
    if _is_dict(col):
        days, ok = _dict_values_of(col, _host_parse_date, "int64")
        return days.to(torch.int32), ok & col.validity
    col = as_plain(col)
    data = col.chars
    nc = max(int(data.shape[0]), 1)
    first, last = _nonws_span(col)
    ps = first[:, None] + torch.arange(10, device=data.device)[None, :]
    ch = data[ps.clamp(0, nc - 1)].to(torch.int64)
    dig = (ch >= 48) & (ch <= 57)
    pat = (dig[:, :4].all(dim=1) & dig[:, 5:7].all(dim=1)
           & dig[:, 8:].all(dim=1)
           & (ch[:, 4] == ord("-")) & (ch[:, 7] == ord("-"))
           & (last - first + 1 >= 10))
    d10 = ch - 48
    y = d10[:, 0] * 1000 + d10[:, 1] * 100 + d10[:, 2] * 10 + d10[:, 3]
    m = d10[:, 5] * 10 + d10[:, 6]
    d = d10[:, 8] * 10 + d10[:, 9]
    days = days_from_civil(y, m, d)
    ry, rm, rd = civil_from_days(days)
    ok = col.validity & pat & (ry == y) & (rm == m) & (rd == d)
    return days.to(torch.int32), ok


_UNIX_TS_RE = {False: rb"^\d{4}-\d{2}-\d{2}$",
               True: rb"^\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}$"}


def _host_parse_unix_ts(b: bytes, with_time: bool):
    """The device rule on one value's bytes: (epoch seconds, ok)."""
    import datetime
    import re
    text = b.strip(bytes(_WS))
    if not re.match(_UNIX_TS_RE[with_time], text):
        return 0, False
    y, m, d = int(text[:4]), int(text[5:7]), int(text[8:10])
    try:
        days = (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    except ValueError:
        return 0, False
    secs = days * 86400
    if with_time:
        hh, mi, ss = int(text[11:13]), int(text[14:16]), int(text[17:19])
        if hh >= 24 or mi >= 60 or ss >= 60:
            return 0, False
        secs += hh * 3600 + mi * 60 + ss
    return secs, True


def string_to_unix_ts(ctx: EvalContext, col: DevCol, with_time: bool):
    """Parse 'yyyy-MM-dd' (``with_time`` False) or 'yyyy-MM-dd HH:mm:ss'
    strings -> (int64 epoch seconds, ok), the JAX package's rule: the
    whitespace-trimmed value must have exactly the pattern's length and
    digits, a year of at least 1, a calendar triple that survives the
    round trip through days, and a time of day in range. A dictionary
    parses its values on the host; a slab or plain column in char space."""
    from spark_rapids_tpu_torch.sql.exprs.datetimeexprs import (
        civil_from_days, days_from_civil,
    )
    if _is_dict(col):
        secs, ok = _dict_values_of(
            col, functools.partial(_host_parse_unix_ts, with_time=with_time),
            "int64")
        return secs, ok & col.validity
    col = as_plain(col)
    data = col.chars
    nc = max(int(data.shape[0]), 1)
    first, last = _nonws_span(col)
    want = 19 if with_time else 10
    ps = first[:, None] + torch.arange(want, device=data.device)[None, :]
    ch = data[ps.clamp(0, nc - 1)].to(torch.int64)
    dig = (ch >= 48) & (ch <= 57)
    d10 = ch - 48
    pat = (dig[:, :4].all(dim=1) & dig[:, 5:7].all(dim=1)
           & dig[:, 8:10].all(dim=1)
           & (ch[:, 4] == ord("-")) & (ch[:, 7] == ord("-"))
           & (last - first + 1 == want))
    y = d10[:, 0] * 1000 + d10[:, 1] * 100 + d10[:, 2] * 10 + d10[:, 3]
    m = d10[:, 5] * 10 + d10[:, 6]
    d = d10[:, 8] * 10 + d10[:, 9]
    days = days_from_civil(y, m, d)
    ry, rm, rd = civil_from_days(days)
    ok = (col.validity & pat & (y >= 1) & (ry == y) & (rm == m)
          & (rd == d))
    secs = days * 86400
    if with_time:
        hh = d10[:, 11] * 10 + d10[:, 12]
        mi = d10[:, 14] * 10 + d10[:, 15]
        ss = d10[:, 17] * 10 + d10[:, 18]
        ok = ok & (dig[:, 11:13].all(dim=1) & dig[:, 14:16].all(dim=1)
                   & dig[:, 17:19].all(dim=1) & (ch[:, 10] == ord(" "))
                   & (ch[:, 13] == ord(":")) & (ch[:, 16] == ord(":"))
                   & (hh < 24) & (mi < 60) & (ss < 60))
        secs = secs + hh * 3600 + mi * 60 + ss
    return secs, ok
