"""Multi-key sort (counterpart of the JAX package's ``ops/sortops.py``:
order-preserving key images, the lexicographic sort permutation, the
within-batch Sort and the range partition ids of the external sort).

Images are int64 tensors holding the JAX package's uint64 images bit for
bit (see ops/hashing.py for the int64 convention). ``torch.sort`` on int64
is signed, so each pass flips the sign bit first, which turns the unsigned
order of the patterns into the signed order of the flipped values. The
sort runs as LSD passes of a stable ``torch.sort`` (least significant key
first), which give the same permutation as the JAX package's stable
multi-operand ``lax.sort``. Null ordering is a separate leading flag per
key (asc -> nulls first by default, like Spark).

A plain string column (offsets and chars) has the JAX package's images:
its 64-byte big-endian prefix chunks and its length. The JAX package's
order stops there; the port's stays exact (``string_images``): rows that
tie on those images and are longer than 64 bytes get one more image, the
dense rank of their remaining bytes among every such row, computed only
over those rows' bytes by prefix doubling (ranks of 8-byte chunks, then of
pairs of ranks, ...), after one counted sync that reads how many rows tie.
No image scales with rows x the longest value.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, dict_char_tables, host_to_device, is_dict, is_plain,
    is_slab,
    offsets_of, plain_prefix_words, string_lens,
)
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops.rowops import gather_batch

_SIGN = -(1 << 63)  # int64 holding the uint64 pattern 1 << 63
STRING_PREFIX_CHUNKS = 8  # 64 prefix bytes


def u64_key_image(col: DeviceColumn, allow_dict: bool = False,
                  exact: bool = True) -> List[torch.Tensor]:
    """Order-preserving uint64 image(s) of a column (ascending order).

    ``allow_dict``: dictionary codes are assigned in canonical sorted value
    order, so within one batch (or batches sharing one dictionary) the code
    is an exact order-preserving and equality-exact image. Other string
    columns give their prefix chunks and length (``_string_prefix_chunks``):
    exact for a char slab, whose images cover all its words; a plain
    column adds the rank of its tied tails (``string_images``) unless
    ``exact`` is off (images that must compare across batches: a tail
    rank is only valid within the rows ranked together)."""
    if col.dtype.is_string:
        if allow_dict and col.dict_values is not None:
            return [col.dict_codes.to(torch.int64)]
        if exact and is_plain(col):
            return string_images([col])[0]
        return _string_prefix_chunks(col)
    d = col.data
    if d.dtype == torch.bool:
        return [d.to(torch.int64)]
    if d.dtype.is_floating_point:
        from spark_rapids_tpu_torch.ops.floatbits import f64_bits
        bits = f64_bits(d)
        # negatives: flip every bit; positives: set the sign bit
        return [torch.where(bits < 0, ~bits, bits | _SIGN)]
    # signed integers (incl. date/timestamp reps): flip the sign bit
    return [d.to(torch.int64) ^ _SIGN]


def bswap64(x: torch.Tensor) -> torch.Tensor:
    """Byte-reverse 64-bit words: a slab word (byte j at bit 8*j) becomes
    the big-endian image whose unsigned order is the bytes' order."""
    return x.contiguous().view(torch.uint8).view(-1, 8).flip(1) \
        .view(torch.int64).view(x.shape)


def _string_prefix_chunks(col: DeviceColumn) -> List[torch.Tensor]:
    """STRING_PREFIX_CHUNKS big-endian 8-byte prefix images and a trailing
    length, the images the JAX package compares strings by (past-end bytes
    are 0x00, and the length settles 'a' < 'ab'):

      * a dictionary column gathers its per-value tables by code
        (``columnar/dictionary.value_prefix_chunk_tables``), pure functions
        of the value bytes, so they compare exactly against any other
        column's images;
      * a char slab's chunk c is its word c byte-swapped, and zero past the
        slab's width (bytes past a row's length are zero by the slab
        invariant). A slab wider than the prefix gives every word, so its
        images stay exact: rows that tie on 64 bytes and the length still
        differ in a later word;
      * a plain column's chunks are its first 64 bytes, gathered by row
        (``column.plain_prefix_words``); past 64 bytes they tie, and
        ``string_images`` settles the ties."""
    if col.dict_values is not None and col.dict_codes is not None:
        from spark_rapids_tpu_torch.columnar.dictionary import (
            value_prefix_chunk_tables,
        )
        code = col.dict_codes.to(torch.int64).clamp(0, len(col.dict_values))
        return [host_to_device(t, col.validity.device)[code]
                for t in value_prefix_chunk_tables(col.dict_values)]
    if is_slab(col):
        w = int(col.slab64.shape[1])
        chunks = [bswap64(col.slab64[:, c]) if c < w
                  else torch.zeros(col.slab64.shape[0], dtype=torch.int64,
                                   device=col.slab64.device)
                  for c in range(max(w, STRING_PREFIX_CHUNKS))]
        return chunks + [col.lens.to(torch.int64)]
    words = plain_prefix_words(col, 8 * STRING_PREFIX_CHUNKS)
    return [bswap64(words[:, c]) for c in range(STRING_PREFIX_CHUNKS)] + [
        string_lens(col).to(torch.int64)]


def string_images(cols: Sequence) -> List[List[torch.Tensor]]:
    """Exact order-preserving images of string columns of any forms that
    are compared with each other (a sort key, the two sides of a join key
    or a comparison): per column, the 8 prefix chunks, the length and,
    where valid rows longer than 64 bytes tie on those, the dense rank of
    their remaining bytes (0 for every other row). Images of two rows are
    equal exactly where their values are, and compare as the values do.
    One counted sync (``strings.tieSettle``) reads how many rows tie.

    The tail rank sits between the chunks and the length: rows that tie
    on 64 bytes are ordered by their zero-padded remaining bytes, then by
    length (a shorter row is then a prefix of the longer one)."""
    prefix = [_prefix_images(c) for c in cols]
    tail = _tail_ranks(cols, prefix)
    if tail is None:
        return prefix
    return [p[:-1] + [t] + p[-1:] for p, t in zip(prefix, tail)]


def _prefix_images(col) -> List[torch.Tensor]:
    """The 8 prefix chunks and the length of any string form (a slab
    wider than 64 bytes gives only its first 8 words here)."""
    imgs = _string_prefix_chunks(col)
    if col.dict_values is None and col.slab64 is not None:
        imgs = imgs[:STRING_PREFIX_CHUNKS] + imgs[-1:]
    return imgs


def _tail_sources(cols) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes, row starts) over every column's rows: one flat byte buffer
    holding each column's chars (a plain column's chars, a slab's words, a
    dictionary's values) and the start of each row's value in it, without
    rebuilding any column."""
    bufs, starts, base = [], [], 0
    for c in cols:
        dev = c.validity.device
        cap = int(c.validity.shape[0])
        if is_dict(c):
            dchars, dstarts, _dl = dict_char_tables(c.dict_values)
            buf = host_to_device(dchars, dev)
            st = host_to_device(dstarts.astype(np.int64), dev)[
                c.dict_codes.to(torch.int64).clamp(0, len(c.dict_values))]
        elif c.slab64 is not None:
            buf = c.slab64.contiguous().view(torch.uint8).reshape(-1)
            st = torch.arange(cap, dtype=torch.int64,
                              device=dev) * (int(c.slab64.shape[1]) * 8)
        else:
            buf, st = c.chars, c.offsets[:-1].to(torch.int64)
        bufs.append(buf)
        starts.append(st + base)
        base += int(buf.shape[0])
    return torch.cat(bufs), torch.cat(starts)


def _dense_rank(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 dense rank (from 1) of each element's key tuple, in the
    tuples' unsigned lexicographic order."""
    perm = lexsort_permutation(keys).long()
    n = perm.shape[0]
    # built on the device: a scalar written into a CUDA tensor is a
    # synchronising copy
    new = torch.arange(n, device=perm.device) == 0
    for k in keys:
        ks = k[perm]
        new[1:] |= ks[1:] != ks[:-1]
    rank = torch.empty(n, dtype=torch.int64, device=perm.device)
    rank[perm] = torch.cumsum(new, 0)
    return rank


def _tail_ranks(cols, prefix):
    """Per column, int64 (capacity,) dense ranks (from 1) of the bytes past
    64 of the valid rows longer than 64 bytes that tie with another row on
    the prefix chunks of ``prefix`` (0 elsewhere), or None when no row
    ties."""
    from spark_rapids_tpu_torch.ops.kernels import compact_permutation
    head = 8 * STRING_PREFIX_CHUNKS
    valid = torch.cat([c.validity for c in cols])
    imgs = [torch.cat(parts) for parts in zip(*prefix)]
    lens = imgs.pop()
    dev = valid.device
    n = valid.shape[0]
    perm = lexsort_permutation([(~valid).to(torch.int64)] + imgs).long()
    vs = valid[perm]
    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = vs[1:] & vs[:-1]
    for im in imgs:
        v = im[perm]
        same[1:] &= v[1:] == v[:-1]
    tied_s = same.clone()
    tied_s[:-1] |= same[1:]
    tied = torch.zeros(n, dtype=torch.bool, device=dev)
    tied[perm] = tied_s & (lens[perm] > head)
    tail_len = torch.where(tied, lens - head, torch.zeros_like(lens))
    nch = (tail_len + 7) // 8
    stats = torch.stack([tied.sum(), nch.sum(), tail_len.max()])
    with sync_scope("strings.tieSettle", nbytes=24):
        n_tied, n_chunks, max_tail = stats.cpu().tolist()
    if not n_tied:
        return None
    buf, starts = _tail_sources(cols)
    tperm, _cnt = compact_permutation(tied)
    rows = tperm[:n_tied].long()
    tstart = starts[rows] + head
    tlen = tail_len[rows]
    cnt = nch[rows].to(torch.int32)
    # level 0: the rank of each 8-byte chunk (big-endian, zero past the end)
    off = offsets_of(cnt)
    e = torch.arange(n_chunks, dtype=torch.int32, device=dev)
    row = torch.searchsorted(off[1:].contiguous(), e, right=True).clamp(
        max=n_tied - 1)
    q = (e - off[row]).to(torch.int64) * 8
    j = torch.arange(8, dtype=torch.int64, device=dev)[None, :]
    pos = (tstart[row][:, None] + q[:, None] + j).clamp(
        0, max(int(buf.shape[0]) - 1, 0))
    byte = torch.where(q[:, None] + j < tlen[row][:, None], buf[pos],
                       torch.zeros((), dtype=torch.uint8, device=dev))
    rank = _dense_rank([bswap64(byte.contiguous().view(torch.int64)
                                .reshape(-1))])
    # each level ranks pairs of the previous level's ranks (0: no second),
    # until every row holds one rank
    bound = n_chunks
    for _level in range((-(-int(max_tail) // 8) - 1).bit_length()):
        nxt = (cnt + 1) // 2
        noff = offsets_of(nxt)
        bound = (bound + n_tied + 1) // 2
        f = torch.arange(bound, dtype=torch.int32, device=dev)
        row = torch.searchsorted(noff[1:].contiguous(), f, right=True).clamp(
            max=n_tied - 1)
        q2 = 2 * (f - noff[row])
        a_at = (off[row] + q2).to(torch.int64).clamp(max=rank.shape[0] - 1)
        has_b = q2 + 1 < cnt[row]
        a = rank[a_at]
        b = torch.where(has_b, rank[(a_at + 1).clamp(max=rank.shape[0] - 1)],
                        torch.zeros_like(a))
        rank = _dense_rank([a, b])
        cnt, off = nxt, noff
    tail = torch.zeros(n, dtype=torch.int64, device=dev)
    tail[rows] = rank[off[:-1].to(torch.int64)]
    out, at = [], 0
    for c in cols:
        cap = int(c.validity.shape[0])
        out.append(tail[at:at + cap])
        at += cap
    return out


def string_prefix8(col: DeviceColumn) -> torch.Tensor:
    """The column's 8-byte big-endian prefix image (0-padded past the end;
    pair it with the length, 'a' and 'a\\x00' alias otherwise)."""
    if is_slab(col):
        return bswap64(col.slab64[:, 0])
    return _string_prefix_chunks(col)[0]


def lexsort_permutation(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort over operand vectors (priority order),
    each an int64 tensor holding uint64 patterns. Returns int32 (n,)."""
    ops = list(operands)
    n = ops[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=ops[0].device)
    for key in reversed(ops):
        flipped = key.to(torch.int64)[perm] ^ _SIGN
        perm = perm[torch.sort(flipped, stable=True).indices]
    return perm.to(torch.int32)


def lexsort_live_last(operands: Sequence[torch.Tensor],
                      dead: torch.Tensor) -> torch.Tensor:
    """lexsort_permutation with dead rows sorted last."""
    return lexsort_permutation([dead.to(torch.int64)] + list(operands))


def sort_key_operands(batch: DeviceBatch, key_indices: Sequence[int],
                      ascending: Sequence[bool],
                      nulls_first: Sequence[bool],
                      allow_dict: bool = False,
                      exact: bool = True) -> List[torch.Tensor]:
    """The per-row comparison operand vectors (null flags + order-preserving
    key images, direction applied) that sort_permutation sorts by.
    ``allow_dict`` (within-batch consumers only) lets dictionary strings
    ride their code as the image (see u64_key_image); ``exact`` off gives
    plain strings only their prefix images, which compare across batches
    (the range partitioner's)."""
    operands: List[torch.Tensor] = []
    for ki, asc, nf in zip(key_indices, ascending, nulls_first):
        col = batch.columns[ki]
        null_flag = (~col.validity).to(torch.int64)
        operands.append(1 - null_flag if nf else null_flag)
        for img in u64_key_image(col, allow_dict=allow_dict, exact=exact):
            operands.append(img if asc else ~img)
    return operands


def sort_permutation(batch: DeviceBatch, key_indices: Sequence[int],
                     ascending: Sequence[bool],
                     nulls_first: Sequence[bool]) -> torch.Tensor:
    """Row permutation sorting live rows; padding rows sort to the end.
    Within one batch dictionary strings sort by code (order-preserving by
    construction)."""
    return lexsort_live_last(
        sort_key_operands(batch, key_indices, ascending, nulls_first,
                          allow_dict=True),
        ~batch.row_mask())


def sort_batch(batch: DeviceBatch, key_indices: Sequence[int],
               ascending: Sequence[bool],
               nulls_first: Sequence[bool]) -> DeviceBatch:
    perm = sort_permutation(batch, key_indices, ascending, nulls_first)
    return gather_batch(batch, perm, batch.num_rows)


def range_partition_ids(batch: DeviceBatch, key_indices: Sequence[int],
                        ascending: Sequence[bool],
                        nulls_first: Sequence[bool],
                        bounds: List[torch.Tensor]) -> torch.Tensor:
    """Partition id per row for range partitioning (reference:
    GpuRangePartitioner.scala:42-120): the number of upper bounds the row
    is strictly greater than, compared lexicographically over the sort-key
    operand vectors (unsigned, as the sort orders them; dictionary strings
    by their values and plain ones by their prefix images, since the
    bounds come from other batches: rows tying on those share a range).
    ``bounds`` holds one (n-1,) int64 vector of uint64 patterns per
    operand. Returns int64 (capacity,). One bound at a time, so the
    working memory stays a few capacity-long vectors."""
    operands = [o ^ _SIGN for o in sort_key_operands(
        batch, key_indices, ascending, nulls_first, exact=False)]
    pid = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    nb = bounds[0].shape[0] if bounds else 0
    flipped = [b ^ _SIGN for b in bounds]
    for j in range(nb):
        gt = torch.zeros(batch.capacity, dtype=torch.bool,
                         device=batch.device)
        eq = torch.ones_like(gt)
        for o, b in zip(operands, flipped):
            bj = b[j]
            gt = gt | (eq & (o > bj))
            eq = eq & (o == bj)
        pid += gt
    return pid
