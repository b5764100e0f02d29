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
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, plain_strings_unsupported,
)
from spark_rapids_tpu_torch.ops.rowops import gather_batch

_SIGN = -(1 << 63)  # int64 holding the uint64 pattern 1 << 63
STRING_PREFIX_CHUNKS = 8  # 64 prefix bytes


def u64_key_image(col: DeviceColumn,
                  allow_dict: bool = False) -> List[torch.Tensor]:
    """Order-preserving uint64 image(s) of a column (ascending order).

    ``allow_dict``: dictionary codes are assigned in canonical sorted value
    order, so within one batch (or batches sharing one dictionary) the code
    is an exact order-preserving and equality-exact image. Other string
    columns give their prefix chunks and length (``_string_prefix_chunks``):
    exact for a char slab, whose images cover all its words."""
    if col.dtype.is_string:
        if allow_dict and col.dict_values is not None:
            return [col.dict_codes.to(torch.int64)]
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
        differ in a later word.

    The packed-chars layout is not ported (ROADMAP A.5)."""
    from spark_rapids_tpu_torch.columnar.column import host_to_device
    if col.dict_values is not None and col.dict_codes is not None:
        from spark_rapids_tpu_torch.columnar.dictionary import (
            value_prefix_chunk_tables,
        )
        code = col.dict_codes.to(torch.int64).clamp(0, col.dict_card)
        return [host_to_device(t, col.device)[code]
                for t in value_prefix_chunk_tables(col.dict_values)]
    if col.has_slab:
        w = int(col.slab64.shape[1])
        chunks = [bswap64(col.slab64[:, c]) if c < w
                  else torch.zeros(col.capacity, dtype=torch.int64,
                                   device=col.device)
                  for c in range(max(w, STRING_PREFIX_CHUNKS))]
        return chunks + [col.lens.to(torch.int64)]
    raise plain_strings_unsupported("_string_prefix_chunks")


def string_prefix8(col: DeviceColumn) -> torch.Tensor:
    """The column's 8-byte big-endian prefix image (0-padded past the end;
    pair it with the length, 'a' and 'a\\x00' alias otherwise)."""
    if col.has_slab:
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
                      allow_dict: bool = False) -> List[torch.Tensor]:
    """The per-row comparison operand vectors (null flags + order-preserving
    key images, direction applied) that sort_permutation sorts by.
    ``allow_dict`` (within-batch consumers only) lets dictionary strings
    ride their code as the image (see u64_key_image)."""
    operands: List[torch.Tensor] = []
    for ki, asc, nf in zip(key_indices, ascending, nulls_first):
        col = batch.columns[ki]
        null_flag = (~col.validity).to(torch.int64)
        operands.append(1 - null_flag if nf else null_flag)
        for img in u64_key_image(col, allow_dict=allow_dict):
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
    by their values, since the bounds come from other batches).
    ``bounds`` holds one (n-1,) int64 vector of uint64 patterns per
    operand. Returns int64 (capacity,). One bound at a time, so the
    working memory stays a few capacity-long vectors."""
    operands = [o ^ _SIGN for o in sort_key_operands(
        batch, key_indices, ascending, nulls_first)]
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
