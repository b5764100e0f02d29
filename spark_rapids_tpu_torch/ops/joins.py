"""Device equi-join pieces downstream of the probe (counterpart of the JAX
package's ``ops/joins.py``).

A probe gives, per stream row, its number of build matches (``counts``),
the first position of its match group in ``bperm`` (``bstart``) and
``bperm``, the build rows grouped by key. The port has four probes, and
``exec/tpujoin.py`` picks one a join as the JAX package does on a TPU:

  * ``join_probe_dense``, the direct-index probe, where scan statistics
    bound a single integer build key to at most 2^24 values: the build
    side sorts itself by ``key - lo`` and a (start, count) table indexed
    by that offset answers each stream row with one gather. The bounds are
    advisory: ``ok`` is False where a valid build key falls outside them,
    and the caller then takes the hash probe;
  * the hash table (``ops/kernels.hash_join_probe`` on kernels B3 and B4)
    for the other fixed-width keys;
  * ``join_probe``, the union lexsort, for a join with a string key: the
    build and stream key images sorted together give every row a dense
    key id. Images are exact: dictionary codes (two different
    dictionaries remapped into their union on the host), or every word of
    a char slab and its length (a dictionary against a slab becomes a slab
    of the same stride), or, where a side is plain chars, the 64-byte
    prefix chunks, the rank of the tails that tie on them and the length
    (``sortops.string_images`` over both sides at once; the JAX package
    narrows with two polynomial hashes and verifies by extents), so no
    hash decides a match;
  * ``cross_probe``, the cross route of the JAX package's ``join_probe``.

Everything downstream is the JAX package's count-then-expand: the totals
come back to the host in one copy per join (the caller's), the expand
gathers both sides into a batch of the bucketed total.

Null keys never match (SQL): rows with any invalid key column are parked
out of the probe by ``_key_valid``. Dictionary string columns ride their
codes through the expand (their char totals are 0), char slabs their rows,
plain columns their bytes, at the char totals the expand's one sync
reads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, char_bucket
from spark_rapids_tpu_torch.columnar.dtype import torch_dtype
from spark_rapids_tpu_torch.ops.rowops import (
    filter_batch, gather_columns, rank_of_iota,
)


def _key_valid(batch: DeviceBatch, key_idx: Sequence[int]) -> torch.Tensor:
    v = batch.row_mask()
    for ki in key_idx:
        v = v & batch.columns[ki].validity
    return v


def _slab_words(col: DeviceColumn, nwords: int) -> List[torch.Tensor]:
    """A slab's words as exact equality images, zero words past its width,
    then its length."""
    w = int(col.slab64.shape[1])
    zero = torch.zeros(col.capacity, dtype=torch.int64, device=col.device)
    return [col.slab64[:, i] if i < w else zero for i in range(nwords)] + [
        col.lens.to(torch.int64)]


def _string_key_images(bc: DeviceColumn, sc: DeviceColumn):
    """Exact equality images of a string key pair, one list a side, equal
    in length: dictionary codes (remapped into the union of two different
    dictionaries by a host table a side), else every slab word and the
    length, a dictionary side becoming a slab of the other side's stride
    first."""
    from spark_rapids_tpu_torch.columnar.column import (
        MAX_SLAB_STRIDE, host_to_device, slab_stride_for,
    )
    from spark_rapids_tpu_torch.ops.rowops import dict_to_slab
    from spark_rapids_tpu_torch.ops.sortops import string_images
    if bc.is_plain or sc.is_plain:
        bi, si = string_images([bc, sc])
        return bi, si
    if bc.dict_values is not None and sc.dict_values is not None:
        if bc.dict_values == sc.dict_values:
            return ([bc.dict_codes.to(torch.int64)],
                    [sc.dict_codes.to(torch.int64)])
        from spark_rapids_tpu_torch.columnar.dictionary import (
            union_dictionaries,
        )
        _u, remaps = union_dictionaries([bc.dict_values, sc.dict_values])
        return tuple(
            [host_to_device(r.astype(np.int64), c.device)[
                c.dict_codes.clamp(0, c.dict_card).long()]]
            for c, r in ((bc, remaps[0]), (sc, remaps[1])))

    def stride_of(c: DeviceColumn) -> int:
        if c.has_slab:
            return c.char_stride
        return slab_stride_for(max((len(v.encode("utf-8"))
                                    for v in c.dict_values), default=0),
                               1 << 30)
    stride = max(stride_of(bc), stride_of(sc))
    if not (bc.has_slab or sc.has_slab) or (
            stride > MAX_SLAB_STRIDE and not (bc.has_slab and sc.has_slab)):
        # a dictionary of long values against a slab: exact images
        # without a slab as wide as its longest value
        return tuple(string_images([bc, sc]))
    bc, sc = (c if c.has_slab else dict_to_slab(c, stride) for c in (bc, sc))
    return _slab_words(bc, stride // 8), _slab_words(sc, stride // 8)


def key_images_pair(build: DeviceBatch, stream: DeviceBatch,
                    build_keys: Sequence[int], stream_keys: Sequence[int]):
    """(build images, stream images): exact equality images of each key
    pair, the same number a side."""
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image
    b_imgs: List[torch.Tensor] = []
    s_imgs: List[torch.Tensor] = []
    for bk, sk in zip(build_keys, stream_keys):
        bc, sc = build.columns[bk], stream.columns[sk]
        if bc.dtype.is_string:
            bi, si = _string_key_images(bc, sc)
        else:
            bi, si = u64_key_image(bc), u64_key_image(sc)
        b_imgs.extend(bi)
        s_imgs.extend(si)
    return b_imgs, s_imgs


def _sorted_ranges(key: torch.Tensor, size: int):
    """(starts, counts, perm) of int32 ``key`` values in [0, size], size
    meaning none: ``perm`` the rows stably sorted by key, and for each
    key below ``size`` its first position in ``perm`` and its row count,
    both int32 (size,). The ranges come from binary searches in the
    sorted keys, not from a histogram, whose atomics would serialise on
    the one bucket every dead and null-keyed row falls into."""
    ordered, perm = torch.sort(key, stable=True)
    bounds = torch.searchsorted(ordered, torch.arange(
        size + 1, dtype=key.dtype, device=key.device), out_int32=True)
    return bounds[:-1], bounds[1:] - bounds[:-1], perm.to(torch.int32)


def join_probe(build: DeviceBatch, stream: DeviceBatch,
               build_keys: Sequence[int], stream_keys: Sequence[int]):
    """The union-lexsort probe (the JAX package's ``join_probe``): one
    stable lexsort over the union of both sides' key images (dead and
    null-keyed rows last) gives every valid row a dense key id; the build
    rows sorted by id and a (start, count) table over the id space answer
    each stream row. Returns (counts, bstart, bperm), bperm this stream
    batch's (the ids are the union's)."""
    from spark_rapids_tpu_torch.ops.sortops import lexsort_permutation
    nb, ns = build.capacity, stream.capacity
    dev = stream.device
    b_imgs, s_imgs = key_images_pair(build, stream, build_keys, stream_keys)
    bkv = _key_valid(build, build_keys)
    skv = _key_valid(stream, stream_keys)
    imgs = [torch.cat([bi, si]) for bi, si in zip(b_imgs, s_imgs)]
    invalid = (~torch.cat([bkv, skv])).to(torch.int64)
    perm = lexsort_permutation([invalid] + imgs).long()
    valid_s = invalid[perm] == 0
    # a group starts at position 0 and wherever any image differs from
    # the previous row's
    differs = torch.arange(nb + ns, device=dev) == 0
    for img in imgs:
        v = img[perm]
        differs[1:] |= v[1:] != v[:-1]
    boundary = differs & valid_s
    pid = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    pid = torch.where(valid_s, pid, torch.full_like(pid, -1))
    ids = torch.empty(nb + ns, dtype=torch.int32, device=dev).scatter_(
        0, perm, pid)
    bid, sid = ids[:nb], ids[nb:]
    nid = nb + ns
    bid_key = torch.where(bkv, bid, torch.full_like(bid, nid))
    starts, cntb, bperm = _sorted_ranges(bid_key, nid)
    hit = skv & (sid >= 0)
    sid_c = torch.where(hit, sid, torch.zeros_like(sid)).long()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.where(hit, cntb[sid_c], zero)
    bstart = torch.where(hit, starts[sid_c], zero)
    return counts, bstart, bperm


class DenseTable:
    """The build side of the dense probe: ``starts`` and ``cnt`` by key
    offset, ``bperm`` (the build rows sorted by offset, out-of-table and
    null-keyed rows last), ``lo`` and ``ok``, a 0-d bool device flag that
    every valid build key fell inside the table."""

    def __init__(self, starts, cnt, bperm, lo: int, ok):
        self.starts = starts
        self.cnt = cnt
        self.bperm = bperm
        self.lo = lo
        self.ok = ok

    @property
    def size(self) -> int:
        return int(self.cnt.shape[0])


def dense_build(build: DeviceBatch, build_key: int, lo: int,
                table_size: int) -> DenseTable:
    """The dense probe's build step: one stable sort of the build rows by
    their key's offset from ``lo`` (one int32 operand), then each offset's
    range of rows (``_sorted_ranges``). No host wait: ``ok`` stays on the
    device."""
    bkv = _key_valid(build, [build_key])
    boff = build.columns[build_key].data.to(torch.int64) - lo
    in_tbl = (boff >= 0) & (boff < table_size)
    ok = (in_tbl | ~bkv).all()
    off_key = torch.where(in_tbl & bkv, boff,
                          torch.full_like(boff, table_size)).to(torch.int32)
    starts, cnt, bperm = _sorted_ranges(off_key, table_size)
    return DenseTable(starts, cnt, bperm, lo, ok)


def dense_lookup(table: DenseTable, stream: DeviceBatch, stream_key: int):
    """(counts, bstart) of every stream row: one gather of the table at
    its key's offset; a key outside the table matches nothing (exact once
    ``table.ok`` holds, as every build key is then inside)."""
    skv = _key_valid(stream, [stream_key])
    soff = stream.columns[stream_key].data.to(torch.int64) - table.lo
    s_in = skv & (soff >= 0) & (soff < table.size)
    sidx = soff.clamp(0, table.size - 1)
    zero = torch.zeros((), dtype=torch.int32, device=stream.device)
    return torch.where(s_in, table.cnt[sidx], zero), table.starts[sidx]


def join_probe_dense(build: DeviceBatch, stream: DeviceBatch,
                     build_key: int, stream_key: int, lo: int,
                     table_size: int):
    """The dense-key direct-index probe (the JAX package's
    ``join_probe_dense``): (counts, bstart, bperm, ok), ``ok`` False where
    a valid build key fell outside [lo, lo + table_size)."""
    table = dense_build(build, build_key, lo, table_size)
    counts, bstart = dense_lookup(table, stream, stream_key)
    return counts, bstart, table.bperm, table.ok


def cross_probe(build: DeviceBatch, stream: DeviceBatch):
    """The cross route of the JAX package's ``join_probe``: every live
    stream row matches every live build row. Returns (counts, bstart,
    bperm): counts the build's live row count for each live stream row,
    bstart 0, bperm the live build rows first, in order. The JAX package
    sorts the dead flags stably for it; a batch's live rows are its
    leading ones, so that order is the identity. No table, no kernel, no
    host wait."""
    ns = stream.capacity
    counts = torch.where(stream.row_mask(), build.num_rows.to(torch.int32),
                         torch.zeros((), dtype=torch.int32,
                                     device=stream.device))
    bstart = torch.zeros(ns, dtype=torch.int32, device=stream.device)
    bperm = torch.arange(build.capacity, dtype=torch.int32,
                         device=build.device)
    return counts, bstart, bperm


def outer_adjusted_counts(stream: DeviceBatch,
                          counts: torch.Tensor) -> torch.Tensor:
    """Left-outer: every live stream row emits at least one output row."""
    return torch.where(stream.row_mask(), counts.clamp(min=1),
                       torch.zeros_like(counts))


def expand_totals(build: DeviceBatch, stream: DeviceBatch,
                  counts_adj: torch.Tensor, counts: torch.Tensor,
                  bstart: torch.Tensor, bperm: torch.Tensor) -> torch.Tensor:
    """All host-needed expansion sizes in ONE int64 device vector: [total
    rows, chars per stream string column..., chars per build string
    column...]. Dictionary strings move as codes and slabs as rows, so
    their char totals are 0; a plain column's is the bytes its rows take
    in the output: a stream row's length times its emitted rows, a
    stream row's match group's lengths summed over the build rows in
    ``bperm`` order."""
    total = counts_adj.sum(dtype=torch.int64).reshape(1)
    zero = torch.zeros(1, dtype=torch.int64, device=total.device)
    out = [total]
    for c in stream.columns:
        if c.dtype.is_string:
            out.append((c.lens_().to(torch.int64) * counts_adj).sum()
                       .reshape(1) if c.is_plain else zero)
    for c in build.columns:
        if not c.dtype.is_string:
            continue
        if not c.is_plain:
            out.append(zero)
            continue
        # prefix sums of the build lengths in bperm order: a match group
        # [bstart, bstart + count) sums to one difference
        blens = c.lens_().to(torch.int64)[bperm.long()]
        pre = torch.zeros(blens.shape[0] + 1, dtype=torch.int64,
                          device=blens.device)
        pre[1:] = torch.cumsum(blens, 0)
        lo = bstart.to(torch.int64).clamp(0, blens.shape[0])
        hi = (lo + counts.to(torch.int64)).clamp(max=blens.shape[0])
        out.append(torch.where(counts > 0, pre[hi] - pre[lo],
                               torch.zeros_like(lo)).sum().reshape(1))
    return torch.cat(out)


def _char_caps(batch: DeviceBatch, totals) -> List[Optional[int]]:
    """``gather_columns``' char capacities of ``batch``'s columns: a plain
    column's from the next of ``totals`` (one entry a string column)."""
    out: List[Optional[int]] = []
    for c in batch.columns:
        t = next(totals, None) if c.dtype.is_string else None
        out.append(char_bucket(t) if c.dtype.is_string and c.is_plain
                   else None)
    return out


def join_expand(build: DeviceBatch, stream: DeviceBatch,
                counts: torch.Tensor, counts_adj: torch.Tensor,
                bstart: torch.Tensor, bperm: torch.Tensor,
                out_capacity: int, swap_sides: bool,
                char_totals: Sequence[int] = ()) -> DeviceBatch:
    """Materialize the (stream row, build row) pairs into an
    ``out_capacity`` batch, stream rows in order and each one's matches in
    ``bperm`` order. ``counts_adj`` >= ``counts`` drives emission (an outer
    stream row with no match emits one row with a null build side);
    ``swap_sides`` puts the build side's columns first (a right outer join
    runs with build = left). ``char_totals`` are ``expand_totals``' char
    entries, read on the host: they size the plain columns' chars. The
    caller checked that the total is below 2^31."""
    nb, ns = build.capacity, stream.capacity
    incl = torch.cumsum(counts_adj, 0, dtype=torch.int64).to(torch.int32)
    total = counts_adj.sum(dtype=torch.int64).to(torch.int32)
    excl = incl - counts_adj
    k = torch.arange(out_capacity, dtype=torch.int32, device=counts.device)
    srow = rank_of_iota(incl, out_capacity).clamp(0, max(ns - 1, 0)).long()
    j = k - excl[srow]
    c = counts[srow]
    matched = c > 0
    slot = bstart[srow] + torch.minimum(j, (c - 1).clamp(min=0))
    brow = bperm[slot.clamp(0, max(nb - 1, 0)).long()]
    live = k < total
    caps = iter(char_totals)
    stream_cols = gather_columns(stream.columns, srow, live,
                                 _char_caps(stream, caps))
    build_cols = gather_columns(build.columns, brow, live & matched,
                                _char_caps(build, caps))
    if swap_sides:
        names = list(build.schema.names) + list(stream.schema.names)
        dts = list(build.schema.dtypes) + list(stream.schema.dtypes)
        cols = build_cols + stream_cols
    else:
        names = list(stream.schema.names) + list(build.schema.names)
        dts = list(stream.schema.dtypes) + list(build.schema.dtypes)
        cols = stream_cols + build_cols
    return DeviceBatch(Schema(names, dts), cols, total.to(torch.int32))


def build_match_flags(build: DeviceBatch, counts: torch.Tensor,
                      bstart: torch.Tensor,
                      bperm: torch.Tensor) -> torch.Tensor:
    """bool (nb,): build rows matched by any stream row (for full outer).
    Coverage of the bperm ranges via +1/-1 deltas and a prefix sum."""
    nb = build.capacity
    one = (counts > 0).to(torch.int32)
    delta = torch.zeros(nb + 1, dtype=torch.int32, device=counts.device)
    delta.index_add_(0, bstart.to(torch.int64).clamp(0, nb), one)
    delta.index_add_(0, (bstart.to(torch.int64) + counts).clamp(0, nb),
                     -one)
    covered = torch.cumsum(delta, 0, dtype=torch.int32)[:nb] > 0
    flags = torch.zeros(nb, dtype=torch.bool, device=counts.device)
    flags[bperm.long()] = covered
    return flags


def null_columns(schema: Schema, capacity: int, device) -> List[DeviceColumn]:
    """All-null columns of ``schema`` (the missing side of outer-join rows).
    A string column is a dictionary column with an empty dictionary, every
    code the NULL sentinel 0."""
    validity = torch.zeros(capacity, dtype=torch.bool, device=device)
    cols = []
    for dt in schema.dtypes:
        if dt.is_string:
            cols.append(DeviceColumn(
                dt, None, validity,
                torch.zeros(capacity, dtype=torch.int32, device=device), ()))
        else:
            cols.append(DeviceColumn(
                dt, torch.zeros(capacity, dtype=torch_dtype(dt.np_dtype),
                                device=device), validity))
    return cols


def unmatched_build_batch(build: DeviceBatch, matched: torch.Tensor,
                          stream_schema: Schema,
                          swap_sides: bool) -> DeviceBatch:
    """Full-outer tail: build rows no stream row matched, with an all-null
    stream side. Output capacity = build capacity (compacted)."""
    compact = filter_batch(build, build.row_mask() & ~matched)
    nulls = null_columns(stream_schema, compact.capacity, build.device)
    if swap_sides:
        names = list(build.schema.names) + list(stream_schema.names)
        dts = list(build.schema.dtypes) + list(stream_schema.dtypes)
        cols = list(compact.columns) + nulls
    else:
        names = list(stream_schema.names) + list(build.schema.names)
        dts = list(stream_schema.dtypes) + list(build.schema.dtypes)
        cols = nulls + list(compact.columns)
    return DeviceBatch(Schema(names, dts), cols, compact.num_rows)


def semi_anti_filter(stream: DeviceBatch, counts: torch.Tensor,
                     anti: bool) -> DeviceBatch:
    """leftsemi: stream rows with >= 1 match; leftanti: live rows with none
    (null-keyed rows count as unmatched: SQL null never equals)."""
    if anti:
        mask = stream.row_mask() & (counts == 0)
    else:
        mask = counts > 0
    return filter_batch(stream, mask)
