"""Device equi-join pieces downstream of the probe (counterpart of the JAX
package's ``ops/joins.py``).

A probe gives, per stream row, its number of build matches (``counts``),
the first position of its match group in ``bperm`` (``bstart``) and
``bperm``, the build rows grouped by key. The port's probe is the hash
table (``ops/kernels.hash_join_probe`` on kernels B3 and B4, driven by
``exec/tpujoin.py``); the JAX package's union-lexsort ``join_probe`` and
dense ``join_probe_dense`` are not ported yet. Everything here is the
JAX package's count-then-expand: the totals come back to the host in one
copy per join (the caller's), the expand gathers both sides into a batch of
the bucketed total.

Null keys never match (SQL): rows with any invalid key column are parked
out of the probe by ``_key_valid``. Dictionary string columns ride their
codes through the expand (their char totals are 0); plain strings do not
exist in this slice.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtype import torch_dtype
from spark_rapids_tpu_torch.ops.rowops import (
    filter_batch, gather_columns, rank_of_iota,
)


def _key_valid(batch: DeviceBatch, key_idx: Sequence[int]) -> torch.Tensor:
    v = batch.row_mask()
    for ki in key_idx:
        v = v & batch.columns[ki].validity
    return v


def outer_adjusted_counts(stream: DeviceBatch,
                          counts: torch.Tensor) -> torch.Tensor:
    """Left-outer: every live stream row emits at least one output row."""
    return torch.where(stream.row_mask(), counts.clamp(min=1),
                       torch.zeros_like(counts))


def expand_totals(build: DeviceBatch, stream: DeviceBatch,
                  counts_adj: torch.Tensor) -> torch.Tensor:
    """All host-needed expansion sizes in ONE int64 device vector: [total
    rows, chars per stream string column..., chars per build string
    column...]. Dictionary strings move as codes, so their char totals
    are 0."""
    n_str = sum(1 for dt in stream.schema.dtypes + build.schema.dtypes
                if dt.is_string)
    total = counts_adj.sum(dtype=torch.int64).reshape(1)
    return torch.cat([total, torch.zeros(n_str, dtype=torch.int64,
                                         device=total.device)])


def join_expand(build: DeviceBatch, stream: DeviceBatch,
                counts: torch.Tensor, counts_adj: torch.Tensor,
                bstart: torch.Tensor, bperm: torch.Tensor,
                out_capacity: int, swap_sides: bool) -> DeviceBatch:
    """Materialize the (stream row, build row) pairs into an
    ``out_capacity`` batch, stream rows in order and each one's matches in
    ``bperm`` order. ``counts_adj`` >= ``counts`` drives emission (an outer
    stream row with no match emits one row with a null build side);
    ``swap_sides`` puts the build side's columns first (a right outer join
    runs with build = left). The caller checked that the total is below
    2^31."""
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
    stream_cols = gather_columns(stream.columns, srow, live)
    build_cols = gather_columns(build.columns, brow, live & matched)
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
