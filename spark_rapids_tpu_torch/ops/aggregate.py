"""Grouped aggregation of device batches: the update (partial) and merge
steps (counterpart of the JAX package's ``ops/aggregate.py``).

``_grouped_reduce`` takes the JAX package's branches in its order (and
``aggregate_passthrough`` is the skipped partial pass):

  1. ``_single_group_reduce``: no keys (a global aggregate; TPC-H Q6);
  2. ``_sorted_space_reduce``: a string min/max/first/last, over the
     ordered slots of ``groupby.segment_select_string``;
  3. ``_dict_reduce``: every key dictionary-encoded and the joint slot table
     small: the slot is arithmetic on the codes and the counts and sums run
     through ops/densered.py (the JAX package's ``_dict_matmul_reduce``;
     TPC-H Q1);
  4. ``_hash_payload_reduce``: the one-pass hash aggregation on kernel B2,
     under ``spark.rapids.sql.agg.hashAggEnabled``; it declines (None) when
     the table would pass ``agg.hash.maxTableSlots`` or a key is a char
     slab, and the branches below take the batch;
  5. ``_sorted_payload_reduce``: keys that are not all dictionary-encoded
     (the JAX package's default for unbounded keys: TPC-H Q3, Q10, Q18);
  6. ``_rowspace_reduce``: dictionary keys past the dictionary branch (a
     joint table above DICT_SLOT_MAX, or a batch above 2^23 rows): a
     sort-free slot attempt, else the hash sort.

Kernel B1 compacts the sorted-payload branch's group boundaries into
representative rows, and the row-space slot attempt's used slots, as in
the JAX package. ``BRANCHES`` counts the branch each call took.

The dense-key branch (``dense_composite``, under the session's capacity
speculation) waits for ROADMAP A.10 and ``count_distinct_reduce`` for its
caller, ``exec/aggfuse.py`` (A.4). Two deliberate differences from the JAX
package, with the same results:

  * **Width.** ``_rowspace_reduce``'s sort branch reduces at capacity
    width. The JAX package reduces at GROUP_SLOTS width when the groups fit
    (a ``lax.cond``), because its scatter cost scales with the output width
    on the TPU; here that choice would cost a host sync.
  * **One counted sync.** The JAX package picks the row-space slot attempt
    or the sort on the device (``lax.cond``); the port reads the attempt's
    verdict on the host, one counted sync (``agg.slotAttempt``) a call.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, host_to_device
from spark_rapids_tpu_torch.columnar.dtype import DType, torch_dtype
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import groupby as gb
from spark_rapids_tpu_torch.ops.groupby import segment_op
from spark_rapids_tpu_torch.sql.exprs.core import BoundRef, Expression
from spark_rapids_tpu_torch.sql.exprs.evalbridge import (
    make_context, to_device_column,
)

# cap on the direct dictionary slot table (product of per-key
# cardinalities + 1 each), as in the JAX package
DICT_SLOT_MAX = 4096

# slot count of the row-space branch's sort-free attempt
SLOT_TABLE = 8192

# calls of each branch of _grouped_reduce (and of the row-space branch's
# slot and sort halves), as kernels.LAUNCHES counts kernel launches
BRANCHES: Counter = Counter()


def reset_branches() -> None:
    BRANCHES.clear()


def aggregate_update(batch: DeviceBatch,
                     key_exprs: Sequence[Expression],
                     input_exprs: Sequence[Expression],
                     reductions: Sequence[Tuple[str, int, DType]],
                     out_schema: Schema,
                     hash_table: int = None) -> DeviceBatch:
    """Partial aggregation of one batch: group by evaluated keys, reduce
    evaluated inputs. reductions: (kind, input_index, out_dtype).
    ``hash_table``: optional max slot count enabling the one-pass hash
    aggregation branch."""
    ctx = make_context(batch)
    # plain column-reference keys pass the ORIGINAL column through so the
    # upload's dictionary codes survive
    key_cols = [batch.columns[e.index] if isinstance(e, BoundRef)
                else to_device_column(ctx, e.eval_device(ctx))
                for e in key_exprs]
    input_cols = [to_device_column(ctx, e.eval_device(ctx))
                  for e in input_exprs]
    work_schema = Schema(
        [f"k{i}" for i in range(len(key_cols))]
        + [f"v{i}" for i in range(len(input_cols))],
        [c.dtype for c in key_cols] + [c.dtype for c in input_cols])
    work = DeviceBatch(work_schema, key_cols + input_cols, batch.num_rows)
    return _grouped_reduce(work, list(range(len(key_cols))),
                           [(kind, len(key_cols) + idx, dt)
                            for kind, idx, dt in reductions],
                           out_schema, hash_table=hash_table)


def aggregate_passthrough(batch: DeviceBatch,
                          key_exprs: Sequence[Expression],
                          input_exprs: Sequence[Expression],
                          reductions: Sequence[Tuple[str, int, DType]],
                          out_schema: Schema) -> DeviceBatch:
    """Skipped partial aggregation: rows projected straight into the
    partial layout without grouping, every row its own group (count =
    valid ? 1 : 0, sum/min/max/first/last = the value). The runtime skip
    takes it when the partial pass barely reduces: on one device the
    exchange is a concat, and the final aggregate reduces once."""
    ctx = make_context(batch)
    key_cols = [batch.columns[e.index] if isinstance(e, BoundRef)
                else to_device_column(ctx, e.eval_device(ctx))
                for e in key_exprs]
    input_cols = [to_device_column(ctx, e.eval_device(ctx))
                  for e in input_exprs]
    out_cols: List[DeviceColumn] = list(key_cols)
    for kind, idx, out_dt in reductions:
        col = input_cols[idx]
        if kind == "count_valid":
            out_cols.append(DeviceColumn(
                out_dt, col.validity.to(torch_dtype(out_dt.np_dtype)),
                torch.ones_like(col.validity)))
        elif col.dtype.is_string:
            out_cols.append(col)
        else:  # sum/min/max/first/last(_valid): the value is the partial
            out_cols.append(DeviceColumn(
                out_dt, col.data.to(torch_dtype(out_dt.np_dtype)),
                col.validity))
    return DeviceBatch(out_schema, out_cols, batch.num_rows)


def aggregate_merge(batch: DeviceBatch, num_keys: int,
                    reductions: Sequence[Tuple[str, int, DType]],
                    out_schema: Schema, hash_table: int = None
                    ) -> DeviceBatch:
    """Merge partial outputs: group by the leading key columns, reduce the
    intermediate columns with merge kinds. reductions: (kind, col_idx, dt)."""
    return _grouped_reduce(batch, list(range(num_keys)), list(reductions),
                           out_schema, hash_table=hash_table)


def _dict_path_info(batch: DeviceBatch, key_idx: List[int]):
    """Every key column dictionary-encoded and the joint slot table small ->
    (cards, strides, T), else None."""
    from spark_rapids_tpu_torch.ops import densered
    if batch.capacity > densered.MAX_EXACT_CAPACITY:
        return None
    cards = []
    for ki in key_idx:
        col = batch.columns[ki]
        if col.dict_values is None:
            return None
        cards.append(col.dict_card + 1)  # +1: the NULL code
    T = 1
    for c in cards:
        T *= c
    if T > DICT_SLOT_MAX:
        return None
    strides = []
    acc = 1
    for c in reversed(cards):
        strides.append(acc)
        acc *= c
    return cards, list(reversed(strides)), T


def _grouped_reduce(batch: DeviceBatch, key_idx: List[int],
                    reductions: List[Tuple[str, int, DType]],
                    out_schema: Schema,
                    hash_table: int = None) -> DeviceBatch:
    if not key_idx:
        BRANCHES["single"] += 1
        return _single_group_reduce(batch, reductions, out_schema)
    if any(batch.columns[ci].dtype.is_string and kind != "count_valid"
           for kind, ci, _dt in reductions):
        BRANCHES["sorted_space"] += 1
        return _sorted_space_reduce(batch, key_idx, reductions, out_schema)
    dict_info = _dict_path_info(batch, key_idx)
    if dict_info is not None:
        BRANCHES["dict"] += 1
        return _dict_reduce(batch, key_idx, reductions, out_schema,
                            dict_info)
    if hash_table is not None:
        res = _hash_payload_reduce(batch, key_idx, reductions, out_schema,
                                   hash_table)
        if res is not None:
            BRANCHES["hash"] += 1
            return res
    if len(key_idx) <= 32 and not all(
            batch.columns[ki].dict_values is not None for ki in key_idx):
        BRANCHES["sorted_payload"] += 1
        return _sorted_payload_reduce(batch, key_idx, reductions,
                                      out_schema)
    BRANCHES["rowspace"] += 1
    return _rowspace_reduce(batch, key_idx, reductions, out_schema)


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def _hash_payload_reduce(batch: DeviceBatch, key_idx: List[int],
                         reductions: List[Tuple[str, int, DType]],
                         out_schema: Schema, max_slots: int):
    """One-pass hash aggregation over the open-addressing slot table
    (kernels.hash_grouped_aggregate): every row probes to its key's slot and
    folds its values into per-slot accumulators in the same pass. Null keys
    form real groups: the null image is a canonical sentinel and the
    per-key validity bits join the key images.

    Declines (None; the sorted branches take the batch) when a key is a
    char slab, which has no exact one-word image, or when the table would
    pass ``max_slots`` (``agg.hash.maxTableSlots``)."""
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.ops.rowops import gather_columns
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image

    capacity = batch.capacity
    if any(batch.columns[ki].has_slab for ki in key_idx):
        return None
    T = kernels.hash_table_size(capacity)
    if T > max_slots:
        return None
    dev = batch.device
    live = batch.row_mask()
    pos = _arange(capacity, dev)

    imgs: List[torch.Tensor] = []
    nullsig = torch.zeros(capacity, dtype=torch.int64, device=dev)
    for j, ki in enumerate(key_idx):
        col = batch.columns[ki]
        for im in u64_key_image(col, allow_dict=True):
            imgs.append(torch.where(col.validity, im, torch.zeros_like(im)))
        nullsig |= col.validity.to(torch.int64) << j
    imgs.append(nullsig)

    # lower every reduction kind onto the kernel's {sum,min,max} jobs
    jobs = []
    for kind, ci, out_dt in reductions:
        col = batch.columns[ci]
        valid = col.validity & live
        if kind == "count_valid":
            jobs.append(("sum", valid.to(torch.int64), live))
        elif kind == "sum":
            x = col.data.to(torch_dtype(out_dt.np_dtype))
            jobs.append(("sum", torch.where(valid, x, torch.zeros_like(x)),
                         valid))
        elif kind in ("min", "max"):
            v2, _neutral = gb.minmax_operands(col.data, kind)
            # the kernel accumulates int32/int64/float64; narrower types
            # widen (order-preserving, the result casts back below)
            if v2.dtype in (torch.int8, torch.int16):
                v2 = v2.to(torch.int32)
            elif v2.dtype == torch.float32:
                v2 = v2.to(torch.float64)
            jobs.append((kind, v2, valid))
        elif kind in ("first", "last", "first_valid", "last_valid"):
            eligible = valid if kind.endswith("_valid") else live
            jobs.append(("min" if kind.startswith("first") else "max",
                         pos, eligible))
        elif kind == "any":
            jobs.append(("max", (col.data & valid).to(torch.int32), live))
        else:
            raise ValueError(f"unknown reduction kind: {kind}")

    counts, rep, accs, nels = kernels.hash_grouped_aggregate(imgs, live,
                                                             jobs, T)

    # compact used slots to the front; n_used <= live rows <= capacity and
    # T >= 2*capacity, so the first ``capacity`` compacted entries hold
    # every used slot and the output keeps the input capacity
    slot_perm, n_used = kernels.compact_permutation(counts > 0)
    sel = slot_perm[:capacity].long()
    group_live = pos < n_used
    rep_row = rep.clamp(0, capacity - 1)[sel]
    out_cols = gather_columns([batch.columns[ki] for ki in key_idx],
                              rep_row, group_live)

    for (kind, ci, out_dt), acc, nel in zip(reductions, accs, nels):
        a, ne = acc[sel], nel[sel]
        has = ne > 0
        tdt = torch_dtype(out_dt.np_dtype)
        if kind == "count_valid":
            data = torch.where(has, a, torch.zeros_like(a)).to(tdt)
            validity = group_live
        elif kind == "sum":
            data = torch.where(has, a, torch.zeros_like(a)).to(tdt)
            validity = has & group_live
        elif kind in ("min", "max"):
            data = torch.where(has, a, torch.zeros_like(a))
            if tdt == torch.bool:
                data = data != 0
            data = data.to(tdt)
            validity = has & group_live
        elif kind in ("first", "last", "first_valid", "last_valid"):
            rowsel = a.clamp(0, capacity - 1).long()
            src = batch.columns[ci]
            data = src.data[rowsel].to(tdt)
            validity = has & src.validity[rowsel] & group_live
        else:  # any
            data = (torch.where(has, a, torch.zeros_like(a)) > 0).to(tdt)
            validity = group_live
        out_cols.append(DeviceColumn(out_dt, data, validity))
    return DeviceBatch(out_schema, out_cols, n_used.to(torch.int32))


def _dict_reduce(batch: DeviceBatch, key_idx: List[int],
                 reductions: List[Tuple[str, int, DType]],
                 out_schema: Schema, dict_info) -> DeviceBatch:
    """Direct-addressed aggregation over dictionary codes: the slot id is
    arithmetic on the host-computed codes (exact by construction), every
    count and sum runs through ops/densered.py, and the key output columns
    are host constants decoded from the static dictionary. Output capacity
    shrinks to the slot-table bucket."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.ops import densered
    from spark_rapids_tpu_torch.ops.kernels import compact_permutation
    from spark_rapids_tpu_torch.ops.rowops import gather_column
    from spark_rapids_tpu_torch.utils.kernelcache import bucket_dim

    cards, strides, T = dict_info
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_mask()
    slot = torch.zeros(capacity, dtype=torch.int64, device=dev)
    for ki, stride in zip(key_idx, strides):
        slot += batch.columns[ki].dict_codes.to(torch.int64) * stride
    slot = torch.where(live, slot, torch.full_like(slot, T))

    dense_jobs = []
    dense_pos = {}  # reduction index -> dense job index
    for ri, (kind, ci, out_dt) in enumerate(reductions):
        col = batch.columns[ci]
        if kind in densered.DENSE_KINDS and (
                kind == "count_valid"
                or not col.dtype.is_string
                and densered.dense_supported(kind, col.data.dtype)):
            dense_pos[ri] = len(dense_jobs)
            dense_jobs.append((kind, col.validity if kind == "count_valid"
                               else col.data, col.validity,
                               torch_dtype(out_dt.np_dtype)))
    dense_res, row_count = densered.slot_reduce_dense(slot, live, T,
                                                      dense_jobs)
    slot_perm, n_used = compact_permutation(row_count > 0)
    out_cap = bucket_dim(bucket_capacity(T))
    pad_n = out_cap - T
    perm_pad = torch.cat([slot_perm, torch.zeros(pad_n, dtype=torch.int32,
                                                 device=dev)])
    group_live = _arange(out_cap, dev) < n_used

    def place(data_t, valid_t):
        """(T,) slot-space result -> (out_cap,) compacted group rows."""
        data_t = torch.cat([data_t, torch.zeros(pad_n, dtype=data_t.dtype,
                                                device=dev)])
        valid_t = torch.cat([valid_t, torch.zeros(pad_n, dtype=torch.bool,
                                                  device=dev)])
        idx = perm_pad.long()
        return data_t[idx], valid_t[idx] & group_live

    out_cols: List[DeviceColumn] = []
    # key columns: decoded from the static dictionary on the host; only the
    # T-row compaction gather runs on the device
    for ki, stride, card1 in zip(key_idx, strides, cards):
        col = batch.columns[ki]
        card = card1 - 1
        code_of_slot = (np.arange(out_cap) // stride) % card1
        code_of_slot[T:] = card
        validity = host_to_device(code_of_slot < card, dev)
        data = None
        if not col.dtype.is_string:
            fill = col.dict_values[0]
            vals = np.array([col.dict_values[c] if c < card else fill
                             for c in code_of_slot],
                            dtype=col.dtype.np_dtype)
            data = host_to_device(vals, dev)
        const_col = DeviceColumn(
            col.dtype, data, validity,
            host_to_device(code_of_slot.astype(np.int32), dev),
            col.dict_values)
        out_cols.append(gather_column(const_col, perm_pad, group_live))

    pos = _arange(capacity, dev)
    for ri, (kind, ci, out_dt) in enumerate(reductions):
        if ri in dense_pos:
            data_t, valid_t = dense_res[dense_pos[ri]]
        else:
            # tail kinds (min/max/first/last/any, bool sums): T-width
            # segment ops, one indexed pass each
            col = batch.columns[ci]
            data_t, valid_t = _seg_reduce_kind(
                kind, col.data, col.validity & live, live,
                _seg_by(slot, T), pos, _same, capacity, T, out_dt)
        d, v = place(data_t, valid_t)
        out_cols.append(DeviceColumn(out_dt, d, v))
    return DeviceBatch(out_schema, out_cols, n_used.to(torch.int32))


def _seg_by(seg_id: torch.Tensor, width: int, slot_perm=None):
    """The segment closure ``seg(op, x) -> (width,)`` over ``seg_id`` in
    [0, width]; id ``width`` marks rows outside every segment, which park
    past the end (``groupby.park_ids``). ``slot_perm``: an optional
    compaction of the width slots."""
    sid = gb.park_ids(seg_id, seg_id < width, width)

    def seg(op: str, x: torch.Tensor) -> torch.Tensor:
        r = segment_op(op, x, sid, width + gb.PARK_SLOTS)[:width]
        return r if slot_perm is None else r[slot_perm.long()]
    return seg


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _seg_reduce_kind(kind: str, vs, valid, live, seg, order_vec, to_row,
                     capacity: int, width: int, out_dt: DType):
    """One non-string reduction kind over a segment closure: the single
    definition of per-kind null/tie semantics, shared by the row-space,
    sorted-payload and dictionary branches, as in the JAX package.
    ``valid`` must already be masked to live rows; ``seg(op, x)`` reduces
    (capacity,) -> (width,); ``order_vec``/``to_row`` define the first/last
    order and map a selected order value back to a row of ``vs``. Returns
    (data (width,), validity (width,))."""
    tdt = torch_dtype(out_dt.np_dtype)
    dev = vs.device
    has_valid = seg("amax", valid.to(torch.int32)) > 0
    if kind == "count_valid":
        data = seg("sum", valid.to(torch.int64))
        return data.to(tdt), torch.ones(width, dtype=torch.bool, device=dev)
    if kind == "sum":
        x = torch.where(valid, vs.to(tdt), torch.zeros((), dtype=tdt,
                                                        device=dev))
        return seg("sum", x), has_valid
    if kind in ("min", "max"):
        v2, neutral = gb.minmax_operands(vs, kind)
        x = torch.where(valid, v2, torch.full_like(v2, neutral))
        data = seg("amin" if kind == "min" else "amax", x)
        if tdt == torch.bool:
            data = data != 0
        return data.to(tdt), has_valid
    if kind in ("first", "last", "first_valid", "last_valid"):
        eligible = valid if kind.endswith("_valid") else live
        if kind.startswith("first"):
            sel = seg("amin", torch.where(eligible, order_vec, capacity + 1))
        else:
            sel = seg("amax", torch.where(eligible, order_vec, -1))
        picked = (sel >= 0) & (sel < capacity)
        rowsel = to_row(sel.clamp(0, capacity - 1)).long()
        return vs[rowsel].to(tdt), picked & valid[rowsel]
    if kind == "any":
        data = seg("amax", (vs & valid).to(torch.int32)) > 0
        return data.to(tdt), torch.ones(width, dtype=torch.bool, device=dev)
    raise ValueError(f"unknown reduction kind: {kind}")


def _single_group_reduce(batch: DeviceBatch,
                         reductions: List[Tuple[str, int, DType]],
                         out_schema: Schema) -> DeviceBatch:
    """Global aggregate: plain masked reductions (SQL: the global aggregate
    of empty input is one row). The output batch has MIN_CAPACITY."""
    from spark_rapids_tpu_torch.columnar.batch import MIN_CAPACITY
    capacity = batch.capacity
    dev = batch.device
    out_cap = MIN_CAPACITY
    live = batch.row_mask()
    pos = _arange(capacity, dev)
    out_cols: List[DeviceColumn] = []
    true = torch.ones((), dtype=torch.bool, device=dev)

    def place(scalar, valid_scalar, out_dt):
        tdt = torch_dtype(out_dt.np_dtype)
        data = torch.zeros(out_cap, dtype=tdt, device=dev)
        data[0] = scalar.to(tdt)
        validity = torch.zeros(out_cap, dtype=torch.bool, device=dev)
        validity[0] = valid_scalar
        return DeviceColumn(out_dt, data, validity)

    for kind, col_idx, out_dt in reductions:
        col = batch.columns[col_idx]
        valid = col.validity & live
        if col.dtype.is_string:
            if kind == "count_valid":
                out_cols.append(place(valid.sum(dtype=torch.int64), true,
                                      out_dt))
                continue
            # string min/max/first/last over one group: the select
            # machinery over a trivial GroupInfo picks the winning row
            from spark_rapids_tpu_torch.ops.rowops import gather_column
            rows, has = gb.segment_select_string(
                kind, col, _trivial_group_info(batch, live))
            slot0 = _arange(out_cap, dev) == 0
            out_cols.append(gather_column(col, rows[:out_cap],
                                          has[:out_cap] & slot0))
            continue
        vs = col.data
        any_valid = valid.any()
        if kind == "count_valid":
            out_cols.append(place(valid.sum(dtype=torch.int64), true,
                                  out_dt))
        elif kind == "sum":
            x = vs.to(torch_dtype(out_dt.np_dtype))
            x = torch.where(valid, x, torch.zeros_like(x))
            out_cols.append(place(x.sum(), any_valid, out_dt))
        elif kind in ("min", "max"):
            v2, neutral = gb.minmax_operands(vs, kind)
            x = torch.where(valid, v2, torch.full_like(v2, neutral))
            red = x.min() if kind == "min" else x.max()
            out_cols.append(place(red, any_valid, out_dt))
        elif kind in ("first", "last", "first_valid", "last_valid"):
            eligible = valid if kind.endswith("_valid") else live
            if kind.startswith("first"):
                sel = torch.where(eligible, pos, capacity + 1).min()
            else:
                sel = torch.where(eligible, pos, -1).max()
            picked = (sel >= 0) & (sel < capacity)
            sel_c = sel.clamp(0, capacity - 1).long()
            out_cols.append(place(vs[sel_c], picked & valid[sel_c], out_dt))
        elif kind == "any":
            out_cols.append(place((vs & valid).any(), true, out_dt))
        else:
            raise ValueError(f"unknown reduction kind: {kind}")
    return DeviceBatch(out_schema, out_cols,
                       torch.ones((), dtype=torch.int32, device=dev))


def _key_images(col: DeviceColumn) -> List[torch.Tensor]:
    """A key column's exact equality images: a dictionary column's code
    (exact within a batch), a char slab's 8-byte prefix, length and two
    polynomial hashes (the JAX package's images for its plain strings), a
    fixed-width column's value image."""
    from spark_rapids_tpu_torch.ops import hashing
    from spark_rapids_tpu_torch.ops.sortops import (
        string_prefix8, u64_key_image,
    )
    if col.dtype.is_string and col.dict_values is not None:
        return [col.dict_codes.to(torch.int64)]
    if col.dtype.is_string:
        h1, h2 = hashing.string_poly_hashes_col(col)
        return [string_prefix8(col), col.lens.to(torch.int64), h1, h2]
    return u64_key_image(col)


def _sorted_payload_reduce(batch: DeviceBatch, key_idx: List[int],
                           reductions: List[Tuple[str, int, DType]],
                           out_schema: Schema) -> DeviceBatch:
    """High-cardinality keyed aggregation in sorted space:

      1. ``group_rows`` sorts the rows by (dead, h1, h2);
      2. every reduction input and the exact key images move to sorted
         space (``packed_gather_vectors``);
      3. group boundaries are the hash boundaries refined by adjacent-image
         comparison, so two keys merge only when every exact image and the
         validity signature agree (a refinement can only split a hash
         collision, never merge distinct keys);
      4. every reduction is a segment op over the sorted group ids; B1
         compacts the boundaries into each group's first row, from which
         the keys are gathered.

    No host sync: the group count stays on the device."""
    from spark_rapids_tpu_torch.ops.kernels import compact_permutation
    from spark_rapids_tpu_torch.ops.rowops import (
        gather_columns, packed_gather_vectors,
    )
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_mask()
    pos = _arange(capacity, dev)
    info = gb.group_rows(batch, key_idx, compute_rep=False, live=live)
    perm = info.perm

    # exact key images + per-key validity signature; null rows get the
    # canonical image 0 and real values sharing it differ by the signature
    imgs: List[torch.Tensor] = []
    nullsig = torch.zeros(capacity, dtype=torch.int64, device=dev)
    for j, ki in enumerate(key_idx):
        col = batch.columns[ki]
        imgs.extend(torch.where(col.validity, im, torch.zeros_like(im))
                    for im in _key_images(col))
        nullsig |= col.validity.to(torch.int64) << j

    payload_pos: dict = {}
    vectors: List[torch.Tensor] = list(imgs) + [nullsig]
    for _kind, ci, _dt in reductions:
        if ci not in payload_pos:
            payload_pos[ci] = len(vectors)
            col = batch.columns[ci]
            # only count_valid consumes a string input here (string
            # min/max take the sorted-space branch): validity stands in
            vectors.extend([col.validity if col.dtype.is_string
                            else col.data, col.validity])
    gathered = packed_gather_vectors(vectors, perm)

    dead_slot = _sorted_dead_mask(info, live)
    differs = torch.zeros(capacity, dtype=torch.bool, device=dev)
    for v in gathered[:len(imgs) + 1]:
        differs[1:] |= v[1:] != v[:-1]
    boundary = (info.boundary | differs) & ~dead_slot
    gid = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    sid = torch.where(dead_slot, capacity, gid.clamp(0, capacity - 1))
    num_groups = boundary.sum(dtype=torch.int32)
    group_live = pos < num_groups
    seg = _seg_by(sid, capacity)

    # key output columns: one gather at the groups' first rows
    slot_perm, _n = compact_permutation(boundary)
    rep_row = perm[slot_perm.long()]
    out_cols = gather_columns([batch.columns[ki] for ki in key_idx],
                              rep_row, group_live)

    live_slot = ~dead_slot
    for kind, ci, out_dt in reductions:
        pi = payload_pos[ci]
        data_s, valid_s = gathered[pi], gathered[pi + 1]
        if batch.columns[ci].dtype.is_string:
            kind, data_s = "count_valid", valid_s
        data, validity = _seg_reduce_kind(
            kind, data_s, valid_s & live_slot, live_slot, seg, pos, _same,
            capacity, capacity, out_dt)
        out_cols.append(DeviceColumn(out_dt, data, validity & group_live))
    return DeviceBatch(out_schema, out_cols, num_groups)


def _sorted_dead_mask(info: "gb.GroupInfo", live) -> torch.Tensor:
    """bool per sorted slot: the slot holds a dead (padding or filtered)
    row. ``group_rows`` sorts dead rows last, so this is one comparison
    against the live count."""
    capacity = info.perm.shape[0]
    return _arange(capacity, live.device) >= live.sum(dtype=torch.int32)


def _trivial_group_info(batch: DeviceBatch, live) -> "gb.GroupInfo":
    """One group of every live row, for the global string reductions."""
    from spark_rapids_tpu_torch.ops.sortops import lexsort_permutation
    capacity = batch.capacity
    dev = batch.device
    perm = lexsort_permutation([(~live).to(torch.int64)])
    live_s = live[perm.long()]
    boundary = torch.zeros(capacity, dtype=torch.bool, device=dev)
    boundary[0] = live_s[0]
    # dead rows are parked outside group 0, as group_rows does: they may be
    # valid rows excluded by a mask, and must not compete
    gid = torch.where(live_s, 0, capacity - 1).to(torch.int32)
    return gb.GroupInfo(perm, gid, boundary,
                        torch.ones((), dtype=torch.int32, device=dev),
                        torch.zeros(capacity, dtype=torch.int32, device=dev),
                        live_s)


def _sorted_space_reduce(batch: DeviceBatch, key_idx: List[int],
                         reductions: List[Tuple[str, int, DType]],
                         out_schema: Schema) -> DeviceBatch:
    """The sorted-space branch: string reductions need the ordered slots
    of ``segment_select_string``."""
    from spark_rapids_tpu_torch.ops.rowops import gather_column
    capacity = batch.capacity
    info = gb.group_rows(batch, key_idx)
    out_cols: List[DeviceColumn] = gb.gather_keys(batch, key_idx, info)
    group_live = _arange(capacity, batch.device) < info.num_groups
    for kind, ci, out_dt in reductions:
        col = batch.columns[ci]
        if col.dtype.is_string and kind != "count_valid":
            rows, has = gb.segment_select_string(kind, col, info)
            out_cols.append(gather_column(col, rows, has & group_live))
            continue
        data = col.validity if col.dtype.is_string else col.data
        data, validity = gb.segment_reduce(kind, data, col.validity, info,
                                           out_dt.np_dtype)
        out_cols.append(DeviceColumn(out_dt, data, validity & group_live))
    return DeviceBatch(out_schema, out_cols, info.num_groups)


def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned remainder of int64 bit patterns by 0 < m < 2^62."""
    if m & (m - 1) == 0:
        return x & (m - 1)
    from spark_rapids_tpu_torch.ops.hashing import srl
    return ((srl(x, 1) % m) * 2 + (x & 1)) % m


_NULL_IMAGE = -7046029254386353131  # the uint64 0x9E3779B97F4A7C15
_ROW_SEED = 0x243F6A8885A308D3


def _slot_hash_attempt(batch: DeviceBatch, key_idx: List[int], live):
    """Sort-free group assignment attempt: each row's exact key images map
    to a slot (mixed image mod SLOT_TABLE), and every used slot must agree
    on each image and each key's validity. Returns (fast_ok 0-d bool, slot
    per row (dead -> T), used mask, n_used).

    Fixed-width images carry the whole value; a slab string's carry its
    first 8 bytes and length and are trusted only when every live string
    has at most 8 bytes. A slot shared by two key tuples fails the check
    and the caller sorts: collisions and batches of more than SLOT_TABLE
    groups degrade, never corrupt."""
    from spark_rapids_tpu_torch.ops.hashing import splitmix64
    from spark_rapids_tpu_torch.ops.sortops import (
        _SIGN, string_prefix8, u64_key_image,
    )
    capacity = batch.capacity
    dev = batch.device
    T = min(SLOT_TABLE, capacity)
    key_images = []
    ok_short = torch.ones((), dtype=torch.bool, device=dev)
    for ki in key_idx:
        col = batch.columns[ki]
        if col.dtype.is_string and col.dict_values is not None:
            per_key = [col.dict_codes.to(torch.int64)]
        elif col.dtype.is_string:
            per_key = [string_prefix8(col), col.lens.to(torch.int64)]
            ok_short = ok_short & (torch.where(live, col.lens, 0) <= 8).all()
        else:
            per_key = [u64_key_image(col)[0]]
        # null keys get their own image band; a real value sharing it is
        # told apart by the validity agreement below
        key_images.append((ki, [torch.where(col.validity, im,
                                            torch.full_like(im, _NULL_IMAGE))
                                for im in per_key]))
    rid = None
    for _ki, per_key in key_images:
        for img in per_key:
            rid = splitmix64((torch.full_like(img, _ROW_SEED) if rid is None
                              else rid) ^ img)
    slot = torch.where(live, _umod(rid, T), T)
    seg = _seg_by(slot, T)
    used = seg("sum", torch.ones(capacity, dtype=torch.int32,
                                 device=dev)) > 0
    collide = torch.zeros((), dtype=torch.bool, device=dev)
    big = torch.iinfo(torch.int64)
    for ki, per_key in key_images:
        for img in per_key:
            u = img ^ _SIGN  # unsigned order as signed
            smin = seg("amin", torch.where(live, u, big.max))
            smax = seg("amax", torch.where(live, u, big.min))
            collide = collide | (used & (smin != smax)).any()
        v = batch.columns[ki].validity.to(torch.int32)
        vmin = seg("amin", torch.where(live, v, 2))
        vmax = seg("amax", torch.where(live, v, -1))
        collide = collide | (used & (vmin != vmax)).any()
    return ok_short & ~collide, slot, used, used.sum(dtype=torch.int32)


def _rowspace_reduce(batch: DeviceBatch, key_idx: List[int],
                     reductions: List[Tuple[str, int, DType]],
                     out_schema: Schema) -> DeviceBatch:
    """Keyed aggregation without per-column permutation gathers: each row
    gets its group's segment id in row space, and every reduction runs on
    the unpermuted columns. When every key is dictionary-encoded the
    sort-free slot attempt goes first (one counted sync reads its
    verdict); otherwise, or when it fails, ``group_rows``' hash sort
    assigns the groups. Outputs keep the input capacity."""
    from spark_rapids_tpu_torch.ops.kernels import compact_permutation
    from spark_rapids_tpu_torch.ops.rowops import gather_column
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_mask()
    pos = _arange(capacity, dev)

    def pad(x):
        if x.shape[0] == capacity:
            return x
        return torch.cat([x, torch.zeros(capacity - x.shape[0],
                                         dtype=x.dtype, device=dev)])

    def reduce_core(width: int, seg, order_vec, to_row, num_groups):
        group_live = _arange(width, dev) < num_groups
        rep_slot = seg("amin", torch.where(live, order_vec, capacity + 1))
        rep_row = to_row(rep_slot.clamp(0, capacity - 1))
        outs: List[DeviceColumn] = []
        for ki in key_idx:
            kcol = gather_column(batch.columns[ki], pad(rep_row),
                                 pad(group_live))
            outs.append(kcol)
        for kind, ci, out_dt in reductions:
            col = batch.columns[ci]
            if col.dtype.is_string:  # only count_valid reaches here
                kind = "count_valid"
            data, validity = _seg_reduce_kind(
                kind, col.validity if col.dtype.is_string else col.data,
                col.validity & live, live, seg, order_vec, to_row, capacity,
                width, out_dt)
            outs.append(DeviceColumn(out_dt, pad(data),
                                     pad(validity & group_live)))
        return DeviceBatch(out_schema, outs, num_groups)

    if all(batch.columns[ki].dict_values is not None for ki in key_idx):
        fast_ok, slot, used, n_used = _slot_hash_attempt(batch, key_idx,
                                                         live)
        with sync_scope("agg.slotAttempt", nbytes=1):
            take_slots = bool(fast_ok.item())
        if take_slots:
            BRANCHES["rowspace_slot"] += 1
            width = min(SLOT_TABLE, capacity)
            slot_perm, _cnt = compact_permutation(used)
            return reduce_core(width, _seg_by(slot, width, slot_perm), pos,
                               _same, n_used)
    BRANCHES["rowspace_sort"] += 1
    info = gb.group_rows(batch, key_idx, compute_rep=False, live=live)
    # one scatter each carries a row's group id and sorted position back
    # to row space (the permutation is a bijection)
    idx = info.perm.long()
    gid_row = torch.empty_like(pos).scatter_(0, idx, info.group_id_sorted)
    inv_pos = torch.empty_like(pos).scatter_(0, idx, pos)
    sid = torch.where(live, gid_row.clamp(0, capacity - 1), capacity)
    return reduce_core(
        capacity, _seg_by(sid, capacity), inv_pos,
        lambda x: info.perm[x.clamp(0, capacity - 1).long()],
        info.num_groups)
