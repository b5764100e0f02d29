"""Grouped aggregation of device batches: the update (partial) and merge
steps (counterpart of the JAX package's ``ops/aggregate.py``).

``_grouped_reduce`` picks the branch exactly as the JAX package does; the
port has three of them (and ``aggregate_passthrough``, the skipped partial
pass):

  * ``_single_group_reduce``: no keys (a global aggregate; TPC-H Q6);
  * ``_dict_reduce``: every key dictionary-encoded and the joint slot table
    small: the slot is arithmetic on the codes and the counts and sums run
    through ops/densered.py (the JAX package's ``_dict_matmul_reduce``;
    TPC-H Q1);
  * ``_hash_payload_reduce``: the one-pass hash aggregation on kernel B2,
    taken when the caller passes ``hash_table`` (TPC-H Q18's group-by).

The sorted-space, sorted-payload, row-space and dense-key branches raise
NotImplementedError naming the branch; they wait for a later slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, host_to_device
from spark_rapids_tpu_torch.columnar.dtype import DType, torch_dtype
from spark_rapids_tpu_torch.ops import groupby as gb
from spark_rapids_tpu_torch.sql.exprs.core import BoundRef, Expression
from spark_rapids_tpu_torch.sql.exprs.evalbridge import (
    make_context, to_device_column,
)

# cap on the direct dictionary slot table (product of per-key
# cardinalities + 1 each), as in the JAX package
DICT_SLOT_MAX = 4096


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
        return _single_group_reduce(batch, reductions, out_schema)
    if any(batch.columns[ci].dtype.is_string and kind != "count_valid"
           for kind, ci, _dt in reductions):
        raise NotImplementedError(
            "aggregate branch _sorted_space_reduce (string reductions) is "
            "not ported yet")
    dict_info = _dict_path_info(batch, key_idx)
    if dict_info is not None:
        return _dict_reduce(batch, key_idx, reductions, out_schema,
                            dict_info)
    if hash_table is not None:
        from spark_rapids_tpu_torch.ops.kernels import hash_table_size
        T = hash_table_size(batch.capacity)
        if T > hash_table:
            raise NotImplementedError(
                f"a {batch.capacity}-row batch needs {T} hash slots, more "
                f"than spark.rapids.sql.agg.hash.maxTableSlots={hash_table}"
                ": the out-of-core split (exec/outofcore.split_batch_by_hash)"
                " is not ported yet")
        return _hash_payload_reduce(batch, key_idx, reductions, out_schema)
    raise NotImplementedError(
        "aggregate branches _sorted_payload_reduce/_rowspace_reduce "
        "(keys that are not all dictionary-encoded, without a hash table) "
        "are not ported yet")


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def _hash_payload_reduce(batch: DeviceBatch, key_idx: List[int],
                         reductions: List[Tuple[str, int, DType]],
                         out_schema: Schema) -> DeviceBatch:
    """One-pass hash aggregation over the open-addressing slot table
    (kernels.hash_grouped_aggregate): every row probes to its key's slot and
    folds its values into per-slot accumulators in the same pass. Null keys
    form real groups: the null image is a canonical sentinel and the
    per-key validity bits join the key images."""
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.ops.rowops import gather_columns
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image

    capacity = batch.capacity
    dev = batch.device
    T = kernels.hash_table_size(capacity)
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
                kind, col.data, col.validity & live, live, slot, pos,
                capacity, T, out_dt)
        d, v = place(data_t, valid_t)
        out_cols.append(DeviceColumn(out_dt, d, v))
    return DeviceBatch(out_schema, out_cols, n_used.to(torch.int32))


def _seg(op: str, x: torch.Tensor, seg_id: torch.Tensor, width: int,
         init) -> torch.Tensor:
    """(width,) segment reduction of ``x`` by ``seg_id`` in [0, width];
    id ``width`` parks rows outside every segment."""
    out = torch.full((width + 1,), init, dtype=x.dtype, device=x.device)
    if op == "sum":
        out.index_add_(0, seg_id, x)
    else:
        out.scatter_reduce_(0, seg_id, x, op)
    return out[:width]


def _seg_reduce_kind(kind: str, vs, valid, live, seg_id, order_vec,
                     capacity: int, width: int, out_dt: DType):
    """One non-string reduction kind over segments — the JAX package's
    single definition of per-kind null/tie semantics. ``valid`` must already
    be masked to live rows. Returns (data (width,), validity (width,))."""
    tdt = torch_dtype(out_dt.np_dtype)
    has_valid = _seg("amax", valid.to(torch.int32), seg_id, width, 0) > 0
    if kind == "count_valid":
        data = _seg("sum", valid.to(torch.int64), seg_id, width, 0)
        return data.to(tdt), torch.ones(width, dtype=torch.bool,
                                        device=vs.device)
    if kind == "sum":
        x = vs.to(tdt)
        x = torch.where(valid, x, torch.zeros_like(x))
        return _seg("sum", x, seg_id, width, 0), has_valid
    if kind in ("min", "max"):
        v2, neutral = gb.minmax_operands(vs, kind)
        x = torch.where(valid, v2, torch.full_like(v2, neutral))
        data = _seg("amin" if kind == "min" else "amax", x, seg_id, width,
                    neutral)
        if tdt == torch.bool:
            data = data != 0
        return data.to(tdt), has_valid
    if kind in ("first", "last", "first_valid", "last_valid"):
        eligible = valid if kind.endswith("_valid") else live
        big = capacity + 1
        if kind.startswith("first"):
            sel = _seg("amin", torch.where(eligible, order_vec,
                                           torch.full_like(order_vec, big)),
                       seg_id, width, big)
        else:
            sel = _seg("amax", torch.where(eligible, order_vec,
                                           torch.full_like(order_vec, -1)),
                       seg_id, width, -1)
        picked = (sel >= 0) & (sel < capacity)
        rowsel = sel.clamp(0, capacity - 1).long()
        return vs[rowsel].to(tdt), picked & valid[rowsel]
    if kind == "any":
        data = _seg("amax", (vs & valid).to(torch.int32), seg_id, width,
                    0) > 0
        return data.to(tdt), torch.ones(width, dtype=torch.bool,
                                        device=vs.device)
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
            raise NotImplementedError(
                f"global {kind} over strings is not ported yet")
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
