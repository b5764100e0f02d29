"""The window stage's device math (counterpart of the JAX package's
``ops/windowops.py``; reference: cuDF groupBy().aggregateWindows called
from GpuWindowExpression.scala:139,198).

The JAX package fuses the stage into one XLA program; here it is eager
torch code over one batch, with no host sync:

  1. one stable lexsort by (partition keys, order keys), dead rows last
     (``sortops.sort_permutation``);
  2. partition and peer boundaries from an exact compare of adjacent rows'
     key images (``sortops.u64_key_image``: a dictionary's codes, every
     word and the length of a slab, a number's order image). The JAX
     package compares 128-bit row hashes; the exact images give the same
     boundaries with no hash;
  3. segment ids as a prefix sum of the boundaries (nondecreasing, dead
     rows after every live one), then each row's segment start and end as
     a binary search of its own id in them (``torch.searchsorted``), where
     the JAX package takes segment_min/segment_max over segment ids (on the
     card a scatter whose dead rows would all land on one address). A
     running maximum of boundary positions (``torch.cummax``) gives the
     same starts, but PyTorch's CUDA scan with indices took 24 ms a call
     over 2^23 rows on an H100, 73 of a row_number case's 91 ms
     (``tools/profile_queries.py``, the window cells); with the search the
     case takes 17 ms;
  4. every function is then vector math over the sorted rows: positions
     for the ranking functions, a shifted same-segment gather for
     lead/lag, two clamped gathers into an exclusive prefix sum for
     sum/count/avg frames, a log-step doubling scan with same-segment
     masks for cumulative min/max (the JAX package's
     ``lax.associative_scan``), unrolled shifted compares for narrow ROW
     frames and a sparse table for wide and bounded RANGE frames, and a
     ⌈log2 n⌉-step vector binary search for bounded RANGE extents.

The output batch is the sorted child columns plus one result column per
window function. A string min/max over a whole partition picks each
partition's winning row (``groupby.segment_select_string``) and gathers it
at the slab's fixed stride, so it needs none of the JAX package's host
read of the char totals.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtype import torch_dtype
from spark_rapids_tpu_torch.ops import sortops
from spark_rapids_tpu_torch.ops.rowops import gather_batch, gather_column
from spark_rapids_tpu_torch.sql.window import (
    CURRENT_ROW, UNBOUNDED_FOLLOWING, UNBOUNDED_PRECEDING,
)

# one window function descriptor (static):
#   ("row_number",) | ("rank",) | ("dense_rank",)
#   ("leadlag", value_idx, offset, out_dtype_name, default)  offset<0 = lag
#   ("agg", kind, value_idx, frame_kind, lo, hi, out_dtype_name)
#     kind in sum|count|min|max|avg; frame_kind rows|range

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _exclusive_prefix(x: torch.Tensor) -> torch.Tensor:
    """P with P[i] = sum of x[:i]; length n + 1."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0)])


def _pick(kind: str):
    return torch.minimum if kind == "min" else torch.maximum


def _shift_down(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """y[i] = x[i - d] (fill where i < d)."""
    if d >= x.shape[0]:
        return torch.full_like(x, fill)
    return torch.cat([torch.full((d,), fill, dtype=x.dtype,
                                 device=x.device), x[:-d]])


def segmented_scan_minmax(vals: torch.Tensor, seg_start: torch.Tensor,
                          kind: str, neutral) -> torch.Tensor:
    """Inclusive segmented running min/max: out[i] reduces vals[seg_start[i]
    .. i]. Log-step doubling (Hillis-Steele) with same-segment masks,
    ⌈log2 n⌉ passes of a shift and a compare."""
    n = vals.shape[0]
    pos = torch.arange(n, device=vals.device)
    pick = _pick(kind)
    out = vals
    d = 1
    while d < n:
        prev = _shift_down(out, d, neutral)
        out = torch.where(pos - d >= seg_start, pick(out, prev), out)
        d <<= 1
    return out


def _sparse_minmax(pre: torch.Tensor, f_lo_c: torch.Tensor,
                   f_hi_c: torch.Tensor, kind: str, neutral) -> torch.Tensor:
    """min/max over per-row index ranges [f_lo_c, f_hi_c] with a sparse
    table (log n levels of doubling windows): a query combines two
    overlapping power-of-two windows. Empty ranges must be masked by the
    caller."""
    n = pre.shape[0]
    pick = _pick(kind)
    levels = [pre]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        h = 1 << (k - 1)
        shifted = torch.cat([prev[h:], torch.full((h,), neutral,
                                                  dtype=prev.dtype,
                                                  device=prev.device)])
        levels.append(pick(prev, shifted))
        k += 1
    table = torch.stack(levels).reshape(-1)
    length = (f_hi_c - f_lo_c + 1).clamp(min=1)
    # floor(log2(length)) exactly: the count of powers of two <= length
    kq = torch.zeros_like(length)
    for j in range(1, len(levels)):
        kq += (length >= (1 << j)).to(kq.dtype)
    pow2 = torch.ones_like(length) << kq
    a = table[kq * n + f_lo_c]
    b = table[kq * n + (f_hi_c - pow2 + 1).clamp(min=0)]
    return pick(a, b)


def _range_frame_search(seg: torch.Tensor, vflag: torch.Tensor,
                        ov: torch.Tensor, tv: torch.Tensor,
                        tx: torch.Tensor, strict: bool) -> torch.Tensor:
    """Vector binary search: per row, the first sorted position whose key
    (seg, valid flag, order value) is >= (> when ``strict``) the row's
    target (its own seg, ``tv``, ``tx``). The sorted layout (partitions
    ascending, nulls first, order values ascending; dead rows last with
    the largest seg) makes the key nondecreasing. ⌈log2 (n + 1)⌉ + 1
    fixed steps, as the JAX package's fori_loop."""
    n = seg.shape[0]
    steps = max(1, (n + 1 - 1).bit_length() + 1)
    lo = torch.zeros(n, dtype=torch.int64, device=seg.device)
    hi = torch.full((n,), n, dtype=torch.int64, device=seg.device)
    for _ in range(steps):
        mid = (lo + hi) // 2
        mc = mid.clamp(0, n - 1)
        s_m, v_m, o_m = seg[mc], vflag[mc], ov[mc]
        same = (s_m == seg) & (v_m == tv)
        gt = (s_m > seg) | ((s_m == seg) & (v_m > tv)) | (same & (o_m > tx))
        pred = gt if strict else gt | (same & (o_m == tx))
        hi = torch.where(pred, mid, hi)
        lo = torch.where(pred, lo, mid + 1)
    return lo


def _neutral(v: torch.Tensor, kind: str):
    if v.dtype.is_floating_point:
        return v, (float("inf") if kind == "min" else float("-inf"))
    if v.dtype == torch.bool:
        return v.to(torch.int32), (1 if kind == "min" else 0)
    info = torch.iinfo(v.dtype)
    return v, (info.max if kind == "min" else info.min)


def _key_boundaries(cols: Sequence[DeviceColumn], live: torch.Tensor
                    ) -> torch.Tensor:
    """bool (cap,): row i's keys differ from row i-1's (row 0 always),
    on live rows. Exact: validity, then every order image of the key
    (NULLs equal each other, as peers)."""
    cap = live.shape[0]
    pos = torch.arange(cap, device=live.device)
    b = pos == 0
    for col in cols:
        valid = col.validity
        pv = _shift_down(valid, 1, False)
        diff = valid != pv
        same_img = torch.ones_like(valid)
        for img in sortops.u64_key_image(col, allow_dict=True):
            same_img &= img == _shift_down(img, 1, 0)
        b = b | diff | (valid & ~same_img)
    return b & live


def _run_ids(boundary: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """int64 run id of each row: the boundaries' prefix sum, dead rows
    (sorted last) after every live run, so the ids are nondecreasing."""
    return torch.where(live, torch.cumsum(boundary, 0) - 1, live.shape[0])


def _run_extents(ids: torch.Tensor):
    """(first, last) sorted position of each row's run: a binary search of
    the row's id in the nondecreasing ids."""
    return (torch.searchsorted(ids, ids),
            torch.searchsorted(ids, ids, right=True) - 1)


def window_compute(batch: DeviceBatch, num_child_cols: int,
                   part_idx: Tuple[int, ...], order_idx: Tuple[int, ...],
                   order_asc: Tuple[bool, ...], order_nf: Tuple[bool, ...],
                   specs: Tuple[Tuple, ...],
                   out_schema: Schema) -> DeviceBatch:
    """``batch`` carries the child columns plus the evaluated partition,
    order and value columns the exec appended. Returns the child columns
    (sorted) plus one result column per spec."""
    cap = batch.capacity
    dev = batch.device
    perm = sortops.sort_permutation(
        batch, list(part_idx) + list(order_idx),
        [True] * len(part_idx) + list(order_asc),
        [True] * len(part_idx) + list(order_nf))
    sorted_b = gather_batch(batch, perm, batch.num_rows)
    live = sorted_b.row_mask()
    pos = torch.arange(cap, dtype=torch.int64, device=dev)

    pcols = [sorted_b.columns[i] for i in part_idx]
    ocols = [sorted_b.columns[i] for i in order_idx]
    part_b = _key_boundaries(pcols, live)
    peer_b = part_b | _key_boundaries(pcols + ocols, live)
    seg = _run_ids(part_b, live)
    seg_start, seg_end = _run_extents(seg)
    peer_start, peer_end = _run_extents(_run_ids(peer_b, live))

    out_cols: List[DeviceColumn] = list(sorted_b.columns[:num_child_cols])
    for spec, dt in zip(specs, out_schema.dtypes[num_child_cols:]):
        kind = spec[0]
        if kind == "row_number":
            out_cols.append(DeviceColumn(
                dt, (pos - seg_start + 1).to(torch.int32), live))
            continue
        if kind == "rank":
            out_cols.append(DeviceColumn(
                dt, (peer_start - seg_start + 1).to(torch.int32), live))
            continue
        if kind == "dense_rank":
            pb = torch.cumsum(peer_b, 0)
            out_cols.append(DeviceColumn(
                dt, (pb - pb[seg_start] + 1).to(torch.int32), live))
            continue
        if kind == "leadlag":
            _, vidx, offset, _, default = spec
            vcol = sorted_b.columns[vidx]
            src = pos + offset
            ok = (src >= seg_start) & (src <= seg_end) & live
            src_c = src.clamp(0, cap - 1)
            if vcol.dtype.is_string:
                out_cols.append(gather_column(vcol, src_c, ok))
                continue
            data = vcol.data[src_c]
            validity = ok & vcol.validity[src_c]
            if default is not None:
                # Spark: the default fills rows whose OFFSET row is outside
                # the partition; an in-partition null stays null
                data = torch.where(ok, data, torch.full_like(data, default))
                validity = validity | (live & ~ok)
            else:
                data = torch.where(ok, data, torch.zeros_like(data))
            out_cols.append(DeviceColumn(dt, data.to(
                torch_dtype(dt.np_dtype)), validity))
            continue
        assert kind == "agg"
        _, agg_kind, vidx, frame_kind, lo, hi, _ = spec
        vcol = sorted_b.columns[vidx]
        m = vcol.validity & live

        # frame extent per row in sorted positions [f_lo, f_hi]
        lo_unb, hi_unb = lo <= UNBOUNDED_PRECEDING, hi >= UNBOUNDED_FOLLOWING
        if frame_kind == "range":
            if lo_unb and (hi_unb or hi == CURRENT_ROW):
                f_lo = seg_start
                f_hi = seg_end if hi_unb else peer_end
            else:
                # bounded RANGE over the single ascending nulls-first
                # order column: per-row binary search for order values in
                # [ov + lo, ov + hi]; null-order rows frame over the
                # segment's null run (nulls are peers)
                ocol = sorted_b.columns[order_idx[0]]
                ov = ocol.data.to(torch.int64)
                ovalid = ocol.validity
                vflag = ovalid.to(torch.int64)

                def sat_add(x, c):
                    # int64 add saturating at the type's bounds (a wrapped
                    # target would silently flip the frame empty)
                    t = x + c
                    if c > 0:
                        return torch.where(t < x, _I64_MAX, t)
                    if c < 0:
                        return torch.where(t > x, _I64_MIN, t)
                    return t

                if lo_unb:
                    f_lo = seg_start
                else:
                    t_lo = torch.where(ovalid, sat_add(ov, max(lo, _I64_MIN)),
                                       _I64_MIN)
                    f_lo = _range_frame_search(seg, vflag, ov, vflag, t_lo,
                                               strict=False)
                if hi_unb:
                    f_hi = seg_end
                else:
                    t_hi = torch.where(ovalid, sat_add(ov, min(hi, _I64_MAX)),
                                       _I64_MAX)
                    f_hi = _range_frame_search(seg, vflag, ov, vflag, t_hi,
                                               strict=True) - 1
        else:
            f_lo = seg_start if lo_unb else torch.maximum(pos + lo, seg_start)
            f_hi = seg_end if hi_unb else torch.minimum(pos + hi, seg_end)
        f_lo_c = f_lo.clamp(0, cap - 1)
        f_hi_c = f_hi.clamp(-1, cap - 1)
        empty = f_hi < f_lo

        cnt_p = _exclusive_prefix(m.to(torch.int64))
        frame_count = torch.where(empty, 0, cnt_p[f_hi_c + 1] - cnt_p[f_lo_c])
        if agg_kind == "count":
            out_cols.append(DeviceColumn(
                dt, frame_count.to(torch_dtype(dt.np_dtype)), live.clone()))
            continue
        if agg_kind in ("sum", "avg"):
            acc_dt = (torch.float64 if (dt.is_floating or agg_kind == "avg")
                      else torch.int64)
            acc = torch.where(m, vcol.data.to(acc_dt),
                              torch.zeros((), dtype=acc_dt, device=dev))
            sp = _exclusive_prefix(acc)
            s = torch.where(empty, torch.zeros((), dtype=acc_dt, device=dev),
                            sp[f_hi_c + 1] - sp[f_lo_c])
            if agg_kind == "avg":
                s = s / frame_count.clamp(min=1)
            out_cols.append(DeviceColumn(
                dt, s.to(torch_dtype(dt.np_dtype)), (frame_count > 0) & live))
            continue
        assert agg_kind in ("min", "max")
        if vcol.dtype.is_string:
            # whole-partition string min/max (resolve_descriptor gates the
            # frames): each partition's winning row through the group-by's
            # string selection (rows are partition-sorted already, so the
            # identity permutation makes a valid GroupInfo), then one
            # gather of the winner's value
            from spark_rapids_tpu_torch.ops import groupby as gbops
            info = gbops.GroupInfo(pos.to(torch.int32), seg.to(torch.int32),
                                   part_b, None, None, live)
            rows_by_gid, has_by_gid = gbops.segment_select_string(
                agg_kind, vcol, info)
            seg_c = seg.clamp(max=cap - 1)
            win = rows_by_gid[seg_c].to(torch.int64)
            out_cols.append(gather_column(vcol, win,
                                          has_by_gid[seg_c] & live))
            continue
        v, neutral = _neutral(vcol.data, agg_kind)
        pre = torch.where(m, v, torch.full_like(v, neutral))
        whole = lo_unb and hi_unb
        if lo_unb:
            # frame [seg_start, f_hi] (whole partition, cumulative range
            # incl. peers, bounded-range upper, or ROWS hi): prefix scan
            # read at f_hi
            scanned = segmented_scan_minmax(pre, seg_start, agg_kind, neutral)
            data = scanned[seg_end.clamp(max=cap - 1) if whole
                           else f_hi_c.clamp(min=0)]
        elif hi_unb:
            # frame [f_lo, seg_end]: segmented suffix scan read at f_lo
            rstart = (cap - 1 - seg_end).flip(0)
            rscanned = segmented_scan_minmax(pre.flip(0), rstart, agg_kind,
                                             neutral).flip(0)
            data = rscanned[f_lo_c]
        elif frame_kind == "rows" and (hi - lo + 1) <= 16:
            # narrow ROW frame: unrolled shifted compares
            pick = _pick(agg_kind)
            acc = torch.full_like(pre, neutral)
            for d in range(lo, hi + 1):
                j = pos + d
                ok = (j >= seg_start) & (j <= seg_end) & (j >= 0) & (j < cap)
                cand = torch.where(ok, torch.roll(pre, -d),
                                   torch.full_like(pre, neutral))
                acc = pick(acc, cand)
            data = acc
        else:
            # wide ROW frames and bounded RANGE frames: sparse table
            data = _sparse_minmax(pre, f_lo_c, f_hi_c.clamp(min=0), agg_kind,
                                  neutral)
        if dt == dtypes.BOOL:
            data = data != 0
        out_cols.append(DeviceColumn(dt, data.to(torch_dtype(dt.np_dtype)),
                                     (frame_count > 0) & live))
    return DeviceBatch(out_schema, out_cols, sorted_b.num_rows)
