"""Window physical operators (counterpart of the JAX package's
``exec/windowexec.py``; reference: GpuWindowExec.scala:202 and the window
parts of Spark's WindowExec for the CPU operator).

Both sides share the descriptor resolution in ``resolve_descriptor`` (its
tag reasons are the JAX package's, word for word), so they compute the
same frames. The CPU operator, the session's fallback, is a copy of the
JAX package's numpy mirror of the device math (positions, segment starts,
prefix sums) rather than pandas rolling, so null semantics match exactly.
The device operator runs ``ops/windowops.window_compute`` over one batch
per partition.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, _numpy_to_pandas,
)
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.sql.exprs.aggregates import (
    Average, Count, Max, Min, Sum,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import host_unary_values
from spark_rapids_tpu_torch.sql.functions import SortOrder
from spark_rapids_tpu_torch.sql.window import (
    DenseRank, LeadLag, Rank, RowNumber, UNBOUNDED_FOLLOWING,
    UNBOUNDED_PRECEDING, WindowExpression, is_bounded_range,
)

_AGG_KINDS = {Sum: "sum", Count: "count", Min: "min", Max: "max",
              Average: "avg"}
_MICROS_PER_DAY = 86_400_000_000


def resolve_descriptor(wexpr: WindowExpression, schema: Schema):
    """-> (descriptor_without_value_index, value_expr_or_None, tpu_error).
    ``tpu_error`` marks TPU-capability gaps only — the CPU oracle executes
    any non-None descriptor (the fallback path must work, the reference's
    willNotWorkOnGpu contract). A None descriptor is unsupported anywhere.
    The value index is assigned by the exec once it lays out the work
    batch."""
    fn = wexpr.fn
    if isinstance(fn, RowNumber):
        return ("row_number",), None, None
    if isinstance(fn, Rank):
        return ("rank",), None, None
    if isinstance(fn, DenseRank):
        return ("dense_rank",), None, None
    if isinstance(fn, LeadLag):
        off = fn.offset if fn.is_lead else -fn.offset
        child = fn.children[0]
        cdt = child.dtype(schema)
        err = None
        if fn.default is not None and (cdt.is_string or cdt.is_datetime):
            err = (f"lead/lag default values over {cdt.name} are not "
                   "supported on TPU")
        return ("leadlag", None, off, cdt.name, fn.default), child, err
    kind = _AGG_KINDS.get(type(fn))
    if kind is None:
        return None, None, (f"window function {fn.pretty_name} "
                            "is not supported")
    child = fn.children[0]
    frame_kind, lo, hi = wexpr.spec.resolved_frame(is_ranking=False)
    err = None
    if is_bounded_range(frame_kind, lo, hi):
        # the reference's time-range frames
        # (GpuWindowExpression.scala:198 aggregateWindowsOverTimeRanges)
        orders = wexpr.spec.orders
        if len(orders) != 1:
            return None, None, ("a RANGE frame with offsets requires "
                                "exactly one order-by column")
        odt = orders[0].expr.dtype(schema)
        if not (odt.is_numeric or odt.is_datetime):
            return None, None, (f"RANGE frame offsets over {odt.name} "
                                "order are not supported")
        if not orders[0].ascending:
            err = ("bounded RANGE over a descending order is not "
                   "supported on TPU")
        elif not orders[0].nulls_first:
            err = ("bounded RANGE with nulls-last ordering is not "
                   "supported on TPU")
        elif odt.is_floating:
            err = ("bounded RANGE over a floating-point order column is "
                   "not supported on TPU")
    if child.dtype(schema).is_string:
        whole = (lo <= UNBOUNDED_PRECEDING and hi >= UNBOUNDED_FOLLOWING)
        if kind == "count":
            pass  # count only consumes validity — any frame works
        elif kind in ("min", "max") and not whole:
            err = (f"window {kind} over strings supports only "
                   "whole-partition frames on TPU")
        elif kind not in ("min", "max"):
            err = f"window {kind} over strings is not supported on TPU"
        else:
            err = None
    return ("agg", kind, None, frame_kind, lo, hi,
            wexpr.dtype(schema).name), child, err


def _host_bounded_range_extents(ov, om, part_b, lo, hi, asc,
                                seg_start, seg_end):
    """Per-row [f_lo, f_hi] sorted-position extents for a bounded RANGE
    frame (host oracle; also the fallback executor for the device-tagged
    gaps: descending order, nulls-last, float order columns).

    Normalization: w = ov ascending / -ov descending maps both directions
    onto 'order values in [w+lo, w+hi]' over an ascending array. Null rows
    frame over the segment's null run; float NaN rows (sorted greatest)
    over the NaN run — both are peer groups. UNBOUNDED ends widen to the
    segment edge afterwards."""
    n = len(ov)
    lo_unb, hi_unb = lo <= UNBOUNDED_PRECEDING, hi >= UNBOUNDED_FOLLOWING
    w = np.asarray(ov)
    if not asc:
        if w.dtype.kind in "iub":
            w = w.astype(np.int64)
            # -INT64_MIN wraps back to itself and would sort FIRST in the
            # negated (ascending) space instead of last; saturate it to
            # INT64_MAX so it stays the extreme (it collapses with
            # -(INT64_MIN+1), acceptable for a bounded-range frame at the
            # far edge of the domain)
            imin = np.iinfo(np.int64).min
            with np.errstate(over="ignore"):
                w = np.where(w == imin, np.iinfo(np.int64).max, -w)
        else:
            w = -w.astype(np.float64)
    f_lo = np.empty(n, np.int64)
    f_hi = np.empty(n, np.int64)
    starts = np.flatnonzero(part_b)
    ends = np.r_[starts[1:] - 1, n - 1] if len(starts) else np.array([], int)
    for s0, e0 in zip(starts, ends):
        sl = slice(s0, e0 + 1)
        valid = np.asarray(om[sl], bool)
        ww = w[sl]
        isnan = (np.isnan(ww) & valid if ww.dtype.kind == "f"
                 else np.zeros(len(ww), bool))
        normal = valid & ~isnan
        ni = np.flatnonzero(normal)
        for runmask in (~valid, isnan):
            ri = np.flatnonzero(runmask)
            if len(ri):
                f_lo[s0 + ri] = s0 + ri[0]
                f_hi[s0 + ri] = s0 + ri[-1]
        if len(ni):
            vv = ww[ni]

            def sat_add(x, c):
                # saturating add for integer order values (a wrapped
                # target would silently flip the frame empty)
                if x.dtype.kind not in "iu":
                    return x + c
                with np.errstate(over="ignore"):
                    t = x + np.int64(c)
                ii = np.iinfo(np.int64)
                if c > 0:
                    return np.where(t < x, ii.max, t)
                if c < 0:
                    return np.where(t > x, ii.min, t)
                return t

            l = np.searchsorted(vv, sat_add(vv, lo), "left") if not lo_unb \
                else np.zeros(len(ni), np.int64)
            r = (np.searchsorted(vv, sat_add(vv, hi), "right") - 1) \
                if not hi_unb else np.full(len(ni), len(ni) - 1, np.int64)
            lo_rows = np.where(l < len(ni),
                               ni[np.clip(l, 0, len(ni) - 1)],
                               e0 - s0 + 1)  # sentinel: empty frame
            hi_rows = np.where(r >= 0, ni[np.clip(r, 0, len(ni) - 1)], -1)
            f_lo[s0 + ni] = s0 + lo_rows
            f_hi[s0 + ni] = s0 + hi_rows
    if lo_unb:
        f_lo = seg_start.copy()
    if hi_unb:
        f_hi = seg_end.copy()
    return f_lo, f_hi


class CpuWindowExec(PhysicalPlan):
    """CPU oracle: numpy mirror of the device window math."""

    def __init__(self, child: PhysicalPlan,
                 window_exprs: List[Tuple[str, WindowExpression]]):
        super().__init__([child])
        self.window_exprs = list(window_exprs)

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        names = list(cs.names) + [n for n, _ in self.window_exprs]
        dts = list(cs.dtypes) + [w.dtype(cs) for _, w in self.window_exprs]
        return Schema(names, dts)

    def describe(self) -> str:
        return f"CpuWindowExec([{', '.join(n for n, _ in self.window_exprs)}])"

    def fingerprint_extra(self) -> str:
        return _window_fingerprint(self.window_exprs)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        from spark_rapids_tpu_torch.exec.cpu import _concat_parts

        def make(part: Partition) -> Partition:
            def run():
                df = _concat_parts(part(), self.children[0].output_schema())
                yield self._compute(df)
            return run
        return [make(p) for p in child_parts]

    def _compute(self, df: pd.DataFrame) -> pd.DataFrame:
        from spark_rapids_tpu_torch.exec.cpu import host_sort_indices
        cs = self.children[0].output_schema()
        spec = self.window_exprs[0][1].spec
        orders = ([SortOrder(e, True, True) for e in spec.partition_cols]
                  + list(spec.orders))
        idx = host_sort_indices(df, orders)
        sdf = df.iloc[idx].reset_index(drop=True)
        n = len(sdf)
        pos = np.arange(n, dtype=np.int64)

        def key_tuple(exprs):
            cols = []
            for e in exprs:
                vals, validity, _ = host_unary_values(e.eval_host(sdf))
                cols.append((vals, validity))
            return cols

        def boundaries(cols):
            b = np.zeros(n, dtype=bool)
            if n:
                b[0] = True
            for vals, validity in cols:
                if n <= 1:
                    continue
                prev_v, cur_v = vals[:-1], vals[1:]
                prev_m, cur_m = validity[:-1], validity[1:]
                if vals.dtype.kind == "f":
                    eq = (prev_v == cur_v) | (np.isnan(prev_v.astype(float))
                                              & np.isnan(cur_v.astype(float)))
                else:
                    eq = prev_v == cur_v
                same = (prev_m == cur_m) & (eq | ~prev_m)
                b[1:] |= ~same
            return b

        if n == 0:
            from spark_rapids_tpu_torch.exec.cpu import _empty_df
            return _empty_df(self.output_schema())

        part_cols = key_tuple(spec.partition_cols)
        order_cols = key_tuple([o.expr for o in spec.orders])
        part_b = boundaries(part_cols) if spec.partition_cols else \
            (np.arange(n) == 0)
        peer_b = part_b | boundaries(part_cols + order_cols)

        seg = np.cumsum(part_b) - 1
        peer = np.cumsum(peer_b) - 1

        def group_bound(ids, reduce_at, init):
            acc = np.full(ids.max() + 1, init, np.int64)
            reduce_at(acc, ids, pos)
            return acc[ids]

        seg_start = group_bound(seg, np.minimum.at, n)
        seg_end = group_bound(seg, np.maximum.at, -1)
        peer_end = group_bound(peer, np.maximum.at, -1)

        result_series = list(sdf.iloc[:, i] for i in range(len(cs)))
        for name, wexpr in self.window_exprs:
            desc, value_expr, _tpu_err = resolve_descriptor(wexpr, cs)
            if desc is None:
                raise NotImplementedError(_tpu_err)
            dt = wexpr.dtype(cs)
            if value_expr is not None:
                v, m, _ = host_unary_values(value_expr.eval_host(sdf))
                if value_expr.dtype(cs) == dtypes.DATE32 and \
                        v.dtype.kind != "O":
                    # host dates ride as midnight micros; window math and
                    # DATE32 result columns work in days like the device
                    v = v.astype(np.int64) // _MICROS_PER_DAY
            kind = desc[0]
            if kind == "row_number":
                data, validity = pos - seg_start + 1, np.ones(n, bool)
            elif kind == "rank":
                peer_start = group_bound(peer, np.minimum.at, n)
                data = peer_start - seg_start + 1
                validity = np.ones(n, bool)
            elif kind == "dense_rank":
                pb = np.cumsum(peer_b)
                data = pb - pb[seg_start] + 1
                validity = np.ones(n, bool)
            elif kind == "leadlag":
                off, default = desc[2], desc[4]
                src = pos + off
                ok = (src >= seg_start) & (src <= seg_end)
                src_c = np.clip(src, 0, n - 1)
                validity = ok & m[src_c]
                if default is not None:
                    if dt.is_datetime:  # device tags this off; oracle runs it
                        ns = pd.Timestamp(default).value
                        default = (ns // (_MICROS_PER_DAY * 1000)
                                   if dt == dtypes.DATE32 else ns // 1000)
                    data = np.where(ok, v[src_c], default)
                    validity = validity | ~ok
                else:
                    data = np.where(ok, v[src_c], np.zeros_like(v[src_c]))
            else:
                _, agg_kind, _, frame_kind, lo, hi, _ = desc
                mm = m.copy()
                range_bounded = is_bounded_range(frame_kind, lo, hi)
                if range_bounded:
                    ovv, ovm = order_cols[0]
                    if spec.orders[0].expr.dtype(cs) == dtypes.DATE32:
                        # offsets are DAYS for date order columns (device
                        # kernels see int32 days; host dates ride as micros)
                        ovv = ovv.astype(np.int64) // _MICROS_PER_DAY
                    f_lo, f_hi = _host_bounded_range_extents(
                        ovv, ovm, part_b, lo, hi,
                        spec.orders[0].ascending, seg_start, seg_end)
                elif frame_kind == "range":
                    f_lo, f_hi = seg_start, (
                        seg_end if hi >= UNBOUNDED_FOLLOWING else peer_end)
                else:
                    f_lo = (seg_start if lo <= UNBOUNDED_PRECEDING
                            else np.maximum(pos + lo, seg_start))
                    f_hi = (seg_end if hi >= UNBOUNDED_FOLLOWING
                            else np.minimum(pos + hi, seg_end))
                empty = f_hi < f_lo
                f_lo_c = np.clip(f_lo, 0, max(n - 1, 0))
                f_hi_c = np.clip(f_hi, -1, max(n - 1, 0))
                cnt_p = np.concatenate([[0], np.cumsum(mm.astype(np.int64))])
                fcount = np.where(empty, 0, cnt_p[f_hi_c + 1] - cnt_p[f_lo_c])
                if agg_kind == "count":
                    data, validity = fcount, np.ones(n, bool)
                elif agg_kind in ("sum", "avg"):
                    acc = np.where(mm, v, 0).astype(
                        np.float64 if (dt.is_floating or agg_kind == "avg")
                        else np.int64)
                    sp = np.concatenate([[0], np.cumsum(acc)])
                    s = np.where(empty, 0, sp[f_hi_c + 1] - sp[f_lo_c])
                    data = (s / np.maximum(fcount, 1) if agg_kind == "avg"
                            else s)
                    validity = fcount > 0
                elif v.dtype == object:  # string min/max
                    pick = min if agg_kind == "min" else max
                    data = np.empty(n, dtype=object)
                    validity = np.zeros(n, bool)
                    whole_ = (lo <= UNBOUNDED_PRECEDING
                              and hi >= UNBOUNDED_FOLLOWING)
                    if whole_:
                        sts = np.flatnonzero(part_b)
                        eds = np.r_[sts[1:] - 1, n - 1]
                        for s0, e0 in zip(sts, eds):
                            vals = [x for x, ok in
                                    zip(v[s0:e0 + 1], mm[s0:e0 + 1]) if ok]
                            if vals:
                                data[s0:e0 + 1] = pick(vals)
                                validity[s0:e0 + 1] = True
                    else:
                        # fallback-only shape (device handles whole
                        # frames): direct per-row frame reduction
                        for i in range(n):
                            if f_hi[i] >= f_lo[i]:
                                vals = [x for x, ok in zip(
                                    v[f_lo_c[i]:f_hi_c[i] + 1],
                                    mm[f_lo_c[i]:f_hi_c[i] + 1]) if ok]
                                if vals:
                                    data[i] = pick(vals)
                                    validity[i] = True
                else:  # min/max cumulative or whole partition
                    if v.dtype.kind == "f":
                        neutral = np.inf if agg_kind == "min" else -np.inf
                    elif v.dtype == np.bool_:
                        v = v.astype(np.int64)
                        neutral = 1 if agg_kind == "min" else 0
                    else:
                        ii = np.iinfo(v.dtype if v.dtype.kind in "iu"
                                      else np.int64)
                        neutral = ii.max if agg_kind == "min" else ii.min
                    pre = np.where(mm, v, neutral).astype(
                        np.float64 if v.dtype.kind == "f" else np.int64)
                    fn_ = np.minimum if agg_kind == "min" else np.maximum
                    whole = (lo <= UNBOUNDED_PRECEDING
                             and hi >= UNBOUNDED_FOLLOWING)
                    if whole or (frame_kind == "range"
                                 and not range_bounded):
                        scan = pre.copy()
                        for i in range(1, n):
                            if not part_b[i]:
                                scan[i] = fn_(scan[i - 1], scan[i])
                        data = (scan[seg_end] if whole
                                else scan[np.clip(peer_end, 0, n - 1)])
                    else:
                        # bounded ROW/RANGE frame: direct per-row reduction
                        red = np.min if agg_kind == "min" else np.max
                        data = np.full(n, neutral, pre.dtype)
                        for i in range(n):
                            if f_hi[i] >= f_lo[i]:
                                data[i] = red(pre[f_lo_c[i]:f_hi_c[i] + 1])
                    validity = fcount > 0
            if dt.is_string:
                out_arr = np.asarray(data, dtype=object)
                out_arr = np.where(np.asarray(validity), out_arr, None)
            else:
                out_arr = np.asarray(data).astype(dt.np_dtype, copy=False)
            result_series.append(_numpy_to_pandas(out_arr,
                                                  np.asarray(validity), dt))
        out_schema = self.output_schema()
        frame = pd.concat([s.reset_index(drop=True)
                           for s in result_series], axis=1)
        frame.columns = list(out_schema.names)
        return frame


def _window_fingerprint(window_exprs) -> str:
    return ";".join(f"{n}={w!r}/{w.spec.frame}" for n, w in window_exprs)


class TpuWindowExec(PhysicalPlan):
    """Device window stage: the partition's batches concatenated into one
    (reference: GpuWindowExec requires them coalesced the same way), the
    partition, order and value expressions appended, then
    ``windowops.window_compute``. Behind the one-device exchange collapse a
    partition is the whole input. No host sync."""

    columnar_output = True

    def __init__(self, child: PhysicalPlan,
                 window_exprs: List[Tuple[str, WindowExpression]]):
        super().__init__([child])
        self.window_exprs = list(window_exprs)

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        names = list(cs.names) + [n for n, _ in self.window_exprs]
        dts = list(cs.dtypes) + [w.dtype(cs) for _, w in self.window_exprs]
        return Schema(names, dts)

    def describe(self) -> str:
        return f"TpuWindowExec([{', '.join(n for n, _ in self.window_exprs)}])"

    def fingerprint_extra(self) -> str:
        return _window_fingerprint(self.window_exprs)

    def _plan_work(self):
        """(descriptors with their value indices, partition / order index
        tuples, directions, the expressions appended to the batch)."""
        cs = self.children[0].output_schema()
        spec = self.window_exprs[0][1].spec
        nc = len(cs)
        descs, value_exprs = [], []
        for _, w in self.window_exprs:
            desc, vexpr, err = resolve_descriptor(w, cs)
            assert err is None, err
            if vexpr is not None:
                vidx = nc + len(spec.partition_cols) + len(spec.orders) \
                    + len(value_exprs)
                value_exprs.append(vexpr)
                if desc[0] == "leadlag":
                    desc = (desc[0], vidx) + desc[2:]
                else:
                    desc = desc[:2] + (vidx,) + desc[3:]
            descs.append(desc)
        npart = len(spec.partition_cols)
        part_idx = tuple(range(nc, nc + npart))
        order_idx = tuple(range(nc + npart, nc + npart + len(spec.orders)))
        extra = (list(spec.partition_cols) + [o.expr for o in spec.orders]
                 + value_exprs)
        return (tuple(descs), part_idx, order_idx,
                tuple(o.ascending for o in spec.orders),
                tuple(o.nulls_first for o in spec.orders), extra)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import concat_device
        from spark_rapids_tpu_torch.ops.windowops import window_compute
        from spark_rapids_tpu_torch.sql.exprs.evalbridge import (
            make_context, to_device_column,
        )
        cs = self.children[0].output_schema()
        out_schema = self.output_schema()
        descs, part_idx, order_idx, asc, nf, extra = self._plan_work()

        def compute(batch: DeviceBatch) -> DeviceBatch:
            ectx = make_context(batch)
            cols = list(batch.columns)
            for e in extra:
                cols.append(to_device_column(ectx, e.eval_device(ectx)))
            names = list(batch.schema.names) + [f"_w{i}"
                                                for i in range(len(extra))]
            work = DeviceBatch(Schema(names, [c.dtype for c in cols]), cols,
                               batch.num_rows)
            return window_compute(work, len(cs), part_idx, order_idx, asc,
                                  nf, descs, out_schema)

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                yield compute(concat_device(list(part()), cs,
                                            ctx.conf.capacity_growth,
                                            ctx.device))
            return run
        return [make(p) for p in self.children[0].executed_partitions(ctx)]
