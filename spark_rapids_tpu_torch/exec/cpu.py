"""CPU physical operators, the session's fallback path and its oracle
(counterpart of the JAX package's ``exec/cpu.py``; its cartesian and
nested-loop joins and the AQE stage materialization wait for later
slices).

These play the role Spark's own row-based operators play for the
reference: what the device cannot run falls back here, and the tests hold
the device path against them. Payload: pandas DataFrames per partition.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema, _numpy_to_pandas
from spark_rapids_tpu_torch.exec.aggutil import AggPlan
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan, group_contiguous,
)
from spark_rapids_tpu_torch.exec.hostagg import grouped_aggregate
from spark_rapids_tpu_torch.sql.exprs.core import BoundRef, Expression
from spark_rapids_tpu_torch.sql.exprs.hostutil import host_unary_values
from spark_rapids_tpu_torch.sql.functions import SortOrder


def _is_masked(s: pd.Series) -> bool:
    """Is this series backed by a masked (nullable-extension) array —
    Int64/Float64/boolean — i.e. does it carry an explicit null mask?"""
    arr = getattr(s, "array", None)
    return hasattr(arr, "_mask") and hasattr(arr, "_data")


def _lift_masked(s: pd.Series) -> pd.Series:
    """Plain-numpy series -> the matching masked extension dtype with an
    all-False mask. Constructed from the raw buffer (NOT pd.array/astype,
    which coerce float NaN to NA) so a genuine NaN VALUE survives as a
    value — NaN and NULL are distinct in this engine's null discipline
    (columnar/batch.py)."""
    if _is_masked(s):
        return s
    vals = s.to_numpy()
    mask = np.zeros(len(vals), dtype=bool)
    try:
        if vals.dtype.kind == "f":
            arr = pd.arrays.FloatingArray(vals, mask)
        elif vals.dtype.kind in "iu":
            arr = pd.arrays.IntegerArray(vals, mask)
        elif vals.dtype.kind == "b":
            arr = pd.arrays.BooleanArray(vals, mask)
        else:
            return s
    except (TypeError, ValueError):
        return s
    return pd.Series(arr, name=s.name)


def concat_host_frames(dfs: List[pd.DataFrame],
                       schema: Schema) -> pd.DataFrame:
    """Null-mask-preserving concat of partition frames.

    pd.concat decides the result dtype from the pieces: a masked
    (nullable-extension) column next to plain-numpy siblings downcasts to
    plain float and its NA values become NaN — but NaN is a VALUE here,
    so the null mask is silently destroyed (tpcxbb q17: a partial
    aggregate's NULL sum from an empty partition merged as NaN and
    poisoned the final sum). When pieces disagree, plain pieces are
    lifted to the masked dtype first (all-False mask — genuine NaN values
    keep being values)."""
    dfs = [df for df in dfs]
    if not dfs:
        return _empty_df(schema)
    if len(dfs) == 1:
        return dfs[0]
    ncols = dfs[0].shape[1]
    mixed = []
    for i in range(ncols):
        kinds = [_is_masked(df.iloc[:, i]) for df in dfs]
        mixed.append(any(kinds) and not all(kinds))
    if any(mixed):
        lifted = []
        for df in dfs:
            series = [(_lift_masked(df.iloc[:, i]) if mixed[i]
                       else df.iloc[:, i]).reset_index(drop=True)
                      for i in range(ncols)]
            # positional assembly: join outputs may carry duplicate names
            nd = (pd.concat(series, axis=1) if series
                  else pd.DataFrame(index=range(len(df))))
            nd.columns = list(df.columns)
            lifted.append(nd)
        dfs = lifted
    return pd.concat(dfs, ignore_index=True)


def _concat_parts(it: Iterator[pd.DataFrame], schema: Schema) -> pd.DataFrame:
    return concat_host_frames(list(it), schema)


def _empty_df(schema: Schema) -> pd.DataFrame:
    cols = {}
    for name, dt in zip(schema.names, schema.dtypes):
        if dt.is_string:
            cols[name] = pd.Series(np.empty(0, dtype=object), dtype="str")
        elif dt.is_datetime:
            cols[name] = pd.Series(np.empty(0, dtype="datetime64[us]"))
        else:
            cols[name] = pd.Series(np.empty(0, dtype=dt.np_dtype))
    return pd.DataFrame(cols)


class CpuScanExec(PhysicalPlan):
    """Scan of a source's partitions of pandas frames (a file's row groups
    or stripes read by pyarrow). ``pushed_filters``: the conjuncts of the
    filter above that footer statistics can answer (``sql/pushdown``,
    hung here by the planner); a source with ``prune_splits`` scans only
    the splits they leave (``kept_splits``)."""

    def __init__(self, source, schema: Schema, pushed_filters=None):
        super().__init__()
        self.source = source
        self._schema = schema
        self.pushed_filters = pushed_filters

    def output_schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        return f"CpuScanExec({self.source.describe()})"

    def fingerprint_extra(self) -> str:
        return scan_fingerprint(self.source, self.pushed_filters,
                                self._schema)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        return self.source.cpu_partitions(
            kept_splits(ctx, self.source, self.pushed_filters))


def kept_splits(ctx: ExecContext, source, pushed_filters):
    """The splits of ``source`` its pushed filters leave, or None (all)
    for a scan with none; the pruned count goes to the query's metrics
    under the source (``numRowGroupsPruned``, ``numStripesPruned`` for
    ORC), as in the JAX package."""
    if not pushed_filters or not hasattr(source, "prune_splits"):
        return None
    splits, pruned = source.prune_splits(pushed_filters)
    ctx.metric_add(source.describe(), source.pruned_metric, pruned)
    return splits


def scan_fingerprint(source, pushed_filters, schema: Schema) -> str:
    """A scan's part of the reuse fingerprint: its data, its pushed
    filters ((name, op, value) tuples with repr-stable values) and its
    columns, so that two scans of one source pruned for different
    predicates never stand for each other."""
    pushed = ",".join(repr(f) for f in (pushed_filters or ()))
    return f"{source.data_uid()}|{pushed}|{','.join(schema.names)}"


def _per_frame(node: PhysicalPlan, ctx: ExecContext, exprs, fn
               ) -> List[Partition]:
    """``fn`` over each frame of each child partition; where ``exprs``
    hold a nondeterministic expression, the task context gets the
    partition's index and the rows of its earlier frames first."""
    from spark_rapids_tpu_torch.exec import taskctx
    from spark_rapids_tpu_torch.sql.exprs.nondet import has_nondeterministic
    impure = any(has_nondeterministic(e) for e in exprs)

    def make(index: int, part: Partition) -> Partition:
        def run():
            seen = 0
            for df in part():
                if impure:
                    taskctx.set_partition(index)
                    taskctx.set_row_base(seen)
                    seen += len(df)
                yield fn(df)
        return run
    return [make(i, p) for i, p in
            enumerate(node.children[0].executed_partitions(ctx))]


class CpuProjectExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan,
                 exprs: Sequence[Tuple[str, Expression]]):
        super().__init__([child])
        self.exprs = list(exprs)

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        return Schema([n for n, _ in self.exprs],
                      [e.dtype(cs) for _, e in self.exprs])

    def describe(self) -> str:
        return f"CpuProjectExec([{', '.join(n for n, _ in self.exprs)}])"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        def project(df: pd.DataFrame) -> pd.DataFrame:
            out = {}
            for name, e in self.exprs:
                out[name] = e.eval_host(df).reset_index(drop=True)
            return pd.DataFrame(out, columns=[n for n, _ in self.exprs])
        return _per_frame(self, ctx, [e for _, e in self.exprs], project)


class CpuFilterExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, condition: Expression):
        super().__init__([child])
        self.condition = condition

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"CpuFilterExec({self.condition!r})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        def select(df: pd.DataFrame) -> pd.DataFrame:
            pred = self.condition.eval_host(df)
            vals, validity, _ = host_unary_values(pred)
            keep = vals.astype(np.bool_) & validity
            return df[keep].reset_index(drop=True)
        return _per_frame(self, ctx, [self.condition], select)


class CpuHashAggregateExec(PhysicalPlan):
    """mode 'partial': group by key exprs, emit keys + update intermediates.
    mode 'final': group by leading key columns, merge intermediates, emit
    finalize projection."""

    def __init__(self, child: PhysicalPlan, plan: AggPlan, mode: str):
        super().__init__([child])
        self.plan = plan
        self.mode = mode

    def output_schema(self) -> Schema:
        return (self.plan.partial_schema if self.mode == "partial"
                else self.plan.output_schema)

    def describe(self) -> str:
        keys = ", ".join(n for n, _ in self.plan.grouping)
        return f"CpuHashAggregateExec(mode={self.mode}, keys=[{keys}])"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)

        def make(part: Partition) -> Partition:
            def run():
                df = _concat_parts(part(), self.children[0].output_schema())
                yield self._aggregate(df)
            return run
        return [make(p) for p in child_parts]

    def _aggregate(self, df: pd.DataFrame) -> pd.DataFrame:
        plan = self.plan
        if self.mode == "partial":
            keys = [host_unary_values(e.eval_host(df))[:2]
                    for _, e in plan.grouping]
            reductions = []
            inputs = [host_unary_values(e.eval_host(df))[:2]
                      for e in plan.update_inputs]
            for ops in plan.update_plan:
                for kind, input_idx, idt in ops:
                    v, m = inputs[input_idx]
                    reductions.append((kind, v, m, idt))
            key_out, red_out = grouped_aggregate(keys, reductions)
            out = {}
            schema = plan.partial_schema
            for i, (name, dt) in enumerate(zip(schema.names, schema.dtypes)):
                if i < plan.num_keys:
                    v, m = key_out[i]
                else:
                    v, m = red_out[i - plan.num_keys]
                out[name] = _numpy_to_pandas(np.asarray(v), np.asarray(m), dt)
            return pd.DataFrame(out, columns=list(schema.names))
        # final: group by leading key cols of the partial schema
        schema = plan.partial_schema
        keys = [host_unary_values(df.iloc[:, i])[:2]
                for i in range(plan.num_keys)]
        reductions = []
        for merged in plan.merge_plan:
            for kind, col, idt in merged:
                v, m = host_unary_values(df.iloc[:, col])[:2]
                reductions.append((kind, v, m, idt))
        key_out, red_out = grouped_aggregate(keys, reductions)
        # rebuild merged partial frame, then run finalize projection
        merged_cols = {}
        ri = 0
        for i, (name, dt) in enumerate(zip(schema.names, schema.dtypes)):
            if i < plan.num_keys:
                if key_out:
                    v, m = key_out[i]
                else:
                    v, m = np.zeros(0), np.zeros(0, np.bool_)
                merged_cols[name] = _numpy_to_pandas(np.asarray(v),
                                                     np.asarray(m), dt)
            else:
                v, m = red_out[ri]
                ri += 1
                merged_cols[name] = _numpy_to_pandas(np.asarray(v),
                                                     np.asarray(m), dt)
        mdf = pd.DataFrame(merged_cols, columns=list(schema.names))
        out = {}
        for name, e in plan.finalize_exprs():
            out[name] = e.eval_host(mdf).reset_index(drop=True)
        return pd.DataFrame(out, columns=[n for n, _ in plan.results])


class CpuShuffleExchangeExec(PhysicalPlan):
    """Materialization barrier repartitioning child output.

    partitioning: ('hash', [col indices], n) | ('single',) |
    ('roundrobin', n) |
    ('range', [key indices], [ascending], [nulls_first], n)."""

    def __init__(self, child: PhysicalPlan, partitioning):
        super().__init__([child])
        self.partitioning = partitioning

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"CpuShuffleExchangeExec({self.partitioning[0]})"

    def materialize_stage(self, ctx: ExecContext):
        """AQE query-stage materialization (``sql/adaptive/``): run the
        map side (this exchange's child), split every map partition by the
        CANONICAL hash of the key columns and report per-(map, reduce
        partition) sizes, the host-side role of
        MapStatus.partition_sizes. Returns (map_outputs[map][pid] ->
        DataFrame, MapOutputStatistics)."""
        from spark_rapids_tpu_torch.obs.progress import PROGRESS
        from spark_rapids_tpu_torch.sql.adaptive import stats as aqestats
        assert self.partitioning[0] == "hash", self.partitioning
        key_idx = list(self.partitioning[1])
        n = self.partitioning[2]
        schema = self.children[0].output_schema()
        map_outputs = []
        for part in self.children[0].executed_partitions(ctx):
            df = concat_host_frames(list(part()), schema)
            map_outputs.append(aqestats.split_frame(df, key_idx, n))
            if PROGRESS.enabled:  # live per-map-partition stage progress
                PROGRESS.shuffle_map_partition()
        return map_outputs, aqestats.stats_from_map_outputs(map_outputs)

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.children[0].output_schema()
        kind = self.partitioning[0]
        if kind == "single":
            def single():
                dfs = [df for p in child_parts for df in p()]
                yield concat_host_frames(dfs, schema)
            return [single]
        if kind in ("hash", "roundrobin"):
            n = self.partitioning[-1]
            buckets: List[List[pd.DataFrame]] = [[] for _ in range(n)]
            for p in child_parts:
                for df in p():
                    if kind == "hash":
                        idx = self.partitioning[1]
                        if idx:
                            h = pd.util.hash_pandas_object(
                                df.iloc[:, list(idx)], index=False).to_numpy()
                        else:
                            h = np.zeros(len(df), dtype=np.uint64)
                        pids = (h % n).astype(np.int64)
                    else:
                        pids = np.arange(len(df), dtype=np.int64) % n
                    for pid in range(n):
                        sel = df[pids == pid]
                        if len(sel):
                            buckets[pid].append(sel.reset_index(drop=True))
            if kind == "hash" and n > 1 and ctx.metrics_enabled:
                # shuffle-skew observability, independent of AQE: per-
                # shuffle max/median partition-size ratio (obs/shuffleobs)
                from spark_rapids_tpu_torch.obs.shuffleobs import (
                    record_shuffle_skew,
                )
                from spark_rapids_tpu_torch.sql.adaptive.stats import (
                    estimate_frame_bytes,
                )
                record_shuffle_skew(
                    [sum(estimate_frame_bytes(f) for f in b)
                     for b in buckets], source="cpu:hash")

            def make(pid: int) -> Partition:
                def run():
                    yield concat_host_frames(buckets[pid], schema)
                return run
            return [make(i) for i in range(n)]
        if kind == "range":
            # ('range', [key indices], [ascending], [nulls_first], n):
            # the host oracle sorts everything once with the same comparator
            # CpuSortExec uses and hands out contiguous chunks — a valid
            # range partitioning by construction (the device path samples
            # bounds instead, GpuRangePartitioner.scala:42-120)
            key_idx, asc, nf, n = self.partitioning[1:]
            orders = [SortOrder(BoundRef(i, schema.dtypes[i],
                                         schema.names[i]), a, f)
                      for i, a, f in zip(key_idx, asc, nf)]

            state: dict = {}

            def chunks():
                if "parts" in state:
                    return state["parts"]
                dfs = [df for p in child_parts for df in p()]
                df = concat_host_frames(dfs, schema)
                idx = host_sort_indices(df, orders)
                df = df.iloc[idx].reset_index(drop=True)
                per = -(-len(df) // n) if len(df) else 0
                state["parts"] = [
                    df.iloc[i * per:(i + 1) * per].reset_index(drop=True)
                    if per else _empty_df(schema) for i in range(n)]
                return state["parts"]

            def make(pid: int) -> Partition:
                def run():
                    yield chunks()[pid]
                return run
            return [make(i) for i in range(n)]
        raise ValueError(f"unknown partitioning {kind}")


def sort_key_arrays(df: pd.DataFrame, orders: Sequence[SortOrder]):
    """Numpy lexsort keys implementing Spark ordering: per-key null
    flag + order-preserving image (floats: NaN largest, -0.0 == 0.0;
    strings: exact lexicographic via factorize-of-sorted-uniques)."""
    keys = []  # most significant first
    for so in orders:
        vals, validity, _ = host_unary_values(so.expr.eval_host(df))
        if vals.dtype == object:
            # NUL-exact: numpy '<U' comparison pads with NULs and merges
            # 'a' with 'a\x00'; dictionary-encode via arrow, rank the
            # (small) dictionary with python compares
            import pyarrow as pa
            filled = np.where(validity, vals, "")
            d = (pa.array(filled, type=pa.string(), from_pandas=True)
                 .dictionary_encode())
            codes = d.indices.to_numpy(zero_copy_only=False).astype(np.int64)
            uniq = np.asarray(d.dictionary.to_pylist(), dtype=object)
            order = np.argsort(uniq)
            rank = np.empty(len(uniq), dtype=np.int64)
            rank[order] = np.arange(len(uniq), dtype=np.int64)
            img = rank[codes]
        elif vals.dtype.kind == "f":
            # exact host image (the CPU oracle models Spark, which orders
            # denormals properly; only the DEVICE image flushes them, an
            # unavoidable TPU FTZ property — ops/floatbits.py)
            f = vals.astype(np.float64)
            f = np.where(f == 0.0, 0.0, f)
            f = np.where(np.isnan(f), np.nan, f)
            bits = f.view(np.uint64)
            sign = bits >> np.uint64(63)
            img = np.where(sign == 1, ~bits,
                           bits | (np.uint64(1) << np.uint64(63))).astype(np.uint64)
        elif vals.dtype == np.bool_:
            img = vals.astype(np.int64)
        else:
            img = vals.astype(np.int64)
        if not so.ascending:
            img = img.max(initial=0) - img if img.dtype != np.uint64 else ~img
            if img.dtype == np.int64:
                pass
        null_flag = np.where(validity, 1, 0) if so.nulls_first else \
            np.where(validity, 0, 1)
        keys.append((null_flag, img))
    return keys


def host_sort_indices(df: pd.DataFrame, orders: Sequence[SortOrder]) -> np.ndarray:
    keys = sort_key_arrays(df, orders)
    # np.lexsort: last key is primary -> reverse
    lex = []
    for null_flag, img in reversed(keys):
        lex.append(img)
        lex.append(null_flag)
    if not lex:
        return np.arange(len(df))
    return np.lexsort(lex)


class CpuSortExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder]):
        super().__init__([child])
        self.orders = list(orders)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"CpuSortExec({self.orders})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)

        def make(part: Partition) -> Partition:
            def run():
                df = _concat_parts(part(), self.children[0].output_schema())
                idx = host_sort_indices(df, self.orders)
                yield df.iloc[idx].reset_index(drop=True)
            return run
        return [make(p) for p in child_parts]


class CpuLocalLimitExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, limit: int):
        super().__init__([child])
        self.limit = limit

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)

        def make(part: Partition) -> Partition:
            def run():
                remaining = self.limit
                for df in part():
                    if remaining <= 0:
                        break
                    take = df.head(remaining)
                    remaining -= len(take)
                    yield take
            return run
        return [make(p) for p in child_parts]


class CpuGlobalLimitExec(CpuLocalLimitExec):
    pass


class CpuUnionExec(PhysicalPlan):
    def __init__(self, children: Sequence[PhysicalPlan]):
        super().__init__(children)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        out: List[Partition] = []
        for c in self.children:
            out.extend(c.executed_partitions(ctx))
        return out


class CpuRangeExec(PhysicalPlan):
    """Spark's Range source (reference analogue: GpuRangeExec,
    basicPhysicalOperators.scala:181)."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 name: str = "id"):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self.col_name = name

    def output_schema(self) -> Schema:
        return Schema([self.col_name], [dtypes.INT64])

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self.num_partitions) if total else 0

        def make(i: int) -> Partition:
            def run():
                lo = i * per
                hi = min(total, (i + 1) * per)
                vals = self.start + np.arange(lo, hi, dtype=np.int64) * self.step
                yield pd.DataFrame({self.col_name: vals})
            return run
        return [make(i) for i in range(self.num_partitions)]


class CpuExpandExec(PhysicalPlan):
    """One output row per (input row x projection set)."""

    def __init__(self, child: PhysicalPlan, projections):
        super().__init__([child])
        self.projections = [list(p) for p in projections]

    def output_schema(self) -> Schema:
        cs = self.children[0].output_schema()
        first = self.projections[0]
        return Schema([n for n, _ in first],
                      [e.dtype(cs) for _, e in first])

    def describe(self) -> str:
        return f"CpuExpandExec({len(self.projections)} sets)"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        names = [n for n, _ in self.projections[0]]

        def make(part: Partition) -> Partition:
            def run():
                for df in part():
                    for proj in self.projections:
                        out = {}
                        for j, (name, e) in enumerate(proj):
                            out[j] = e.eval_host(df).reset_index(drop=True)
                        frame = pd.concat(out.values(), axis=1) if out else \
                            pd.DataFrame(index=range(len(df)))
                        frame.columns = names
                        yield frame
            return run
        return [make(p) for p in child_parts]


class CpuCoalescePartitionsExec(PhysicalPlan):
    """Narrow partition merge, no shuffle (Spark CoalesceExec; reference
    rule GpuOverrides.scala:1611-1615)."""

    def __init__(self, child: PhysicalPlan, n: int):
        super().__init__([child])
        self.n = max(1, int(n))

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"CpuCoalescePartitionsExec({self.n})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        groups = group_contiguous(child_parts, self.n)

        def make(group: List[Partition]) -> Partition:
            def run():
                got = False
                for p in group:
                    for df in p():
                        got = True
                        yield df
                if not got:
                    yield _empty_df(self.output_schema())
            return run
        return [make(g) for g in groups]


class CpuCollectLimitExec(PhysicalPlan):
    """Root-position limit: take the first ``limit`` rows across child
    partitions in order (reference: GpuCollectLimitExec)."""

    def __init__(self, child: PhysicalPlan, limit: int):
        super().__init__([child])
        self.limit = int(limit)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"CpuCollectLimitExec({self.limit})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)

        def run():
            remaining = self.limit
            for p in child_parts:
                if remaining <= 0:
                    return
                for df in p():
                    if remaining <= 0:
                        return
                    take = df.head(remaining)
                    remaining -= len(take)
                    yield take
        return [run]


class CpuBroadcastExchangeExec(PhysicalPlan):
    """Collects the child once and hands the frame to every consumer
    partition (Spark's BroadcastExchangeExec)."""

    def __init__(self, child: PhysicalPlan):
        super().__init__([child])
        self._cache: dict = {}

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child = self.children[0]

        def run():
            if "df" not in self._cache:
                parts = child.executed_partitions(ctx)
                self._cache["df"] = _concat_parts(
                    (df for p in parts for df in p()), child.output_schema())
            yield self._cache["df"]
        return [run]


def _assemble_join(ldf: pd.DataFrame, rdf: pd.DataFrame, ls: Schema,
                   rs: Schema, lrow: np.ndarray,
                   rrow: np.ndarray) -> pd.DataFrame:
    """Join output columns gathered from each side at the pair indices;
    -1 marks a missing side (an outer join's nulls)."""
    series = []
    for df, schema, rows in ((ldf, ls, lrow), (rdf, rs, rrow)):
        present = rows >= 0
        safe = np.clip(rows, 0, max(len(df) - 1, 0))
        for i, dt in enumerate(schema.dtypes):
            vals, validity, _ = host_unary_values(df.iloc[:, i])
            if len(df):
                out_v = vals[safe]
                out_m = validity[safe] & present
            else:
                out_v = np.empty(len(rows),
                                 dtype=object if dt.is_string else dt.np_dtype)
                out_m = np.zeros(len(rows), np.bool_)
            if dt.is_string and (~out_m).any():
                out_v = out_v.copy()
                out_v[~out_m] = None
            series.append(_numpy_to_pandas(out_v, out_m, dt)
                          .reset_index(drop=True))
    out = pd.concat(series, axis=1) if series else pd.DataFrame(
        index=range(len(lrow)))
    out.columns = list(ls.names) + list(rs.names)
    return out


def _cross_rows(nl: int, nr: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (left row, right row) pairs of a cross product, left-major."""
    return (np.repeat(np.arange(nl, dtype=np.int64), nr),
            np.tile(np.arange(nr, dtype=np.int64), nl))


class CpuJoinExec(PhysicalPlan):
    """Equi-join over pandas merge with SQL null keys (a null key never
    matches). join_type: inner, left, right, full, leftsemi, leftanti,
    or cross (no keys: every left row with every right row).
    The merge gives only the (left row, right row) pairs; the output is
    gathered from the original frames, so a missing side is a true null,
    never the NaN a merge's upcast would make."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, left_keys: List[int], right_keys: List[int]):
        super().__init__([left, right])
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)

    def output_schema(self) -> Schema:
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()
        if self.join_type in ("leftsemi", "leftanti"):
            return ls
        return Schema(list(ls.names) + list(rs.names),
                      list(ls.dtypes) + list(rs.dtypes))

    def describe(self) -> str:
        # the broadcast subclass describes itself so too, as the JAX
        # package's does; the exchange below it shows the broadcast
        return f"CpuJoinExec({self.join_type})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        left_parts = self.children[0].executed_partitions(ctx)
        right_parts = self.children[1].executed_partitions(ctx)
        # a one-partition broadcast side pairs with every partition of the
        # other side
        if len(left_parts) != len(right_parts):
            if len(right_parts) == 1:
                right_parts = right_parts * len(left_parts)
            elif len(left_parts) == 1:
                left_parts = left_parts * len(right_parts)
            else:
                raise AssertionError("join children must be co-partitioned "
                                     "or one side broadcast")

        def make(lp: Partition, rp: Partition) -> Partition:
            def run():
                ldf = _concat_parts(lp(), self.children[0].output_schema())
                rdf = _concat_parts(rp(), self.children[1].output_schema())
                yield self._join(ldf, rdf)
            return run
        return [make(lp, rp) for lp, rp in zip(left_parts, right_parts)]

    def _join(self, ldf: pd.DataFrame, rdf: pd.DataFrame) -> pd.DataFrame:
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()
        nl, nr = len(ldf), len(rdf)
        lkey_frame = pd.DataFrame(
            {f"k{j}": ldf.iloc[:, i].reset_index(drop=True)
             for j, i in enumerate(self.left_keys)})
        rkey_frame = pd.DataFrame(
            {f"k{j}": rdf.iloc[:, i].reset_index(drop=True)
             for j, i in enumerate(self.right_keys)})
        lvalid = np.ones(nl, np.bool_)
        for c in range(lkey_frame.shape[1]):
            lvalid &= host_unary_values(lkey_frame.iloc[:, c])[1]
        rvalid = np.ones(nr, np.bool_)
        for c in range(rkey_frame.shape[1]):
            rvalid &= host_unary_values(rkey_frame.iloc[:, c])[1]
        lkey_frame["_lrow"] = np.arange(nl, dtype=np.int64)
        rkey_frame["_rrow"] = np.arange(nr, dtype=np.int64)
        keys = [f"k{j}" for j in range(len(self.left_keys))]
        jt = self.join_type
        if jt == "cross":
            return _assemble_join(ldf, rdf, ls, rs, *_cross_rows(nl, nr))
        lm = lkey_frame[lvalid]
        rm = rkey_frame[rvalid]
        if jt in ("leftsemi", "leftanti"):
            rk = rm[keys].drop_duplicates()
            hit = lm.merge(rk, on=keys, how="inner")["_lrow"].to_numpy()
            keep = np.full(nl, jt == "leftanti", np.bool_)
            keep[hit] = jt == "leftsemi"
            return ldf[keep].reset_index(drop=True)
        how = {"inner": "inner", "left": "left", "right": "right",
               "full": "outer"}[jt]
        merged = lm.merge(rm, on=keys, how=how)
        lrow = merged["_lrow"].to_numpy(dtype=np.float64, na_value=-1) \
            .astype(np.int64)
        rrow = merged["_rrow"].to_numpy(dtype=np.float64, na_value=-1) \
            .astype(np.int64)
        # null-keyed rows of a preserved side come back unmatched
        if jt in ("left", "full") and (~lvalid).any():
            extra = np.flatnonzero(~lvalid).astype(np.int64)
            lrow = np.concatenate([lrow, extra])
            rrow = np.concatenate([rrow, np.full(len(extra), -1, np.int64)])
        if jt in ("right", "full") and (~rvalid).any():
            extra = np.flatnonzero(~rvalid).astype(np.int64)
            lrow = np.concatenate([lrow, np.full(len(extra), -1, np.int64)])
            rrow = np.concatenate([rrow, extra])
        return _assemble_join(ldf, rdf, ls, rs, lrow, rrow)


class CpuBroadcastHashJoinExec(CpuJoinExec):
    """Equi-join whose build side is a broadcast exchange. It runs as
    CpuJoinExec; the class of its own carries its own rule and conf
    key."""


class CpuCartesianProductExec(CpuJoinExec):
    """The unconditioned cross product (Spark's CartesianProductExec), of
    two single partitions."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan):
        super().__init__(left, right, "cross", [], [])

    def describe(self) -> str:
        return "CpuCartesianProductExec"


class CpuBroadcastNestedLoopJoinExec(PhysicalPlan):
    """A join on an arbitrary boolean condition (Spark's
    BroadcastNestedLoopJoinExec, inner/cross only): every stream row pairs
    with every broadcast row, then the condition, bound to the combined
    left + right schema, keeps the pairs it holds for."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 join_type: str, condition: Optional[Expression]):
        super().__init__([left, right])
        self.join_type = join_type
        self.condition = condition

    def output_schema(self) -> Schema:
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()
        return Schema(list(ls.names) + list(rs.names),
                      list(ls.dtypes) + list(rs.dtypes))

    def describe(self) -> str:
        return f"CpuBroadcastNestedLoopJoinExec({self.join_type})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        left_parts = self.children[0].executed_partitions(ctx)
        right_parts = self.children[1].executed_partitions(ctx)
        if len(right_parts) != 1:
            raise AssertionError("a nested-loop join's build side is one "
                                 "broadcast partition")
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()

        def make(lp: Partition) -> Partition:
            def run():
                ldf = _concat_parts(lp(), ls)
                rdf = _concat_parts(right_parts[0](), rs)
                out = _assemble_join(ldf, rdf, ls, rs,
                                     *_cross_rows(len(ldf), len(rdf)))
                if self.condition is not None and len(out):
                    vals, validity, _ = host_unary_values(
                        self.condition.eval_host(out))
                    out = out[vals.astype(np.bool_)
                              & validity].reset_index(drop=True)
                yield out
            return run
        return [make(lp) for lp in left_parts]
