"""The session and DataFrame API (counterpart of the JAX package's
``session.py``).

``TpuSparkSession`` plans a DataFrame's logical plan into a CPU physical
plan (``sql/planner.py``), tags and converts it to device operators
(``sql/overrides.py``), runs it and collects the result to pandas:

    s = TpuSparkSession.builder().config("spark.rapids.sql.test.enabled",
                                         True).get_or_create()
    df = s.create_dataframe(frame)
    df.filter(F.col("x") > 1).group_by("k").agg(F.sum("v").alias("sv"))
    ...collect()    # a pandas DataFrame

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``, as the tests do): the device path then runs
the kernels' plain versions. ``spark.rapids.sql.enabled=false`` runs the
CPU operators on pandas instead. Files come in through ``s.read.parquet``
(decoded on the device, kernels B5-B8; by pyarrow on the host where
``spark.rapids.sql.enabled=false``); ``DataFrame.join`` plans an equi-join,
broadcast under ``spark.rapids.sql.autoBroadcastJoinThreshold``, a cross
join (``on=None``) and a join on a boolean condition (``on=<Column>``, the
broadcast nested-loop join, on the device only where
``spark.rapids.sql.exec.BroadcastNestedLoopJoinExec`` is set true).

Left out of the JAX package's session, each a later ROADMAP item: the
device manager, semaphore, spill catalog and OOM handling (A.8); the mesh,
shuffle environments and encoded-page cache (A.7, A.9); AQE and the
speculation verification (A.10; the within-query subtree reuse is
ported, ``exec/reuse.py``); tracing, the event journal, metrics
snapshots, the compile cache and prewarm, and the serving caches (A.11);
the CSV and ORC readers (A.7). ``with_column`` and ``select`` take
window expressions (``F.row_number().over(Window.partition_by(...))``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.config.conf import FUSE_COUNT_DISTINCT, TpuConf
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.cpu import concat_host_frames
from spark_rapids_tpu_torch.sql import plan as lp
from spark_rapids_tpu_torch.sql.exprs.aggregates import find_aggregates
from spark_rapids_tpu_torch.sql.exprs.core import Alias, Col, Expression
from spark_rapids_tpu_torch.sql.functions import Column, SortOrder, _c, _expr
from spark_rapids_tpu_torch.sql.functions import col as col_fn
from spark_rapids_tpu_torch.sql.planner import Planner
from spark_rapids_tpu_torch.sql.sources import InMemorySource, ParquetSource

# join type aliases of DataFrame.join
_JOIN_ALIASES = {"outer": "full", "full_outer": "full", "left_outer": "left",
                 "right_outer": "right", "semi": "leftsemi",
                 "anti": "leftanti"}


class TpuSparkSession:
    """Entry point: confs, data sources and query execution."""

    def __init__(self, conf: TpuConf, device="cuda"):
        self.conf = conf
        self.device = device
        # the device scan cache (spark.rapids.sql.cacheDeviceScans)
        self.device_scan_cache: Dict = {}
        # each partial aggregate's measured reduction ratio, by plan
        # fingerprint (the runtime partial-aggregation skip)
        self.agg_ratio_cache: Dict[str, float] = {}
        # scanned integer columns' (min, max), unioned over every scanned
        # batch of that name: advisory bounds the dense join sizes its
        # table from and verifies on the device (exec/tpujoin.py)
        self.column_stats: Dict[str, tuple] = {}
        # alias -> {source column names} of rename-only projections, so
        # the statistics resolve through ``.alias(...)``
        self.column_aliases: Dict[str, set] = {}

    class Builder:
        def __init__(self):
            self._settings: Dict = {}
            self._device = "cuda"

        def config(self, key: str, value) -> "TpuSparkSession.Builder":
            self._settings[key] = value
            return self

        def device(self, device) -> "TpuSparkSession.Builder":
            self._device = device
            return self

        def get_or_create(self) -> "TpuSparkSession":
            return TpuSparkSession(TpuConf(self._settings), self._device)

    @staticmethod
    def builder() -> "TpuSparkSession.Builder":
        return TpuSparkSession.Builder()

    def set_conf(self, key: str, value) -> None:
        self.conf.set(key, value)

    def clear_device_cache(self) -> None:
        self.device_scan_cache.clear()

    # --- data --------------------------------------------------------------
    def create_dataframe(self, df: pd.DataFrame,
                         num_partitions: int = 1) -> "DataFrame":
        return DataFrame(self, lp.LogicalScan(InMemorySource(
            df, num_partitions)))

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 2) -> "DataFrame":
        if end is None:
            start, end = 0, start
        return DataFrame(self, lp.LogicalRange(start, end, step,
                                               num_partitions))

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    # --- execution ---------------------------------------------------------
    def physical_plan(self, logical: lp.LogicalPlan):
        """logical -> pruned -> CPU physical -> device rewrite."""
        from spark_rapids_tpu_torch.sql.overrides import (
            TpuOverrides, TransitionOverrides, assert_is_on_tpu,
        )
        from spark_rapids_tpu_torch.sql.pushdown import (
            annotate_scan_pruning, prune_filter_columns,
        )
        conf = self.conf
        self._note_rename_aliases(logical)
        logical = prune_filter_columns(logical)
        annotate_scan_pruning(logical)
        planner = Planner(conf)
        if isinstance(logical, lp.LogicalLimit):
            plan = planner.plan_collect_limit(logical)
        else:
            plan = planner.plan(logical)
        if conf.sql_enabled:
            overrides = TpuOverrides(conf)
            plan = TransitionOverrides(conf).apply(overrides.apply(plan))
            if conf.get_bool(FUSE_COUNT_DISTINCT.key,
                             FUSE_COUNT_DISTINCT.default):
                from spark_rapids_tpu_torch.exec.aggfuse import (
                    fuse_count_distinct,
                )
                plan = fuse_count_distinct(plan)
            from spark_rapids_tpu_torch.exec.reuse import (
                reuse_common_subtrees,
            )
            plan = reuse_common_subtrees(plan)
            if conf.test_enabled:
                assert_is_on_tpu(plan, conf,
                                 overrides.explain_text("NOT_ON_TPU"))
        return plan

    def _note_rename_aliases(self, logical: lp.LogicalPlan) -> None:
        for node in logical.walk():
            if isinstance(node, lp.LogicalProject):
                for out_name, e in node.exprs:
                    while isinstance(e, Alias):
                        e = e.children[0]
                    if isinstance(e, Col) and e.name != out_name:
                        self.column_aliases.setdefault(out_name, set()).add(
                            e.name)

    def _execute(self, logical: lp.LogicalPlan, collect: bool = True):
        """Plan and run ``logical``: the output pandas frames, or with
        ``collect=False`` the output partitions' DeviceBatches (for a
        device plan), the query up to its collect."""
        plan = self.physical_plan(logical)
        ctx = ExecContext(self.conf, self, self.device)
        return self._drain(plan, ctx, collect)

    def _drain(self, plan, ctx: ExecContext, collect: bool = True) -> list:
        outs = [x for part in plan.executed_partitions(ctx) for x in part()]
        if plan.columnar_output and collect:
            return [b.to_pandas() for b in outs]
        return outs


class DataFrameReader:
    """``session.read``: file sources (Parquet; CSV and ORC are ROADMAP
    A.7)."""

    def __init__(self, session: TpuSparkSession):
        self.session = session

    def parquet(self, *paths: str) -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalScan(ParquetSource(list(paths))))


class GroupedData:
    def __init__(self, df: "DataFrame", grouping_cols: Sequence):
        self.df = df
        self.grouping = grouping_cols

    def agg(self, *agg_cols: Column) -> "DataFrame":
        schema = self.df._plan.schema()
        child = self.df._plan
        grouping, computed = [], []
        for i, g in enumerate(self.grouping):
            e = _c(g)
            name = _name_of(e)
            base = e.children[0] if isinstance(e, Alias) else e
            if not isinstance(base, Col):
                # a computed key: pre-projected under an internal name when
                # its alias would shadow an input column
                iname = f"__grp{i}" if name in schema.names else name
                computed.append((iname, e))
                e = Col(iname)
            grouping.append((name, e))
        if computed:
            child = lp.LogicalProject(
                child, [(n, Col(n)) for n in schema.names] + computed)
        result_exprs = [(_name_of(_expr(c)), _expr(c)) for c in agg_cols]
        if any(getattr(fn, "is_distinct", False)
               for _, e in result_exprs for fn in find_aggregates(e)):
            return self._agg_with_distinct(child, grouping, result_exprs)
        results = [(n, Col(n)) for n, _ in grouping] + result_exprs
        return DataFrame(self.df.session,
                         lp.LogicalAggregate(child, grouping, results))

    def _agg_with_distinct(self, child, grouping, result_exprs
                           ) -> "DataFrame":
        """count(DISTINCT d) as two aggregations (the JAX package's
        rewrite): level 1 groups by keys + d, reducing every other
        aggregate to its update intermediates; level 2 groups by the keys,
        merging the intermediates and counting the now-unique d values."""
        from spark_rapids_tpu_torch.sql.exprs import aggregates as am
        fns, seen = [], set()
        for _, e in result_exprs:
            for fn in am.find_aggregates(e):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    fns.append(fn)
        dist = [fn for fn in fns if getattr(fn, "is_distinct", False)]
        dist_names = {repr(fn.children[0]) for fn in dist}
        if len(dist_names) > 1:
            raise NotImplementedError(
                "multiple DISTINCT aggregate column sets in one aggregation "
                f"are not supported: {sorted(dist_names)}")
        # both levels key columns by name: d is materialized as __dist
        names = child.schema().names
        child = lp.LogicalProject(
            child, [(n, Col(n)) for n in names]
            + [("__dist", dist[0].children[0])])
        l1_grouping = list(grouping) + [("__dist", Col("__dist"))]
        # reduction kind -> aggregate, for level 1 (update) and level 2
        # (merge); count_valid appears only on the update side
        kind_ctor = {
            "sum": am.Sum, "min": am.Min, "max": am.Max,
            "first": lambda e: am.First(e, False),
            "first_valid": lambda e: am.First(e, True),
            "last": lambda e: am.Last(e, False),
            "last_valid": lambda e: am.Last(e, True),
        }
        l1_results = [(n, Col(n)) for n, _ in l1_grouping]
        fn_level2 = {}
        pi = 0
        for fn in fns:
            if getattr(fn, "is_distinct", False):
                # d is unique within a level-2 group now: counting its
                # non-NULL rows is count(DISTINCT d)
                fn_level2[id(fn)] = am.Count(Col("__dist"))
                continue
            refs = []
            for (ukind, cidx), mkind in zip(fn.update_ops(), fn.merge_ops()):
                pname = f"__p{pi}"
                pi += 1
                arg = fn.children[cidx]
                l1_results.append((pname, am.Count(arg)
                                   if ukind == "count_valid"
                                   else kind_ctor[ukind](arg)))
                refs.append(kind_ctor[mkind](Col(pname)))
            fn_level2[id(fn)] = fn.finalize(refs, child.schema())
        level1 = lp.LogicalAggregate(child, l1_grouping, l1_results)

        def rewrite(e):
            if isinstance(e, am.AggregateFunction):
                return fn_level2[id(e)]
            return e.map_children(rewrite)

        l2_grouping = [(n, Col(n)) for n, _ in grouping]
        l2_results = list(l2_grouping) + [(n, rewrite(e))
                                          for n, e in result_exprs]
        return DataFrame(self.df.session,
                         lp.LogicalAggregate(level1, l2_grouping, l2_results))

    def count(self) -> "DataFrame":
        from spark_rapids_tpu_torch.sql import functions as F
        return self.agg(F.count("*").alias("count"))


def _name_of(e: Expression) -> str:
    if isinstance(e, (Alias, Col)):
        return e.name
    return repr(e)


class DataFrame:
    def __init__(self, session: TpuSparkSession, plan: lp.LogicalPlan):
        self.session = session
        self._plan = plan

    @property
    def schema(self) -> Schema:
        return self._plan.schema()

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    def select(self, *cols) -> "DataFrame":
        """Project ``cols``. Window expressions among them are computed
        first, by window operators under the projection (Spark's
        WindowExec shape), one per distinct partition and order spec."""
        from spark_rapids_tpu_torch.sql.window import WindowExpression
        exprs = [(_name_of(_c(c)), _c(c)) for c in cols]
        win_items = []

        def extract(e):
            if isinstance(e, WindowExpression):
                name = f"__w{len(win_items)}"
                win_items.append((name, e))
                return Col(name)
            return e.map_children(extract)

        exprs = [(n, extract(e)) for n, e in exprs]
        child = self._plan
        by_spec: Dict[str, list] = {}
        for name, w in win_items:
            key = repr((w.spec.partition_cols, w.spec.orders))
            by_spec.setdefault(key, []).append((name, w))
        for items in by_spec.values():
            child = lp.LogicalWindow(child, items)
        return DataFrame(self.session, lp.LogicalProject(child, exprs))

    def filter(self, condition: Column) -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalFilter(self._plan, _expr(condition)))

    def group_by(self, *cols) -> GroupedData:
        return GroupedData(self, cols)

    def agg(self, *agg_cols: Column) -> "DataFrame":
        return GroupedData(self, []).agg(*agg_cols)

    def order_by(self, *cols) -> "DataFrame":
        orders = [c if isinstance(c, SortOrder) else SortOrder(_c(c))
                  for c in cols]
        return DataFrame(self.session, lp.LogicalSort(self._plan, orders))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.LogicalLimit(self._plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session,
                         lp.LogicalUnion([self._plan, other._plan]))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None) -> "DataFrame":
        """Join. ``on`` names columns present on both sides (Spark's USING
        join: one output column per key); ``left_on``/``right_on`` pair
        differently named keys by position (the TPC-H shape: l_orderkey =
        o_orderkey). ``on=None`` with no keys is a cross join; a boolean
        ``Column`` ``on`` is a condition join over the combined columns
        (inner/cross). ``how``: inner, left, right, full, leftsemi,
        leftanti, cross, or their aliases."""
        how = _JOIN_ALIASES.get(how, how)

        def keyify(spec):
            if isinstance(spec, str):
                spec = [spec]
            return [col_fn(c).expr if isinstance(c, str) else _expr(c)
                    for c in spec]
        if left_on is not None or right_on is not None:
            if left_on is None or right_on is None:
                raise ValueError("join: left_on and right_on go together")
            lkeys, rkeys = keyify(left_on), keyify(right_on)
            if len(lkeys) != len(rkeys):
                raise ValueError("join: left_on/right_on length mismatch")
        elif on is None:
            lkeys, rkeys = [], []
            how = "cross"
        elif isinstance(on, Column):
            # an arbitrary boolean condition: the broadcast nested-loop
            # join
            return DataFrame(self.session, lp.LogicalJoin(
                self._plan, other._plan, how, [], [], condition=_expr(on)))
        elif isinstance(on, (str, list, tuple)):
            names = [on] if isinstance(on, str) else list(on)
            if how not in ("leftsemi", "leftanti"):
                return self._join_using(other, names, how)
            lkeys, rkeys = keyify(names), keyify(names)
        else:
            raise TypeError("join on must be a column name, a list of "
                            "names, or a boolean Column condition")
        return DataFrame(self.session, lp.LogicalJoin(
            self._plan, other._plan, how, lkeys, rkeys))

    def _join_using(self, other: "DataFrame", names, how: str
                    ) -> "DataFrame":
        """join(on=[k]) keeps ONE output column per key: the right side's
        keys are renamed, the join is positional, then one key column is
        re-emitted (the left value; the right one for a right join), as
        Spark resolves USING; a full join coalesces the two)."""
        from spark_rapids_tpu_torch.sql.exprs.conditional import Coalesce
        shared = (set(self.schema.names) & set(other.schema.names)) \
            - set(names)
        if shared:
            raise ValueError(
                "join(on=...) with non-key columns present on both sides is "
                f"ambiguous: {sorted(shared)}; alias or drop them first")
        rmap = {n: f"__rk_{n}" for n in names}
        right = other.select(*[
            col_fn(n).alias(rmap[n]) if n in rmap else col_fn(n)
            for n in other.schema.names])
        joined = DataFrame(self.session, lp.LogicalJoin(
            self._plan, right._plan, how, [col_fn(n).expr for n in names],
            [col_fn(rmap[n]).expr for n in names]))
        out = []
        for n in names:
            if how == "right":
                out.append(col_fn(rmap[n]).alias(n))
            elif how == "full":
                out.append(Column(Coalesce([col_fn(n).expr,
                                            col_fn(rmap[n]).expr])).alias(n))
            else:
                out.append(col_fn(n))
        out += [col_fn(n) for n in self.schema.names if n not in names]
        out += [col_fn(n) for n in other.schema.names if n not in names]
        return joined.select(*out)

    def with_column(self, name: str, c: Column) -> "DataFrame":
        """Add (or replace) the column ``name``, computed by ``c``; the
        other columns keep their order, and the new one goes last. A
        window expression appends its column through a window operator,
        and may not shadow an existing column."""
        from spark_rapids_tpu_torch.sql.window import WindowExpression
        e = _expr(c)
        if isinstance(e, WindowExpression):
            if name in self.schema.names:
                raise ValueError(f"window column {name!r} would shadow an "
                                 "existing column")
            return DataFrame(self.session,
                             lp.LogicalWindow(self._plan, [(name, e)]))
        exprs = [(n, col_fn(n).expr) for n in self.schema.names if n != name]
        exprs.append((name, e))
        return DataFrame(self.session, lp.LogicalProject(self._plan, exprs))

    withColumn = with_column

    def drop(self, *names: str) -> "DataFrame":
        dropped = set(names)
        return self.select(*[n for n in self.schema.names
                             if n not in dropped])

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return self.select(*[
            col_fn(n).alias(new) if n == old else col_fn(n)
            for n in self.schema.names])

    withColumnRenamed = with_column_renamed

    def distinct(self) -> "DataFrame":
        """Deduplicate rows (planned as a group-by over every column)."""
        exprs = [(n, col_fn(n).expr) for n in self.schema.names]
        return DataFrame(self.session,
                         lp.LogicalAggregate(self._plan, exprs, [
                             (n, col_fn(n).expr) for n in self.schema.names]))

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.LogicalRepartition(self._plan, n))

    def coalesce(self, n: int) -> "DataFrame":
        return DataFrame(self.session, lp.LogicalCoalesce(self._plan, n))

    # --- actions -----------------------------------------------------------
    def collect(self) -> pd.DataFrame:
        return concat_host_frames(self.session._execute(self._plan),
                                  self.schema)

    to_pandas = collect

    def collect_batches(self) -> List[DeviceBatch]:
        """The query up to its collect: the output DeviceBatches, still on
        the device (a plan whose root runs on the CPU gives frames)."""
        return self.session._execute(self._plan, collect=False)

    def explain(self, mode: str = "ALL") -> str:
        """The tag tree of the CPU plan: ``*`` on the device, ``!`` off it
        with the reason (spark.rapids.sql.explain)."""
        from spark_rapids_tpu_torch.sql.overrides import TpuOverrides
        overrides = TpuOverrides(self.session.conf)
        overrides.apply(Planner(self.session.conf).plan(self._plan))
        text = overrides.explain_text(mode)
        print(text)
        return text

