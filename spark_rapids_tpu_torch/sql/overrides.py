"""The plan rewrite: tag, convert, insert transitions (counterpart of the
JAX package's ``sql/overrides.py``, with the rules of the operators this
slice ports).

  1. every CPU physical operator is wrapped in an ``ExecMeta``;
  2. ``tag()`` walks children first, gathering the reasons a node cannot
     run on the device (its per-operator conf key, expression support,
     the aggregate's string reductions);
  3. ``convert()`` replaces each cleanly tagged node with its ``Tpu*Exec``
     and leaves the rest on the CPU;
  4. ``TransitionOverrides`` inserts HostToDevice / DeviceToHost at every
     boundary and coalesces batches above fragmenting producers;
  5. ``explain_text()`` renders the tag tree: ``*`` on the device, ``!``
     off it with the reason.

Per-operator enable keys are ``spark.rapids.sql.exec.<Name>``; the
broadcast nested-loop join's rule is disabled by default, as in the JAX
package and the reference, and the cartesian product's is on (the JAX
package's deviation from the reference: TPC-H's scalar-subquery cross
joins would otherwise leave the device twice). After tagging, the
join-hash consistency fixup keeps a shuffled join and the exchanges
feeding it on the same side. The window rule tags each window column by
``exec/windowexec.resolve_descriptor`` and its expressions; the generate
rule keeps a regex or multi-byte delimiter on the CPU with the JAX
package's reasons. The scan rule keeps a file scan whose format is off
(``spark.rapids.sql.format.<fmt>.enabled`` and ``.read.enabled``) on the
CPU, and the write rule a write whose format is off (``.write.enabled``
for Parquet and ORC), with the JAX package's reasons. A write consumes
device batches (``columnar_input``) but outputs none.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from spark_rapids_tpu_torch.config.conf import TpuConf
from spark_rapids_tpu_torch.exec import cpu, tpu, tpujoin
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.exec.coalesce import insert_coalesce
from spark_rapids_tpu_torch.exec.transitions import (
    DeviceToHostExec, HostToDeviceExec,
)
from spark_rapids_tpu_torch.sql.exprs.core import (
    Expression, first_unsupported, walk,
)


class ExecRule:
    """(CPU exec class) -> its conversion and conf key."""

    def __init__(self, cpu_class: Type[PhysicalPlan], desc: str,
                 tag_fn: Callable[["ExecMeta"], None],
                 convert_fn: Callable[["ExecMeta", List[PhysicalPlan]],
                                      PhysicalPlan],
                 disabled_by_default: bool = False,
                 incompat: Optional[str] = None):
        self.cpu_class = cpu_class
        self.desc = desc
        self.tag_fn = tag_fn
        self.convert_fn = convert_fn
        self.disabled_by_default = disabled_by_default
        # why the operator's results may differ from the CPU's: such a
        # rule runs only under spark.rapids.sql.incompatibleOps.enabled
        # or its own key (no rule of either package is incompatible yet)
        self.incompat = incompat

    @property
    def conf_key(self) -> str:
        name = self.cpu_class.__name__.removeprefix("Cpu")
        return f"spark.rapids.sql.exec.{name}"


class ExprMeta:
    """Per-expression meta tree of the tag pass (the JAX package's
    ``ExprMeta``; reference: BaseExprMeta, RapidsMeta.scala:566-726):
    each node's own reason under ``conf``, so a caller can name the exact
    offending node. ``first_reason`` is ``first_unsupported``'s answer."""

    def __init__(self, expr: Expression, schema, conf=None):
        self.expr = expr
        reason = expr.device_supported_in(schema, conf)
        if reason is None and type(expr).eval_device is Expression.eval_device:
            reason = "has no TPU implementation"
        self.reason = reason
        self.children = [ExprMeta(c, schema, conf) for c in expr.children]

    @property
    def subtree_ok(self) -> bool:
        return self.reason is None and all(c.subtree_ok
                                           for c in self.children)

    def first_reason(self) -> Optional[str]:
        """The pre-order first failing node's message, worded as
        ``first_unsupported`` words it."""
        if self.reason is not None:
            if self.reason == "has no TPU implementation":
                return f"{self.expr.pretty_name} has no TPU implementation"
            return f"{self.expr.pretty_name}: {self.reason}"
        for c in self.children:
            r = c.first_reason()
            if r:
                return r
        return None

    def explain_lines(self, depth: int = 0) -> List[str]:
        marker = "*" if self.reason is None else "!"
        line = "  " * depth + f"{marker} <{self.expr.pretty_name}> " \
            f"{self.expr!r}"
        if self.reason:
            line += f"  <-- {self.reason}"
        out = [line]
        for c in self.children:
            out.extend(c.explain_lines(depth + 1))
        return out


class ExecMeta:
    """Wraps one CPU physical operator during tagging."""

    def __init__(self, plan: PhysicalPlan, rule: Optional[ExecRule],
                 conf: TpuConf, parent: Optional["ExecMeta"]):
        self.plan = plan
        self.rule = rule
        self.conf = conf
        self.parent = parent
        self.children: List[ExecMeta] = []
        self.reasons: List[str] = []
        # (label, expression) per expression that failed its check
        self.bad_exprs: List[tuple] = []

    def will_not_work(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return not self.reasons

    def tag(self) -> None:
        for c in self.children:
            c.tag()
        if self.rule is None:
            self.will_not_work(
                f"no TPU replacement rule for {self.plan.name}")
            return
        if not self.conf.is_operator_enabled(
                self.rule.conf_key,
                incompat=self.rule.incompat is not None,
                disabled_by_default=self.rule.disabled_by_default):
            extra = ""
            if self.rule.incompat and not self.conf.incompatible_ops_enabled:
                extra = (f" (incompatible: {self.rule.incompat}; enable with "
                         f"{self.rule.conf_key}=true or "
                         "spark.rapids.sql.incompatibleOps.enabled=true)")
            self.will_not_work(f"{self.plan.name} is disabled by conf "
                               f"{self.rule.conf_key}{extra}")
            return
        self.rule.tag_fn(self)

    def check_exprs(self, exprs: List[Expression], what: str,
                    schema=None) -> None:
        if schema is None:
            schema = (self.plan.children[0].output_schema()
                      if self.plan.children else self.plan.output_schema())
        for e in exprs:
            reason = first_unsupported(e, schema, self.conf)
            if reason:
                self.bad_exprs.append((what, e))
                self.will_not_work(f"{what}: {reason}")

    def convert(self) -> PhysicalPlan:
        new_children = [c.convert() for c in self.children]
        if self.can_run_on_tpu and self.rule is not None:
            return self.rule.convert_fn(self, new_children)
        import copy
        new = copy.copy(self.plan)
        new.children = new_children
        return new

    def explain_lines(self, depth: int = 0) -> List[str]:
        marker = "*" if self.can_run_on_tpu else "!"
        line = "  " * depth + f"{marker} {self.plan.describe()}"
        if self.reasons:
            line += "  <-- " + "; ".join(self.reasons)
        out = [line]
        for what, e in self.bad_exprs:
            out.append("  " * (depth + 1) + f"@{what}:")
            for node in walk(e):
                out.append("  " * (depth + 2) + f"<{node.pretty_name}> "
                           f"{node!r}")
        for c in self.children:
            out.extend(c.explain_lines(depth + 1))
        return out


# --- per-operator tag/convert functions -------------------------------------

def _tag_nothing(meta: ExecMeta) -> None:
    pass


def _tag_project(meta: ExecMeta) -> None:
    meta.check_exprs([e for _, e in meta.plan.exprs], "projection")


def _tag_filter(meta: ExecMeta) -> None:
    meta.check_exprs([meta.plan.condition], "filter condition")


# reductions a string column may feed on the device: count on every
# branch, min/max/first/last on the sorted-space branch (grouped) and the
# single-group one (global), over dictionary codes and char slabs
_STRING_RED_KINDS = ("count_valid", "min", "max", "first", "last",
                     "first_valid", "last_valid")


def _tag_agg(meta: ExecMeta) -> None:
    plan = meta.plan.plan  # AggPlan
    mode = meta.plan.mode
    replace = meta.conf.hash_agg_replace_mode
    if replace != "all" and replace != mode:
        meta.will_not_work(
            f"hashAgg replace mode {replace!r} excludes {mode} aggregation")
    schema = plan.child_schema
    for name, e in plan.grouping:
        meta.check_exprs([e], f"group key {name}", schema)
    for fn in plan.agg_fns:
        reason = fn.device_supported(schema)
        if reason:
            meta.will_not_work(reason)
        meta.check_exprs(fn.children, f"aggregate input of "
                         f"{fn.pretty_name}", schema)
    if mode == "final":
        for name, e in plan.finalize_exprs():
            meta.check_exprs([e], f"result {name}", plan.partial_schema)
    for ops in plan.update_plan:
        for kind, _input_idx, idt in ops:
            if idt.is_string and kind not in _STRING_RED_KINDS:
                meta.will_not_work(
                    f"{kind} over string values is not supported on TPU")


def _tag_sort(meta: ExecMeta) -> None:
    meta.check_exprs([o.expr for o in meta.plan.orders], "sort key")


def _tag_exchange(meta: ExecMeta) -> None:
    kind = meta.plan.partitioning[0]
    if kind not in ("hash", "single", "roundrobin", "range"):
        meta.will_not_work(f"partitioning {kind!r} not supported on TPU")


def _tag_join(meta: ExecMeta) -> None:
    plan = meta.plan
    if plan.join_type not in tpujoin.SUPPORTED_JOIN_TYPES:
        meta.will_not_work(f"join type {plan.join_type!r} not supported "
                           "on the device")
    for lk, rk in zip(plan.left_keys, plan.right_keys):
        lt = plan.children[0].output_schema().dtypes[lk]
        rt = plan.children[1].output_schema().dtypes[rk]
        if lt.is_string != rt.is_string:
            meta.will_not_work(f"join key types differ: {lt} and {rt}")


def _tag_bnlj(meta: ExecMeta) -> None:
    cond = meta.plan.condition
    if cond is not None:
        reason = first_unsupported(cond, meta.plan.output_schema(),
                                   meta.conf)
        if reason:
            meta.will_not_work(f"join condition: {reason}")


def _tag_expand(meta: ExecMeta) -> None:
    for proj in meta.plan.projections:
        meta.check_exprs([e for _, e in proj], "expand projection")


def _tag_window(meta: ExecMeta) -> None:
    from spark_rapids_tpu_torch.exec.windowexec import resolve_descriptor
    cs = meta.plan.children[0].output_schema()
    for name, w in meta.plan.window_exprs:
        _, vexpr, err = resolve_descriptor(w, cs)
        if err:
            meta.will_not_work(f"window column {name}: {err}")
            continue
        for e in (w.spec.partition_cols
                  + [o.expr for o in w.spec.orders]
                  + ([vexpr] if vexpr is not None else [])):
            reason = first_unsupported(e, cs, meta.conf)
            if reason:
                meta.will_not_work(f"window column {name}: {reason}")


def _convert_window(meta: ExecMeta, children) -> PhysicalPlan:
    from spark_rapids_tpu_torch.exec.windowexec import TpuWindowExec
    return TpuWindowExec(children[0], meta.plan.window_exprs)


_RULES: Dict[Type[PhysicalPlan], ExecRule] = {}


def _register(rule: ExecRule) -> None:
    _RULES[rule.cpu_class] = rule


_register(ExecRule(cpu.CpuProjectExec, "columnar projection", _tag_project,
                   lambda m, ch: tpu.TpuProjectExec(ch[0], m.plan.exprs)))
_register(ExecRule(cpu.CpuFilterExec, "columnar filter", _tag_filter,
                   lambda m, ch: tpu.TpuFilterExec(ch[0],
                                                   m.plan.condition)))
_register(ExecRule(cpu.CpuHashAggregateExec, "hash aggregate", _tag_agg,
                   lambda m, ch: tpu.TpuHashAggregateExec(
                       ch[0], m.plan.plan, m.plan.mode)))
_register(ExecRule(cpu.CpuSortExec, "device sort", _tag_sort,
                   lambda m, ch: tpu.TpuSortExec(ch[0], m.plan.orders)))
_register(ExecRule(cpu.CpuShuffleExchangeExec, "columnar shuffle exchange",
                   _tag_exchange,
                   lambda m, ch: tpu.TpuShuffleExchangeExec(
                       ch[0], m.plan.partitioning)))


def _tag_scan(meta: ExecMeta) -> None:
    from spark_rapids_tpu_torch.sql.sources import (
        CsvSource, InMemorySource, OrcSource, ParquetSource,
    )
    src = meta.plan.source
    c = meta.conf
    if isinstance(src, ParquetSource):
        if not (c.get("spark.rapids.sql.format.parquet.enabled")
                and c.get("spark.rapids.sql.format.parquet.read.enabled")):
            meta.will_not_work("Parquet scan disabled by conf")
    elif isinstance(src, CsvSource):
        if not (c.get("spark.rapids.sql.format.csv.enabled")
                and c.get("spark.rapids.sql.format.csv.read.enabled")):
            meta.will_not_work("CSV scan disabled by conf")
    elif isinstance(src, OrcSource):
        if not (c.get("spark.rapids.sql.format.orc.enabled")
                and c.get("spark.rapids.sql.format.orc.read.enabled")):
            meta.will_not_work("ORC scan disabled by conf")
    elif not isinstance(src, InMemorySource):
        meta.will_not_work(f"source {src.describe()} has no TPU scan")


_register(ExecRule(cpu.CpuScanExec, "columnar scan", _tag_scan,
                   lambda m, ch: tpu.TpuScanExec(
                       m.plan.source, m.plan.output_schema(),
                       m.plan.pushed_filters)))
_register(ExecRule(cpu.CpuExpandExec, "expand", _tag_expand,
                   lambda m, ch: tpu.TpuExpandExec(ch[0],
                                                   m.plan.projections)))
_register(ExecRule(cpu.CpuLocalLimitExec, "local limit", _tag_nothing,
                   lambda m, ch: tpu.TpuLocalLimitExec(ch[0], m.plan.limit)))
_register(ExecRule(cpu.CpuGlobalLimitExec, "global limit", _tag_nothing,
                   lambda m, ch: tpu.TpuGlobalLimitExec(ch[0],
                                                        m.plan.limit)))
_register(ExecRule(cpu.CpuCollectLimitExec, "collect limit", _tag_nothing,
                   lambda m, ch: tpu.TpuCollectLimitExec(ch[0],
                                                         m.plan.limit)))
_register(ExecRule(cpu.CpuCoalescePartitionsExec, "partition coalesce",
                   _tag_nothing,
                   lambda m, ch: tpu.TpuCoalescePartitionsExec(ch[0],
                                                               m.plan.n)))
_register(ExecRule(cpu.CpuUnionExec, "columnar union", _tag_nothing,
                   lambda m, ch: tpu.TpuUnionExec(ch)))
_register(ExecRule(cpu.CpuJoinExec, "shuffled hash join", _tag_join,
                   lambda m, ch: tpujoin.TpuShuffledHashJoinExec(
                       ch[0], ch[1], m.plan.join_type, m.plan.left_keys,
                       m.plan.right_keys)))
_register(ExecRule(cpu.CpuBroadcastHashJoinExec, "broadcast hash join",
                   _tag_join,
                   lambda m, ch: tpujoin.TpuBroadcastHashJoinExec(
                       ch[0], ch[1], m.plan.join_type, m.plan.left_keys,
                       m.plan.right_keys)))
_register(ExecRule(cpu.CpuCartesianProductExec, "cartesian product",
                   _tag_nothing,
                   lambda m, ch: tpujoin.TpuCartesianProductExec(ch[0],
                                                                 ch[1])))
_register(ExecRule(cpu.CpuBroadcastNestedLoopJoinExec,
                   "broadcast nested loop join", _tag_bnlj,
                   lambda m, ch: tpujoin.TpuBroadcastNestedLoopJoinExec(
                       ch[0], ch[1], m.plan.join_type, m.plan.condition),
                   disabled_by_default=True))
_register(ExecRule(cpu.CpuBroadcastExchangeExec, "broadcast exchange",
                   _tag_nothing,
                   lambda m, ch: tpujoin.TpuBroadcastExchangeExec(ch[0])))
_register(ExecRule(cpu.CpuRangeExec, "device range source", _tag_nothing,
                   lambda m, ch: tpu.TpuRangeExec(
                       m.plan.start, m.plan.end, m.plan.step,
                       m.plan.num_partitions, m.plan.col_name)))



def _register_window_rule() -> None:
    from spark_rapids_tpu_torch.exec.windowexec import CpuWindowExec
    _register(ExecRule(CpuWindowExec, "windowed computation", _tag_window,
                       _convert_window))


_register_window_rule()


def _tag_generate(meta: ExecMeta) -> None:
    plan = meta.plan
    cs = plan.children[0].output_schema()
    if not cs.dtypes[plan.col_idx].is_string:
        meta.will_not_work("explode source must be a string column")
    if len(plan.delim.encode("utf-8")) != 1:
        meta.will_not_work(
            f"delimiter {plan.delim!r}: only single-byte delimiters run on "
            "TPU (multi-byte/regex split stays on CPU)")
    elif plan.delim in "\\^$.|?*+()[]{}":
        meta.will_not_work(
            f"delimiter {plan.delim!r} is a regex metacharacter (Spark "
            "split() patterns are regexes); runs on CPU")


def _register_generate_rule() -> None:
    from spark_rapids_tpu_torch.exec.generate import (
        CpuGenerateExec, TpuGenerateExec,
    )
    _register(ExecRule(CpuGenerateExec, "explode-style generator",
                       _tag_generate,
                       lambda m, ch: TpuGenerateExec(
                           ch[0], m.plan.col_idx, m.plan.delim,
                           m.plan.out_name, m.plan.with_pos,
                           m.plan.pos_name)))


_register_generate_rule()


def _tag_write(meta: ExecMeta) -> None:
    c = meta.conf
    fmt = meta.plan.fmt
    if fmt == "parquet":
        if not (c.get("spark.rapids.sql.format.parquet.enabled")
                and c.get("spark.rapids.sql.format.parquet.write.enabled")):
            meta.will_not_work("Parquet write disabled by conf")
    elif fmt == "orc":
        if not (c.get("spark.rapids.sql.format.orc.enabled")
                and c.get("spark.rapids.sql.format.orc.write.enabled")):
            meta.will_not_work("ORC write disabled by conf")
    elif fmt == "csv":
        # the reference does not accelerate CSV writes either; this one
        # takes the same columnar copy to the host, so it is on by default
        if not c.get("spark.rapids.sql.format.csv.enabled"):
            meta.will_not_work("CSV write disabled by conf")
    else:
        meta.will_not_work(f"write format {fmt!r} has no TPU path")


def _register_write_rule() -> None:
    from spark_rapids_tpu_torch.exec.write import CpuWriteExec, TpuWriteExec
    _register(ExecRule(CpuWriteExec, "data writing command", _tag_write,
                       lambda m, ch: TpuWriteExec(
                           ch[0], m.plan.path, m.plan.fmt, m.plan.mode,
                           m.plan.partition_cols)))


_register_write_rule()


def _fixup_join_hash_consistency(meta: ExecMeta) -> None:
    """A shuffled join and the exchanges feeding it must agree on the
    partitioning: a join left on the CPU takes its exchanges along (it
    would read device-partitioned rows), and an exchange left on the CPU
    takes its join along."""
    for c in meta.children:
        _fixup_join_hash_consistency(c)
    # only a shuffled equi-join depends on the partitioning hash: a
    # broadcast join or a cartesian product reads its inputs' partitions
    # independently
    if (not isinstance(meta.plan, cpu.CpuJoinExec)
            or isinstance(meta.plan, (cpu.CpuBroadcastHashJoinExec,
                                      cpu.CpuCartesianProductExec))):
        return
    exchanges = [c for c in meta.children
                 if isinstance(c.plan, cpu.CpuShuffleExchangeExec)]
    if not exchanges:
        return
    if meta.can_run_on_tpu and any(not c.can_run_on_tpu for c in exchanges):
        meta.will_not_work(
            "an input exchange stays on CPU, so the join must use the "
            "CPU partitioning hash for consistency")
    if not meta.can_run_on_tpu:
        for c in exchanges:
            if c.can_run_on_tpu:
                c.will_not_work(
                    "the shuffled join it feeds stays on CPU, so the "
                    "partitioning hash must stay on CPU for consistency")


def _fixup_exchange_overhead(meta: ExecMeta) -> None:
    """An exchange with no columnar neighbour only adds two transitions
    around a shuffle: keep it on the CPU."""
    for c in meta.children:
        _fixup_exchange_overhead(c)
    if (not isinstance(meta.plan, cpu.CpuShuffleExchangeExec)
            or not meta.can_run_on_tpu):
        return
    parent_columnar = meta.parent is not None and meta.parent.can_run_on_tpu
    if not parent_columnar and not any(c.can_run_on_tpu
                                       for c in meta.children):
        meta.will_not_work(
            "columnar exchange between CPU operators only adds "
            "host<->device transition overhead")


class TpuOverrides:
    """The tag and convert pass over a CPU physical plan."""

    def __init__(self, conf: TpuConf):
        self.conf = conf
        self.root_meta: Optional[ExecMeta] = None

    def wrap(self, plan: PhysicalPlan,
             parent: Optional[ExecMeta] = None) -> ExecMeta:
        meta = ExecMeta(plan, _RULES.get(type(plan)), self.conf, parent)
        meta.children = [self.wrap(c, meta) for c in plan.children]
        return meta

    def apply(self, plan: PhysicalPlan) -> PhysicalPlan:
        self.root_meta = self.wrap(plan)
        self.root_meta.tag()
        _fixup_join_hash_consistency(self.root_meta)
        _fixup_exchange_overhead(self.root_meta)
        if self.conf.explain in ("ALL", "NOT_ON_TPU"):
            print(self.explain_text(self.conf.explain))
        return self.root_meta.convert()

    def explain_text(self, mode: str = "ALL") -> str:
        lines = self.root_meta.explain_lines()
        if mode == "NOT_ON_TPU":
            lines = [ln for ln in lines if ln.lstrip().startswith("!")]
        return "\n".join(lines)

    def fallback_metas(self) -> List[ExecMeta]:
        """Every tagged-off operator meta after apply(), pre-order: the
        machine-readable twin of the "!" explain lines, one
        ``cpuFallback`` journal event each (obs/events.py)."""
        assert self.root_meta is not None
        out: List[ExecMeta] = []
        stack = [self.root_meta]
        while stack:
            meta = stack.pop()
            if meta.reasons:
                out.append(meta)
            stack.extend(reversed(meta.children))
        return out


class TransitionOverrides:
    """postColumnarTransitions, in the JAX package's order: transitions
    at the CPU/device boundaries (``_apply``), the selection fusion and
    the filter->aggregate fusion (``exec/fusion.py``), batch coalescing
    above fragmenting producers (``insert_coalesce``) and, under
    ``spark.rapids.sql.fusion.stageEnabled``, the whole-stage cutter
    (``exec/stagecompiler``)."""

    def __init__(self, conf: TpuConf, session=None):
        self.conf = conf
        # the session the plan runs in: the cutter reads its exchanges'
        # routes (None outside a session)
        self.session = session

    def apply(self, plan: PhysicalPlan) -> PhysicalPlan:
        from spark_rapids_tpu_torch.exec.fusion import (
            fuse_filter_into_aggregate, fuse_selection_into_filter,
        )
        from spark_rapids_tpu_torch.exec.stagecompiler import compile_stages
        # fuse BEFORE coalesce insertion: a fused-away Filter is no longer
        # a fragmenting producer. Whole-stage fusion runs last, over the
        # final operator layout (coalesce nodes included: the stage
        # absorbs them), so the single-shot and AQE per-stage paths cut
        # identically.
        return compile_stages(
            insert_coalesce(
                fuse_filter_into_aggregate(
                    fuse_selection_into_filter(self._apply(plan),
                                               self.conf),
                    self.conf),
                self.conf),
            self.conf, self.session)

    def _apply(self, plan: PhysicalPlan) -> PhysicalPlan:
        # a terminal command that consumes device batches (a write) says
        # so by ``columnar_input``
        wants_columnar = getattr(plan, "columnar_input",
                                 plan.columnar_output)
        new_children = []
        for c in plan.children:
            c2 = self._apply(c)
            if wants_columnar and not c2.columnar_output:
                c2 = HostToDeviceExec(c2)
            elif not wants_columnar and c2.columnar_output:
                c2 = DeviceToHostExec(c2)
            new_children.append(c2)
        out = plan.map_children(lambda c: c)
        out.children = new_children
        return out


def assert_is_on_tpu(plan: PhysicalPlan, conf: TpuConf,
                     reasons: str = "") -> None:
    """Test mode (spark.rapids.sql.test.enabled): fail the query if an
    operator outside the allowed list stayed on the CPU (every device
    operator, the joins and the broadcast exchange included, has columnar
    output). ``reasons``: the tag tree's fallback lines, for the
    message."""
    allowed = set(conf.test_allowed_nontpu) | {"HostToDeviceExec",
                                               "DeviceToHostExec"}
    offenders = sorted({node.name for node in plan.walk()
                        if not (node.columnar_output
                                or getattr(node, "columnar_input", False))
                        and node.name not in allowed})
    if offenders:
        raise AssertionError(
            f"operators did not run on the TPU: {offenders} "
            "(spark.rapids.sql.test.enabled=true)"
            + (f"\n{reasons}" if reasons else ""))
