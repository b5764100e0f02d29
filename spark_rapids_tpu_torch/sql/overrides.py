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
feeding it on the same side. The window, generate and write rules wait
for later slices.
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
                 disabled_by_default: bool = False):
        self.cpu_class = cpu_class
        self.desc = desc
        self.tag_fn = tag_fn
        self.convert_fn = convert_fn
        self.disabled_by_default = disabled_by_default

    @property
    def conf_key(self) -> str:
        name = self.cpu_class.__name__.removeprefix("Cpu")
        return f"spark.rapids.sql.exec.{name}"


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
                self.rule.conf_key, self.rule.disabled_by_default):
            self.will_not_work(f"{self.plan.name} is disabled by conf "
                               f"{self.rule.conf_key}")
            return
        self.rule.tag_fn(self)

    def check_exprs(self, exprs: List[Expression], what: str,
                    schema=None) -> None:
        if schema is None:
            schema = (self.plan.children[0].output_schema()
                      if self.plan.children else self.plan.output_schema())
        for e in exprs:
            reason = first_unsupported(e, schema)
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
    if kind not in ("hash", "single", "range"):
        meta.will_not_work(
            f"partitioning {kind!r} needs the multi-partition device "
            "exchange, not ported yet")


def _tag_join(meta: ExecMeta) -> None:
    plan = meta.plan
    if plan.join_type not in tpujoin.SUPPORTED_JOIN_TYPES:
        meta.will_not_work(f"join type {plan.join_type!r} not supported "
                           "on the device")
    for side, keys in ((0, plan.left_keys), (1, plan.right_keys)):
        schema = plan.children[side].output_schema()
        for k in keys:
            if schema.dtypes[k].is_string:
                meta.will_not_work(
                    f"string join key {schema.names[k]}: the hash probe "
                    "takes numeric keys; string keys need the "
                    "union-lexsort probe (ROADMAP A.4)")


def _tag_bnlj(meta: ExecMeta) -> None:
    cond = meta.plan.condition
    if cond is not None:
        reason = first_unsupported(cond, meta.plan.output_schema())
        if reason:
            meta.will_not_work(f"join condition: {reason}")


def _tag_expand(meta: ExecMeta) -> None:
    for proj in meta.plan.projections:
        meta.check_exprs([e for _, e in proj], "expand projection")


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
_register(ExecRule(cpu.CpuScanExec, "columnar scan", _tag_nothing,
                   lambda m, ch: tpu.TpuScanExec(m.plan.source,
                                                 m.plan.output_schema())))
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


class TransitionOverrides:
    """Transitions at the CPU/device boundaries, then batch coalescing
    above fragmenting producers. The JAX package also runs its filter and
    selection fusion and the whole-stage compiler here (ROADMAP A.10);
    the port runs neither, so ``apply`` is ``insert_coalesce`` of the
    transitions."""

    def __init__(self, conf: TpuConf):
        self.conf = conf

    def apply(self, plan: PhysicalPlan) -> PhysicalPlan:
        return insert_coalesce(self._apply(plan), self.conf)

    def _apply(self, plan: PhysicalPlan) -> PhysicalPlan:
        new_children = []
        for c in plan.children:
            c2 = self._apply(c)
            if plan.columnar_output and not c2.columnar_output:
                c2 = HostToDeviceExec(c2)
            elif not plan.columnar_output and c2.columnar_output:
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
                        if not node.columnar_output
                        and node.name not in allowed})
    if offenders:
        raise AssertionError(
            f"operators did not run on the TPU: {offenders} "
            "(spark.rapids.sql.test.enabled=true)"
            + (f"\n{reasons}" if reasons else ""))
