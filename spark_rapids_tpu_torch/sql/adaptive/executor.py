"""The adaptive execution loop (counterpart of the JAX package's
``sql/adaptive/executor.py``).

Loop (Spark's AdaptiveSparkPlanExec.getFinalPhysicalPlan shape):

  1. find a *ready* stage boundary, a hash shuffle exchange whose subtree
     holds no other hash exchange, preferring build sides of joins so a
     small measured build can demote the join before the stream side's
     shuffle ever runs;
  2. finalize reads inside that subtree (earlier stages it consumes),
     convert it through the full rewrite engine (the session's
     ``_convert_cpu``: TpuOverrides, TransitionOverrides with the
     fusions, the fused count distinct and, under
     ``spark.rapids.sql.reuseSubtrees.enabled``, subtree reuse, applied
     per query stage) and call the converted exchange's
     ``materialize_stage`` (one counted ``aqe.stageFetch`` sync a device
     stage);
  3. replace the exchange with a ``ShuffleStageRef`` and re-optimize the
     remainder (dynamic broadcast conversion);
  4. repeat until no boundaries remain, then plan the remaining reads
     (joint coalescing and skew splits), convert the final stage and
     drain.

Capacity speculation is forced off for adaptive queries (the session's
``_run_adaptive``): stage materializations are statistics barriers, the
very syncs speculation exists to avoid, and a speculative re-execution
would invalidate the statistics its own re-planning read. Under
``spark.rapids.tpu.serving.exchangeReuse.enabled`` a stage whose exchange
subtree matches one an earlier query materialized
(``serving/caches.exchange_reuse_key``: structure, source versions, conf)
is adopted from the session's ``ExchangeReuseCache`` instead (an
``exchangeReuse`` decision, an ``aqeExchangeReuse`` event), and every
fresh keyed stage is offered to it at the query's end; the cache holds a
reference of its own, so the query's release leaves the frames it keeps.
The per-stage ``compiles``/``compileSeconds`` fields report the nvcc
builds a stage triggered (``utils/kernelcache.cache_snapshot``), normally
none.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.exec import cpu
from spark_rapids_tpu_torch.exec.base import ExecContext, PhysicalPlan
from spark_rapids_tpu_torch.sql.adaptive import rules
from spark_rapids_tpu_torch.sql.adaptive.stages import (
    AqeShuffleReadExec, CoalescedSpec, ShuffleStage, ShuffleStageRef,
)


def _is_stage_boundary(node: PhysicalPlan) -> bool:
    return (isinstance(node, cpu.CpuShuffleExchangeExec)
            and node.partitioning[0] == "hash")


def has_adaptive_stages(plan: PhysicalPlan) -> bool:
    """Is there anything for AQE to do? (No hash exchange: the
    single-shot path is already the plan.)"""
    return any(_is_stage_boundary(n) for n in plan.walk())


def _replace_node(plan: PhysicalPlan, target: PhysicalPlan,
                  repl: PhysicalPlan) -> PhysicalPlan:
    if plan is target:
        return repl
    changed = False
    new_children = []
    for c in plan.children:
        nc = _replace_node(c, target, repl)
        changed = changed or nc is not c
        new_children.append(nc)
    if not changed:
        return plan
    out = copy.copy(plan)
    out.children = new_children
    return out


class AdaptiveExecutor:
    def __init__(self, session, conf, ctx: ExecContext):
        self.session = session
        self.conf = conf
        self.ctx = ctx
        self.stages: List[ShuffleStage] = []
        self.decisions: List[dict] = []
        self._stage_counter = 0
        # cross-query exchange reuse (serving/caches.py, opt-in): adopt a
        # materialized stage whose subtree matches instead of running it,
        # and offer fresh stages back
        self._exchange_cache = None
        from spark_rapids_tpu_torch.serving import caches as sc
        if conf.get_bool(sc.EXCHANGE_REUSE_ENABLED, False):
            self._exchange_cache = \
                session._serving_bundle().exchange_cache

    # -- stage discovery ----------------------------------------------------
    def _next_ready_exchange(self, plan: PhysicalPlan
                             ) -> Optional[PhysicalPlan]:
        """First ready boundary, build sides of joins first (a measured
        build side can demote the join and elide the stream shuffle)."""
        ready: List[Tuple[PhysicalPlan, Optional[PhysicalPlan]]] = []

        def rec(node: PhysicalPlan, parent: Optional[PhysicalPlan]) -> None:
            for c in node.children:
                rec(c, node)
            if _is_stage_boundary(node) and not any(
                    _is_stage_boundary(d)
                    for c in node.children for d in c.walk()):
                ready.append((node, parent))
        rec(plan, None)
        if not ready:
            return None
        for node, parent in ready:
            if (type(parent) is cpu.CpuJoinExec
                    and len(parent.children) == 2):
                build_idx = 0 if parent.join_type == "right" else 1
                if parent.children[build_idx] is node:
                    return node
        return ready[0][0]

    # -- stage materialization ----------------------------------------------
    def _materialize(self, exchange: PhysicalPlan) -> ShuffleStage:
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        from spark_rapids_tpu_torch.obs.shuffleobs import record_shuffle_skew
        from spark_rapids_tpu_torch.obs.syncledger import SYNC_LEDGER
        from spark_rapids_tpu_torch.obs.trace import TRACER
        from spark_rapids_tpu_torch.utils.kernelcache import cache_snapshot
        self._stage_counter += 1
        sid = self._stage_counter
        prog = self.ctx.progress  # live stage view (obs/progress.py)
        # cross-query exchange reuse: a cached stage of the same subtree
        # (stage refs substituted, source-versioned, conf-fingerprinted)
        # is adopted with its map output and statistics, and nothing
        # below runs
        reuse_key = None
        if self._exchange_cache is not None:
            from spark_rapids_tpu_torch.serving.caches import (
                exchange_reuse_key,
            )
            reuse_key = exchange_reuse_key(exchange, self.conf)
            adopted = self._exchange_cache.get(
                reuse_key, tenant=self.session._job_group[0])
            if adopted is not None:
                self.stages.append(adopted)  # retained by the get
                decision = {"rule": "exchangeReuse", "stage": sid,
                            "reusedFrom": adopted.uid,
                            "totalBytes": int(adopted.total_bytes),
                            "partitions": adopted.stats.num_partitions}
                self._note(decision, "aqeExchangeReuse",
                           counter="aqe.exchangeReuses")
                if prog is not None:
                    prog.aqe_stage_done(
                        sid, partitions=adopted.stats.num_partitions,
                        maps=adopted.stats.num_maps,
                        totalBytes=adopted.stats.total_bytes,
                        reused=True, compiles=0, compileSeconds=0.0)
                return adopted
        if prog is not None:
            prog.aqe_stage_running(sid)
        prepared = self._finalize_reads(exchange)
        converted = self._convert(prepared)
        assert hasattr(converted, "materialize_stage"), (
            "stage root must stay the exchange after conversion, got "
            f"{converted.describe()}")
        # build-cache and sync-ledger watermarks: the nvcc builds and the
        # host syncs this stage's materialization paid
        builds0 = cache_snapshot()
        sync0 = SYNC_LEDGER.seq
        with TRACER.span("AqeStage", stage=sid):
            map_outputs, stats = converted.materialize_stage(self.ctx)
        builds1 = cache_snapshot()
        n_compiles = builds1["misses"] - builds0["misses"]
        compile_s = round(builds1["seconds"] - builds0["seconds"], 4)
        stage_syncs = SYNC_LEDGER.entries(since_seq=sync0)
        sync_s = round(sum(e["seconds"] for e in stage_syncs), 4)
        stage = ShuffleStage(sid, exchange.output_schema(),
                             exchange.partitioning, map_outputs, stats)
        stage.reuse_key = reuse_key
        self.stages.append(stage)
        if prog is not None:
            prog.aqe_stage_done(sid, partitions=stats.num_partitions,
                                maps=stats.num_maps,
                                totalBytes=stats.total_bytes,
                                compiles=n_compiles,
                                compileSeconds=compile_s,
                                syncs=len(stage_syncs),
                                syncSeconds=sync_s)
        REGISTRY.counter("aqe.stages").add(1)
        EVENTS.emit("aqeStageStats", stage=sid,
                    partitions=stats.num_partitions, maps=stats.num_maps,
                    totalBytes=stats.total_bytes,
                    maxBytes=stats.max_bytes(),
                    medianBytes=stats.median_bytes(),
                    rows=sum(stats.rows_by_partition or []),
                    compiles=n_compiles, compileSeconds=compile_s,
                    syncs=len(stage_syncs), syncSeconds=sync_s)
        record_shuffle_skew(stats.bytes_by_partition,
                            source=f"aqe:stage-{sid}")
        return stage

    # -- runtime rules ------------------------------------------------------
    def _apply_broadcast_demotion(self, node: PhysicalPlan) -> PhysicalPlan:
        new = copy.copy(node)
        new.children = [self._apply_broadcast_demotion(c)
                        for c in node.children]
        threshold = self.conf.broadcast_threshold
        if (type(new) is not cpu.CpuJoinExec
                or not self.conf.adaptive_broadcast_enabled
                or threshold < 0 or new.join_type == "full"):
            return new
        left_ok, right_ok = rules.broadcast_sides(new.join_type)
        candidates = []
        for side, ok in ((0, left_ok), (1, right_ok)):
            ch = new.children[side]
            if (ok and isinstance(ch, ShuffleStageRef)
                    and ch.stage.total_bytes <= threshold):
                candidates.append((ch.stage.total_bytes, side))
        if not candidates:
            return new
        measured, side = min(candidates)
        stage = new.children[side].stage
        build = cpu.CpuBroadcastExchangeExec(AqeShuffleReadExec(
            stage, [CoalescedSpec(tuple(range(stage.n_partitions)))]))
        stream = new.children[1 - side]
        elided = False
        if _is_stage_boundary(stream):
            # the stream side's shuffle has not run: a broadcast join
            # consumes arbitrary stream partitions, so skip it entirely
            stream = stream.children[0]
            elided = True
        children = [build, stream] if side == 0 else [stream, build]
        out = cpu.CpuBroadcastHashJoinExec(
            children[0], children[1], new.join_type,
            new.left_keys, new.right_keys)
        decision = {"rule": "broadcastDemotion", "stage": stage.id,
                    "joinType": new.join_type,
                    "side": "left" if side == 0 else "right",
                    "measuredBytes": int(measured),
                    "threshold": int(threshold),
                    "elidedStreamShuffle": elided}
        self._note(decision, "aqeBroadcastDemote",
                   counter="aqe.broadcastDemotions")
        return out

    def _finalize_reads(self, node: PhysicalPlan) -> PhysicalPlan:
        """Replace every ShuffleStageRef with a spec'd reader. Shuffled
        joins plan both sides jointly (combined coalescing + skew); every
        other consumer coalesces solo."""
        if isinstance(node, ShuffleStageRef):
            pre = len(self.decisions)
            specs = rules.solo_specs(node.stage, self.conf, self.decisions)
            self._flush_decisions(pre)
            return AqeShuffleReadExec(node.stage, specs)
        if (type(node) is cpu.CpuJoinExec
                and len(node.children) == 2
                and isinstance(node.children[0], ShuffleStageRef)
                and isinstance(node.children[1], ShuffleStageRef)):
            pre = len(self.decisions)
            lspecs, rspecs = rules.join_specs(
                node.children[0].stage, node.children[1].stage,
                node.join_type, self.conf, self.decisions)
            self._flush_decisions(pre)
            out = copy.copy(node)
            out.children = [
                AqeShuffleReadExec(node.children[0].stage, lspecs),
                AqeShuffleReadExec(node.children[1].stage, rspecs)]
            return out
        out = copy.copy(node)
        out.children = [self._finalize_reads(c) for c in node.children]
        return out

    def _flush_decisions(self, start: int) -> None:
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        prog = self.ctx.progress
        for d in self.decisions[start:]:
            kind = {"coalesce": "aqeCoalesce",
                    "skewSplit": "aqeSkewSplit"}.get(d["rule"])
            if kind:
                EVENTS.emit(kind, **d)
                REGISTRY.counter(
                    "aqe.coalescedReads" if d["rule"] == "coalesce"
                    else "aqe.skewSplits").add(1)
                if prog is not None:
                    prog.aqe_decision(d)

    def _note(self, decision: dict, kind: str, counter: str) -> None:
        from spark_rapids_tpu_torch.obs.events import EVENTS
        from spark_rapids_tpu_torch.obs.metrics import REGISTRY
        self.decisions.append(decision)
        EVENTS.emit(kind, **decision)
        REGISTRY.counter(counter).add(1)
        prog = self.ctx.progress
        if prog is not None:
            prog.aqe_decision(decision)

    # -- conversion / drain -------------------------------------------------
    def _convert(self, plan: PhysicalPlan) -> PhysicalPlan:
        """The session's per-query rewrite pipeline, applied per stage,
        with a cpuFallback event per operator left on the CPU."""
        if not self.conf.sql_enabled:
            return plan
        from spark_rapids_tpu_torch.obs.events import EVENTS
        out, overrides = self.session._convert_cpu(plan)
        for meta in overrides.fallback_metas():
            EVENTS.emit("cpuFallback", op=meta.plan.name,
                        describe=meta.plan.describe()[:200],
                        reasons=list(meta.reasons))
        return out

    # -- the loop -----------------------------------------------------------
    def execute(self, cpu_plan: PhysicalPlan, collect: bool = True):
        """Run ``cpu_plan`` adaptively; returns (final physical plan,
        outputs). The final plan is the runtime-re-planned one: its digest
        in the final queryPlan event differs from the static shape exactly
        when a rule fired."""
        plan = cpu_plan
        prog = self.ctx.progress
        if prog is not None:
            prog.aqe_begin(sum(1 for n in cpu_plan.walk()
                               if _is_stage_boundary(n)))
        try:
            while True:
                exchange = self._next_ready_exchange(plan)
                if exchange is None:
                    break
                stage = self._materialize(exchange)
                plan = _replace_node(plan, exchange,
                                     ShuffleStageRef(stage))
                plan = self._apply_broadcast_demotion(plan)
            plan = self._finalize_reads(plan)
            final = self._convert(plan)
            outs = self.session._drain(final, self.ctx, collect)
        finally:
            # stage outputs are per-query host materializations: a failed
            # query must not pin them. With exchange reuse on, fresh keyed
            # stages are offered to the cache first (it takes a reference
            # of its own); this query's reference drops either way.
            if self._exchange_cache is not None:
                from spark_rapids_tpu_torch.serving.caches import (
                    EXCHANGE_REUSE_MAX_BYTES,
                )
                max_bytes = int(self.conf.get(EXCHANGE_REUSE_MAX_BYTES,
                                              256 << 20))
                for st in self.stages:
                    if st.reuse_key is not None:
                        self._exchange_cache.put(st.reuse_key, st,
                                                 max_bytes)
            for st in self.stages:
                st.release()
        self.session.last_aqe = {
            "stages": len(self.stages),
            "decisions": list(self.decisions),
            "planChanged": bool(self.decisions),
            "plan": final.tree_string(),
        }
        return final, outs
