"""TpuFusedStageExec: one composed per-batch function per fused operator
pipeline (counterpart of the JAX package's
``exec/stagecompiler/fusedexec.py``).

The fused stage holds its member operators (bottom-up execution order)
and applies each member's per-batch device function in sequence: one
Python dispatch a batch, with no operator iterators, per-operator
bookkeeping or wrapper generators between the members. The JAX package
traces the same composition into one XLA program; eager PyTorch runs the
members' ops as they come (a CUDA graph of a fused stage, which would
need static input and output buffers, is a later ROADMAP item).

Members are restricted to deterministic operators whose per-batch work
is a pure batch -> batch function: TpuProjectExec, TpuFilterExec and
TpuCoalesceBatchesExec (absorbed: the bottom-most coalesce's goal becomes
the stage's INPUT re-batching, the topmost interior one's its OUTPUT
re-batching). Anything else (exchanges, joins, aggregates, scans,
transitions, CPU fallbacks, nondeterministic expressions) is a stage
boundary (``cutter.py``).

Observability: ``describe()`` names the member pipeline (profile tree,
progress records, plan digests), ``fingerprint_extra`` carries every
member's identity (reuse dedup and capacity speculation key on it), and a
failure emits a ``fusedStageFailure`` event naming the member pipeline
(captured by the always-on flight recorder) and re-raises with the
pipeline in the message.
"""

from __future__ import annotations

from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)


def member_fn(node: PhysicalPlan):
    """(batch -> batch device function, signature) of one fusible member,
    or (None, signature) for an absorbed coalesce. Raises TypeError on a
    non-fusible node: the cutter never hands one over."""
    from spark_rapids_tpu_torch.exec import tpu as tpuexec
    from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec
    if isinstance(node, TpuCoalesceBatchesExec):
        return None, f"coalesce|{node.goal!r}"
    if isinstance(node, tpuexec.TpuProjectExec) and not node._impure:
        sig = "project|" + "|".join(f"{n}={e!r}" for n, e in node.exprs)
        return node._project, sig
    if isinstance(node, tpuexec.TpuFilterExec) and not node._impure:
        out_sel = node.out_sel
        sel_sig = ("" if out_sel is None
                   else f"|sel={tuple(out_sel[1])}"
                        f":{','.join(out_sel[0])}")
        # the node's own per-batch function: one filter spelling for the
        # standalone and fused paths
        return node._filter, f"filter|{node.condition!r}{sel_sig}"
    raise TypeError(f"not fusible: {node.describe()}")


class TpuFusedStageExec(PhysicalPlan):
    """One fused pipeline of member operators as a single plan node.

    ``members`` is bottom-up (execution order): members[0] consumes the
    stage input, members[-1] produces the stage output."""

    columnar_output = True

    def __init__(self, child: PhysicalPlan, members: List[PhysicalPlan]):
        super().__init__([child])
        from spark_rapids_tpu_torch.exec.coalesce import (
            TpuCoalesceBatchesExec,
        )
        self.members = list(members)
        self.member_ops = [m.describe() for m in self.members]
        self.input_goal = None
        # an absorbed INTERIOR coalesce must not silently fragment the
        # consumer: the TOPMOST interior coalesce's goal re-batches the
        # stage OUTPUT (filters and projects keep capacity, so the
        # grouping matches what the interior coalesce would have made)
        self.output_goal = None
        fns, sigs = [], []
        for i, m in enumerate(self.members):
            fn, sig = member_fn(m)
            if fn is None:
                if isinstance(m, TpuCoalesceBatchesExec):
                    if i == 0:
                        # the bottom coalesce keeps its re-batching role
                        # at the stage input
                        self.input_goal = m.goal
                    else:
                        self.output_goal = m.goal
                continue
            fns.append(fn)
            sigs.append(sig)
        self._fns = fns
        self._sig = "fusedstage|" + "|".join(sigs)

    def _kernel(self, batch: DeviceBatch) -> DeviceBatch:
        """The members' functions composed: one call a batch."""
        for fn in self._fns:
            batch = fn(batch)
        return batch

    # -- plan-node surface ---------------------------------------------------
    def output_schema(self) -> Schema:
        return self.members[-1].output_schema()

    def describe(self) -> str:
        shorts = [m.describe().split("(", 1)[0] for m in self.members]
        return f"TpuFusedStageExec([{' -> '.join(shorts)}])"

    def fingerprint_extra(self) -> str:
        # full member identity: the fused node is as precise as its
        # members were (reuse dedup and capacity speculation key on
        # describe() + fingerprint_extra)
        parts = [f"{m.describe()}#{m.fingerprint_extra()}"
                 for m in self.members]
        return (f"goal={self.input_goal!r}|out={self.output_goal!r}|"
                + ";".join(parts))

    # -- execution -----------------------------------------------------------
    def _pipeline_label(self) -> str:
        return " -> ".join(
            m.describe().split("(", 1)[0] for m in self.members)

    def _note_failure(self, e: BaseException) -> None:
        """A failure inside the fused stage names the member pipeline, not
        just this node: the event lands in the always-on flight recorder,
        so the failure dump carries it."""
        from spark_rapids_tpu_torch.obs.events import EVENTS
        EVENTS.emit("fusedStageFailure", op=self.describe()[:200],
                    members=[m[:200] for m in self.member_ops],
                    error=f"{type(e).__name__}: {e}"[:300])

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.coalesce import coalesce_iter
        from spark_rapids_tpu_torch.exec.tpu import device_manager_of
        child_parts = self.children[0].executed_partitions(ctx)
        growth = ctx.conf.capacity_growth
        in_schema = self.children[0].output_schema()
        goal = self.input_goal
        out_goal = self.output_goal
        out_schema = self.output_schema()
        dm = device_manager_of(ctx)

        def input_batches(part: Partition) -> Iterator[DeviceBatch]:
            if goal is None:
                return part()
            # coarse re-batching: tail fragments pad onto the
            # shape-bucket ladder (compile.shapeBuckets; the identity
            # when off)
            return coalesce_iter(part(), goal, in_schema, growth,
                                 ctx.device, dm, coarse=True)

        def make(part: Partition) -> Partition:
            def fused_outputs() -> Iterator[DeviceBatch]:
                for batch in input_batches(part):
                    try:
                        out = self._kernel(batch)
                    except Exception as e:  # noqa: BLE001
                        self._note_failure(e)
                        raise RuntimeError(
                            f"fused stage [{self._pipeline_label()}] "
                            f"failed: {e}") from e
                    yield out

            def run() -> Iterator[DeviceBatch]:
                if out_goal is None:
                    return fused_outputs()
                return coalesce_iter(fused_outputs(), out_goal, out_schema,
                                     growth, ctx.device, dm)
            return run
        return [make(p) for p in child_parts]
