"""Query stages and stage readers (counterpart of the JAX package's
``sql/adaptive/stages.py``).

A **ShuffleStage** is one materialized hash exchange: the map side ran to
completion, its output sits partitioned on the host (per map task, per
reduce partition) and its ``MapOutputStatistics`` drove the re-planning
rules. The not-yet-executed remainder of the plan references the stage
through ``ShuffleStageRef`` placeholders until read planning replaces
them with ``AqeShuffleReadExec`` leaves carrying partition *specs*:

  * ``CoalescedSpec(pids)``          — reduce partitions merged into one
    task (Spark's CoalescedPartitionSpec);
  * ``PartialSpec(pid, lo, hi)``     — one reduce partition restricted to
    the map range [lo, hi): a skew-split sub-partition (Spark's
    PartialReducerPartitionSpec).

``AqeShuffleReadExec`` is a CPU leaf (host frames); the rewrite engine
converts it to ``TpuAqeShuffleReadExec``, which re-uploads each spec's
merged frame through the shared upload runner
(``exec/transitions.upload_frames``, the path HostToDeviceExec rides): the
stage boundary is a real host materialization point, the engine's
analogue of the reference registering map output in the shuffle catalog.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator, List, Sequence

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.sql.adaptive.stats import MapOutputStatistics


class CoalescedSpec:
    """Read these reduce partitions, fully, merged as one task."""

    __slots__ = ("pids",)

    def __init__(self, pids: Sequence[int]):
        self.pids = tuple(pids)

    def __repr__(self) -> str:
        return f"coalesce{list(self.pids)}"


class PartialSpec:
    """Read ONE reduce partition's output from map tasks [lo, hi): a
    skew-split sub-partition; the join's other side replicates the full
    partition against every sub-range."""

    __slots__ = ("pid", "map_lo", "map_hi")

    def __init__(self, pid: int, map_lo: int, map_hi: int):
        self.pid = pid
        self.map_lo = map_lo
        self.map_hi = map_hi

    def __repr__(self) -> str:
        return f"skew(p{self.pid}, maps[{self.map_lo}:{self.map_hi}])"


class ShuffleStage:
    """One materialized shuffle stage's output and statistics.

    Reference-counted, as in the JAX package, whose cross-query exchange
    reuse (serving caches, A.11) takes references too: the creating query
    holds the initial reference (``retain`` takes another) and
    ``release`` frees the host frames only when the last reference
    drops."""

    _uids = itertools.count(1)

    def __init__(self, stage_id: int, schema: Schema,
                 partitioning, map_outputs: List[List[pd.DataFrame]],
                 stats: MapOutputStatistics):
        self.id = stage_id
        self.schema = schema
        self.partitioning = partitioning
        self.map_outputs = map_outputs
        self.stats = stats
        # process-unique identity (ids recycle; uids never do) and the
        # cross-query reuse key (None: not offered)
        self.uid = next(ShuffleStage._uids)
        self.reuse_key = None
        self._refs = 1
        self._ref_lock = threading.Lock()

    @property
    def n_partitions(self) -> int:
        return self.partitioning[-1]

    @property
    def num_maps(self) -> int:
        return len(self.map_outputs)

    @property
    def total_bytes(self) -> int:
        return self.stats.total_bytes

    def frames_for(self, spec) -> List[pd.DataFrame]:
        if self.map_outputs is None:
            raise RuntimeError(
                f"stage {self.id} already released (stage outputs free "
                "at query end)")
        out: List[pd.DataFrame] = []
        if isinstance(spec, PartialSpec):
            for m in range(spec.map_lo, spec.map_hi):
                f = self.map_outputs[m][spec.pid]
                if len(f):
                    out.append(f)
            return out
        for m in range(len(self.map_outputs)):
            for pid in spec.pids:
                f = self.map_outputs[m][pid]
                if len(f):
                    out.append(f)
        return out

    def retain(self) -> None:
        """Take one reference."""
        with self._ref_lock:
            self._refs += 1

    def release(self) -> None:
        """Drop one reference; the materialized host frames free when the
        LAST reference drops (the executed plan outlives the query in
        ``session.last_plan``; only the statistics are needed after)."""
        with self._ref_lock:
            self._refs -= 1
            if self._refs > 0:
                return
            self.map_outputs = None


class ShuffleStageRef(PhysicalPlan):
    """Plan placeholder for a materialized stage, replaced by an
    ``AqeShuffleReadExec`` once its consumer's partition specs are
    decided. Never executes."""

    def __init__(self, stage: ShuffleStage):
        super().__init__()
        self.stage = stage

    def output_schema(self) -> Schema:
        return self.stage.schema

    def describe(self) -> str:
        return f"ShuffleStageRef(#{self.stage.id})"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        raise RuntimeError(
            "ShuffleStageRef executed before read planning: the adaptive "
            "executor must finalize reads first (sql/adaptive/executor.py)")


class AqeShuffleReadExec(PhysicalPlan):
    """Leaf reader over a materialized stage: one output partition per
    spec (Spark's AQEShuffleReadExec over a ShuffleQueryStage)."""

    def __init__(self, stage: ShuffleStage, specs: List):
        super().__init__()
        self.stage = stage
        self.specs = list(specs)

    def output_schema(self) -> Schema:
        return self.stage.schema

    def describe(self) -> str:
        merged = sum(1 for s in self.specs
                     if isinstance(s, CoalescedSpec) and len(s.pids) > 1)
        skews = sum(1 for s in self.specs if isinstance(s, PartialSpec))
        return (f"AqeShuffleReadExec(stage=#{self.stage.id}, "
                f"parts={len(self.specs)}, coalesced={merged}, "
                f"skewSplits={skews})")

    def fingerprint_extra(self) -> str:
        return f"stage{self.stage.id}|{self.specs!r}"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.cpu import concat_host_frames
        schema = self.stage.schema

        def make(spec) -> Partition:
            def run() -> Iterator[pd.DataFrame]:
                yield concat_host_frames(self.stage.frames_for(spec),
                                         schema)
            return run
        return [make(s) for s in self.specs]


class TpuAqeShuffleReadExec(PhysicalPlan):
    """Columnar stage reader: each spec's merged host frame re-uploads
    through the shared upload runner (``exec/transitions.upload_frames``,
    the path HostToDeviceExec rides), one counted ``scan.upload`` a
    batch."""

    columnar_output = True

    def __init__(self, read: AqeShuffleReadExec):
        super().__init__()
        self.read = read

    def output_schema(self) -> Schema:
        return self.read.output_schema()

    def describe(self) -> str:
        return "Tpu" + self.read.describe()

    def fingerprint_extra(self) -> str:
        return self.read.fingerprint_extra()

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import (
            device_manager_of, empty_batch,
        )
        from spark_rapids_tpu_torch.exec.transitions import (
            upload_blocked_chars, upload_frames,
        )
        schema = self.output_schema()
        max_rows = ctx.conf.batch_size_rows
        cpu_parts = self.read.partitions(ctx)
        # one dictionary registry per reader (the TpuScanExec pattern):
        # every spec's upload encodes against the same dictionaries
        dict_state: dict = {}
        dm = device_manager_of(ctx)

        def make(part: Partition) -> Partition:
            def run():
                if ctx.session is not None:
                    ctx.session.semaphore.acquire_if_necessary()
                got = False
                for b in upload_frames(part, max_rows, dict_state,
                                       ctx.device, None, False,
                                       upload_blocked_chars(ctx.conf),
                                       schema):
                    if dm is not None:
                        dm.meter_batch(b)
                    got = True
                    yield b
                if not got:
                    # consumers (joins, aggregates) expect >= 1 batch a
                    # partition, like the exchange's empty yield
                    yield empty_batch(schema, ctx.device)
            return run
        return [make(p) for p in cpu_parts]


def _register_read_rule() -> None:
    from spark_rapids_tpu_torch.sql import overrides as ov

    def _tag(meta) -> None:
        pass

    def _convert(meta, children):
        return TpuAqeShuffleReadExec(meta.plan)

    ov._register(ov.ExecRule(
        AqeShuffleReadExec,
        "adaptive shuffle read (materialized query-stage output)",
        _tag, _convert))


_register_read_rule()
