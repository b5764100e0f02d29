"""Zero-copy DataFrame -> device-columnar export for ML training
(counterpart of the JAX package's ``ml/columnar_rdd.py``; reference:
ColumnarRdd.scala:41-50 + InternalColumnarRddConverter.scala:470-579
re-extract the device-resident RDD[Table] under the final
GpuColumnarToRowExec so XGBoost trains without a host round trip).

The export plans the query as the session does (``Planner`` over the
pruned logical plan, ``TpuOverrides``, ``TransitionOverrides``, the fused
count distinct and subtree reuse, test mode's check) and stops before
the collect: the partitions yield ``DeviceBatch``es whose columns are
tensors on the session's device, which a trainer consumes directly
(``to_feature_matrix`` stacks them). Gated by
``spark.rapids.sql.exportColumnarRdd`` (RapidsConf.scala:332-337).

The partitions run outside the session's query bookkeeping, so each one
carries what the session's drain does at a query's end:

  * the context does not speculate (``speculate=False``): nothing would
    verify a speculated capacity on a context handed to an outside
    consumer, so every capacity sync stays exact;
  * the task semaphore a partition's upload acquired is released when
    the partition's generator ends, is closed (a consumer that drops it
    half-read) or is collected;
  * the query's transient spillables (broadcast tables, shared subtrees)
    and shuffles are released once every partition has ended;
  * no cancellation scope applies: the context takes the thread's scope
    when ``convert`` runs, None outside a served job.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch


class ColumnarRdd:
    @staticmethod
    def convert(df) -> List[Callable[[], Iterator[DeviceBatch]]]:
        """DataFrame -> device-batch partitions (no device->host copy).

        Raises unless ``spark.rapids.sql.exportColumnarRdd`` is true and
        the final plan is fully columnar (any CPU fallback would force a
        host round trip, defeating the zero-copy contract)."""
        session = df.session
        conf = session.conf
        if not conf.get_bool("spark.rapids.sql.exportColumnarRdd", False):
            raise RuntimeError(
                "ColumnarRdd export requires "
                "spark.rapids.sql.exportColumnarRdd=true")
        from spark_rapids_tpu_torch.exec.base import ExecContext
        if not conf.sql_enabled:
            raise RuntimeError("ColumnarRdd export requires "
                               "spark.rapids.sql.enabled=true")
        from spark_rapids_tpu_torch.columnar import dictionary
        from spark_rapids_tpu_torch.sql import scan_pipeline
        dictionary.configure_from_conf(conf)
        scan_pipeline.configure_from_conf(conf)
        plan, _overrides = session._convert_cpu(session._cpu_plan(df._plan))
        if not plan.columnar_output:
            raise RuntimeError(
                "query does not end on the device; the export would "
                "require a device->host round trip (plan root: "
                f"{plan.describe()})")
        ctx = ExecContext(conf, session, device=session.device,
                          speculate=False)
        return _Export(session, ctx, plan).partitions()


class _Export:
    """One export's partitions and the release of what they hold."""

    def __init__(self, session, ctx, plan):
        self.session = session
        self.ctx = ctx
        self.plan = plan
        self._lock = threading.Lock()
        self._ended: set = set()
        self._n = 0

    def partitions(self) -> List[Callable[[], Iterator[DeviceBatch]]]:
        with self._scope():
            parts = self.plan.executed_partitions(self.ctx)
        self._n = len(parts)
        return [self._wrap(i, p) for i, p in enumerate(parts)]

    @contextlib.contextmanager
    def _scope(self):
        """This export's context as the thread's executing query while the
        plan runs, so transients register with it."""
        prev = self.session._current_ctx()
        self.session._exec_scope.ctx = self.ctx
        try:
            yield
        finally:
            self.session._exec_scope.ctx = prev

    def _wrap(self, i: int, part):
        def run() -> Iterator[DeviceBatch]:
            it = None
            try:
                with self._scope():
                    it = part()
                while True:
                    with self._scope():
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                    yield batch
            finally:
                if it is not None and hasattr(it, "close"):
                    with self._scope():
                        it.close()
                self.session.semaphore.release()
                self._end(i)
        return run

    def _end(self, i: int) -> None:
        with self._lock:
            self._ended.add(i)
            done = len(self._ended) >= self._n
        if done:
            self.session.release_active_shuffles(self.ctx)
            self.session.release_transient_buffers(self.ctx)


def to_feature_matrix(batch: DeviceBatch,
                      feature_cols: List[str],
                      label_col: str) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Stack feature columns of a device batch into a dense (rows, k)
    float32 matrix + label vector + live-row mask, all on the batch's
    device: the hand-off shape a trainer wants (the XGBoost4J-Spark
    zero-copy pattern, BASELINE config 5). Each column's data goes as it
    is, as in the JAX package: booleans as 0/1, dates as int32 days,
    timestamps as int64 microseconds; a NULL row's value is whatever its
    slot holds (its validity is not folded into the mask). A string
    column is not a feature and raises."""
    def values(name: str) -> torch.Tensor:
        c = batch.column(name)
        if c.data is None:
            raise TypeError(f"column {name!r} ({c.dtype}) is not numeric: "
                            "a string column is not a feature")
        return c.data.to(torch.float32)
    x = torch.stack([values(n) for n in feature_cols], dim=1)
    y = values(label_col)
    return x, y, batch.row_mask()
