"""Whole-stage fusion (counterpart of the JAX package's
``exec/stagecompiler``).

The converted physical plan runs one operator iterator per operator per
batch. This subsystem collapses each fusible pipeline into one plan node:

  * ``cutter``    — walks the converted plan and cuts maximal chains of
    fusible operators at exchange/scan/fallback boundaries (the edges
    AQE's stage cutting keys on too);
  * ``fusedexec`` — ``TpuFusedStageExec``, the plan node that runs the
    whole member pipeline as one composed per-batch function and reports
    its member operators to the profile tree, progress records and the
    flight recorder.

Gate: ``spark.rapids.sql.fusion.stageEnabled`` (default false: the
per-operator plans stay as they are).
"""

from spark_rapids_tpu_torch.exec.stagecompiler.cutter import compile_stages
from spark_rapids_tpu_torch.exec.stagecompiler.fusedexec import (
    TpuFusedStageExec,
)

__all__ = ["compile_stages", "TpuFusedStageExec"]
