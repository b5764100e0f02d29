"""The exec API-parity tool over the port's operators
(``tools/api_validation.py``; reference: api_validation/.../
ApiValidation.scala:27-60 signature diffing): both cases of
``tests/test_api_validation.py``, and its command line."""

import subprocess
import sys

from spark_rapids_tpu.tools import api_validation as ref
from spark_rapids_tpu_torch.tools.api_validation import (
    ALLOWED_CPU_ONLY, ALLOWED_TPU_ONLY, RENAMED, validate,
)


def test_exec_api_parity_clean():
    errors, lines = validate()
    assert errors == [], errors
    assert any("HashAggregateExec" in l for l in lines)
    # the JAX package's allow lists, no entry added
    assert ALLOWED_CPU_ONLY == ref.ALLOWED_CPU_ONLY
    assert ALLOWED_TPU_ONLY == ref.ALLOWED_TPU_ONLY
    assert RENAMED == ref.RENAMED


def test_every_known_exec_covered():
    # the report must mention the headline operators so a future rename
    # can't silently drop them from validation
    _, lines = validate()
    text = "\n".join(lines)
    for op in ("FilterExec", "ProjectExec", "SortExec", "WindowExec",
               "ShuffleExchangeExec", "ExpandExec", "GenerateExec",
               "WriteExec"):
        assert op in text, op
    # the port's own fused stage is reported as a device-only operator
    assert "TpuFusedStageExec: device-only operator" in text


def test_command_line_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "spark_rapids_tpu_torch.tools.api_validation"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "all operators validated" in out.stdout
