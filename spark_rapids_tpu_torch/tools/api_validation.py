"""API-parity validation tool (counterpart of the JAX package's
``tools/api_validation.py``).

The reference ships ``api_validation``: a reflection tool that diffs each
Spark exec's constructor signature against its Gpu* counterpart across
Spark versions, so API drift shows up as a report instead of a runtime
crash (api_validation/.../ApiValidation.scala:27-60). Same job here,
over the port's exec classes: every CPU (fallback-path) operator must
have a device operator, and where parameter names overlap they must
agree in order: the contract the plan rewriter's convert-to-device step
depends on. Operators that exist only on the device (the port's fused
stage, the host aggregation under a partial) are reported, not errors.

Run: ``python -m spark_rapids_tpu_torch.tools.api_validation``; prints
a report and exits nonzero on missing counterparts or disagreeing
parameter orders.
"""

from __future__ import annotations

import inspect
import sys
from typing import Dict, List, Tuple, Type

# CPU execs with no device counterpart by design, with the reason
ALLOWED_CPU_ONLY = {
    "CpuScanExec": "leaf ingestion: host file/memory scan feeds the "
                   "HostToDevice transition",
}

# device-only operators (no CPU twin needed): transitions and coalesce
# exist only on the accelerated plan (reference: GpuCoalesceBatches /
# GpuRowToColumnarExec have no CPU-side equivalents either)
ALLOWED_TPU_ONLY = {
    "TpuCoalesceBatchesExec", "TpuExec",
}

# CPU exec base -> differently-named device counterpart (the reference's
# SortMergeJoin -> GpuShuffledHashJoinExec replacement is the same shape)
RENAMED = {
    "JoinExec": "ShuffledHashJoinExec",
}


def _exec_classes() -> Tuple[Dict[str, Type], Dict[str, Type]]:
    from spark_rapids_tpu_torch.exec import (  # noqa: F401
        coalesce, cpu, generate, tpu, tpujoin, windowexec, write,
    )
    from spark_rapids_tpu_torch.exec import hostagg
    from spark_rapids_tpu_torch.exec.stagecompiler import fusedexec
    mods = [cpu, tpu, tpujoin, coalesce, windowexec, generate, write,
            hostagg, fusedexec]
    cpus: Dict[str, Type] = {}
    tpus: Dict[str, Type] = {}
    for m in mods:
        for name, obj in vars(m).items():
            if not inspect.isclass(obj) or not name.endswith("Exec"):
                continue
            if name.startswith("Cpu"):
                cpus[name[3:]] = obj
            elif name.startswith("Tpu"):
                tpus[name[3:]] = obj
    return cpus, tpus


def _params(cls: Type) -> List[str]:
    sig = inspect.signature(cls.__init__)
    return [p for p in sig.parameters if p != "self"]


def validate() -> Tuple[List[str], List[str]]:
    """Returns (errors, report_lines)."""
    cpus, tpus = _exec_classes()
    errors: List[str] = []
    lines: List[str] = []
    for base in sorted(cpus):
        cpu_cls = cpus[base]
        tpu_cls = tpus.get(RENAMED.get(base, base))
        if tpu_cls is None:
            if f"Cpu{base}" in ALLOWED_CPU_ONLY:
                lines.append(f"  Cpu{base}: cpu-only (allowed: "
                             f"{ALLOWED_CPU_ONLY[f'Cpu{base}']})")
                continue
            errors.append(f"Cpu{base} has no Tpu{base} counterpart")
            continue
        cp, tp = _params(cpu_cls), _params(tpu_cls)
        shared = [p for p in cp if p in tp]
        cpu_order = [p for p in cp if p in shared]
        tpu_order = [p for p in tp if p in shared]
        if cpu_order != tpu_order:
            errors.append(
                f"{base}: shared ctor params disagree in order: "
                f"Cpu{base}{tuple(cp)} vs Tpu{base}{tuple(tp)}")
        else:
            lines.append(f"  {base}: Cpu{tuple(cp)} ~ Tpu{tuple(tp)} OK")
    for base in sorted(set(tpus) - set(cpus)):
        if f"Tpu{base}" not in ALLOWED_TPU_ONLY:
            lines.append(f"  Tpu{base}: device-only operator")
    return errors, lines


def main() -> int:
    errors, lines = validate()
    print("exec API parity report (CPU fallback vs device operators):")
    for line in lines:
        print(line)
    if errors:
        print("\nERRORS:")
        for e in errors:
            print(f"  {e}")
        return 1
    print("\nall operators validated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
