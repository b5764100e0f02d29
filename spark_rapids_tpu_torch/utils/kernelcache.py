"""Shape buckets and the build cache's counters (counterpart of the JAX
package's ``utils/kernelcache.py``).

The JAX package pads secondary shape dimensions up a coarse bucket
ladder (``spark.rapids.tpu.compile.shapeBuckets``, off by default) so one
XLA compile serves a dimension range. The port keeps the same switch and
ladder: ``bucket_dim`` pads a secondary dimension (the dictionary
branch's slot-table capacity, the fused stage's coarse input re-batching,
``exec/stagecompiler/fusedexec.py``) when the buckets are on and is the
identity when they are off. Eager PyTorch compiles nothing per shape, so
the buckets here only bound the number of distinct capacities.

``cached_jit``, the per-kernel profile and the build hook of the JAX
package have no counterpart: nothing is traced or compiled per operator.
The port's one compile step is ``nvcc`` building ``csrc/*.cu`` once per
source (``ops/cudalib.py``); ``cache_stats``/``cache_snapshot`` report
that build cache.
"""

from __future__ import annotations

import math
import os

_BUCKETS = {"enabled": False, "min": 4096, "growth": 2.0}


def configure_shape_buckets(enabled: bool, min_bucket: int = 4096,
                            growth: float = 2.0) -> None:
    _BUCKETS["enabled"] = bool(enabled)
    _BUCKETS["min"] = max(8, int(min_bucket))
    _BUCKETS["growth"] = max(1.1, float(growth))


def configure_shape_buckets_from_conf(conf) -> bool:
    """Set the ladder from ``spark.rapids.tpu.compile.shapeBuckets*``;
    ``SRT_SHAPE_BUCKETS=1``/``0`` overrides the conf for a whole process,
    as in the JAX package. Returns whether the buckets are on."""
    env = os.environ.get("SRT_SHAPE_BUCKETS")
    enabled = (env != "0") if env is not None else conf.get_bool(
        "spark.rapids.tpu.compile.shapeBuckets", False)
    configure_shape_buckets(
        enabled,
        min_bucket=int(conf.get(
            "spark.rapids.tpu.compile.shapeBuckets.minBucket", 4096)),
        growth=float(conf.get(
            "spark.rapids.tpu.compile.shapeBuckets.growth", 2.0)))
    return _BUCKETS["enabled"]


def shape_buckets_enabled() -> bool:
    return _BUCKETS["enabled"]


def bucket_dim(n: int) -> int:
    """Pad a secondary shape dimension up the coarse ladder (the identity
    when the buckets are off)."""
    if not _BUCKETS["enabled"] or n <= 0:
        return n
    b = _BUCKETS["min"]
    growth = _BUCKETS["growth"]
    while b < n:
        b = int(math.ceil(b * growth))
    return b


def cache_stats() -> dict:
    """The nvcc build cache's counters of this process: ``misses`` (the
    libraries compiled), ``hits`` (found built) and ``entries`` (the
    libraries loaded)."""
    from spark_rapids_tpu_torch.ops import cudalib
    st = cudalib.BUILD_STATS
    return {"hits": st["hits"], "misses": st["builds"],
            "entries": len(cudalib._LIBS)}


def cache_snapshot() -> dict:
    """``cache_stats`` with the summed build seconds, the figure the AQE
    stage record's compiles/compileSeconds read as a watermark."""
    from spark_rapids_tpu_torch.ops import cudalib
    out = cache_stats()
    out["seconds"] = cudalib.BUILD_STATS["seconds"]
    return out
