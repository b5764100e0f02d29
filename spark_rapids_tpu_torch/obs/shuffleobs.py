"""Shuffle-skew observability, independent of AQE (counterpart of the
JAX package's ``obs/shuffleobs.py``).

Every materialized shuffle (the CPU exchange's hash buckets, the
accelerated shuffle manager's MapStatus sizes) reports its per-reduce-
partition size distribution here: max/median ratio as process-registry
gauges, a ``shuffleSkew`` event in the journal (obs/events.py), and a
per-query presence counter so the profile report's ``shuffleSkew``
section only appears for queries that actually shuffled.
"""

from __future__ import annotations

from typing import List, Optional


def skew_summary(sizes: List[int]) -> Optional[dict]:
    """max/median/total of one shuffle's per-partition byte sizes, plus
    the max/median ratio (median clamped to 1 so an all-but-one-empty
    shuffle reads as max-bytes-skewed rather than dividing by zero)."""
    if not sizes:
        return None
    import statistics
    mx = int(max(sizes))
    med = int(statistics.median(sizes))
    return {
        "partitions": len(sizes),
        "totalBytes": int(sum(sizes)),
        "maxBytes": mx,
        "medianBytes": med,
        "maxMedianRatio": round(mx / max(med, 1), 3),
    }


def record_shuffle_skew(sizes: List[int], source: str) -> Optional[dict]:
    """Publish one shuffle's skew summary (gauges + counter + event).
    Returns the summary dict (None for a partition-less shuffle)."""
    summary = skew_summary(sizes)
    if summary is None:
        return None
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    REGISTRY.counter("shuffle.skew.shuffles").add(1)
    # gauges are last-shuffle state (flows ride the counter + event log)
    REGISTRY.gauge("shuffle.skew.maxMedianRatio").set(
        summary["maxMedianRatio"])
    REGISTRY.gauge("shuffle.skew.maxPartitionBytes").set(
        summary["maxBytes"])
    REGISTRY.gauge("shuffle.skew.medianPartitionBytes").set(
        summary["medianBytes"])
    EVENTS.emit("shuffleSkew", source=source, **summary)
    return summary
