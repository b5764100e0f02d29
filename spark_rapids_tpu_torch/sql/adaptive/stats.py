"""Runtime shuffle statistics (counterpart of part of the JAX package's
``sql/adaptive/stats.py``).

Ported: ``MapOutputStatistics``, the host-side twin of what the
reference's GpuShuffleExchangeExec reports to Spark (MapStatus
.partition_sizes folded per reduce partition), which the shuffle
manager's ``aggregate_map_statistics`` builds, and
``estimate_frame_bytes``, the CPU exchange's partition sizes for the skew
record (``obs/shuffleobs.py``). The rest of the module (the canonical
map-side split, the stage statistics) belongs to adaptive execution
(ROADMAP A.10).
"""

from __future__ import annotations

import statistics
from typing import List, Optional

import numpy as np
import pandas as pd


class MapOutputStatistics:
    """Observed sizes of one materialized shuffle stage: per-(map task,
    reduce partition) bytes, folded per reduce partition (the shape
    Spark's MapOutputStatistics carries; reference consumers:
    CoalesceShufflePartitions, OptimizeSkewedJoin)."""

    def __init__(self, bytes_by_map: List[List[int]],
                 rows_by_map: Optional[List[List[int]]] = None):
        self.bytes_by_map = [list(m) for m in bytes_by_map]
        self.rows_by_map = ([list(m) for m in rows_by_map]
                            if rows_by_map is not None else None)
        n = len(self.bytes_by_map[0]) if self.bytes_by_map else 0
        self.bytes_by_partition = [
            sum(m[p] for m in self.bytes_by_map) for p in range(n)]
        self.rows_by_partition = (
            [sum(m[p] for m in self.rows_by_map) for p in range(n)]
            if self.rows_by_map is not None else None)

    @property
    def num_maps(self) -> int:
        return len(self.bytes_by_map)

    @property
    def num_partitions(self) -> int:
        return len(self.bytes_by_partition)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_partition)

    def max_bytes(self) -> int:
        return max(self.bytes_by_partition, default=0)

    def median_bytes(self) -> int:
        if not self.bytes_by_partition:
            return 0
        return int(statistics.median(self.bytes_by_partition))

    def partition_map_sizes(self, pid: int) -> List[int]:
        """One reduce partition's size per map task (the skew-split
        granularity: Spark splits skewed partitions by map ranges)."""
        return [m[pid] for m in self.bytes_by_map]


def estimate_frame_bytes(df: pd.DataFrame, sample: int = 1024) -> int:
    """Cheap byte estimate of a host partition frame: exact buffer sizes
    for fixed-width columns, sampled mean string length for object
    columns (deep memory_usage walks every python object — too slow on
    the exchange hot path at bench scale)."""
    n = len(df)
    if n == 0:
        return 0
    total = 0
    for i in range(df.shape[1]):
        s = df.iloc[:, i]
        arr = getattr(s, "array", None)
        if hasattr(arr, "_data"):          # masked extension: data + mask
            total += arr._data.nbytes + arr._mask.nbytes
            continue
        vals = s.to_numpy()
        if vals.dtype == object:
            take = vals if n <= sample else \
                vals[np.linspace(0, n - 1, sample).astype(np.int64)]
            lens = [len(v) if isinstance(v, str) else 8 for v in take]
            mean = (sum(lens) / len(lens)) if lens else 8.0
            total += int(n * (mean + 8))   # chars + offset word
        else:
            total += vals.nbytes
    return int(total)
