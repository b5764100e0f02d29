"""Runtime shuffle statistics for adaptive execution (counterpart of the
JAX package's ``sql/adaptive/stats.py``).

``MapOutputStatistics`` is the host-side twin of what the reference's
GpuShuffleExchangeExec reports to Spark (MapStatus.partition_sizes folded
per reduce partition); the shuffle manager's ``aggregate_map_statistics``
and the AQE stages build it, and ``estimate_frame_bytes`` sizes a host
partition for it and for the CPU exchange's skew record
(``obs/shuffleobs.py``). ``split_frame`` is the canonical map-side
partitioner every AQE stage uses on both engine paths, so the
device-converted and CPU executions of one query land every row in the
same reduce partition: ``hash_partition_ids`` canonicalizes the key
columns (pandas' hash differs between plain numpy and masked extension
dtypes) before hashing, bit for bit as the JAX package does.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence

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


def hash_partition_ids(df: pd.DataFrame, key_idx: Sequence[int],
                       n: int) -> np.ndarray:
    """Canonical reduce-partition id per row: key columns are reduced to
    (values, validity) via host_unary_values, canonicalized (-0.0 -> 0.0,
    one NaN bit pattern, NULL -> type zero) and hashed as PLAIN numpy
    columns. Nulls sharing a partition with genuine zeros is fine: the
    partitioner only owes co-location of equal keys, and SQL null keys
    never match anyway."""
    from spark_rapids_tpu_torch.sql.exprs.hostutil import host_unary_values
    m = len(df)
    if not key_idx or m == 0:
        return np.zeros(m, dtype=np.int64)
    cols = []
    for i in key_idx:
        vals, validity, _dt = host_unary_values(df.iloc[:, i])
        if vals.dtype == object:
            canon = np.where(validity, vals, "")
        elif vals.dtype.kind == "f":
            v = vals.astype(np.float64)
            v = np.where(v == 0.0, 0.0, v)
            v = np.where(np.isnan(v), np.float64("nan"), v)
            canon = np.where(validity, v, 0.0)
        elif vals.dtype.kind == "M":
            canon = np.where(validity, vals.astype("datetime64[us]")
                             .astype(np.int64), 0)
        elif vals.dtype.kind == "b":
            canon = np.where(validity, vals.astype(np.int64), 0)
        else:
            canon = np.where(validity, vals.astype(np.int64), 0)
        cols.append(pd.Series(canon).reset_index(drop=True))
    frame = pd.concat(cols, axis=1)
    h = pd.util.hash_pandas_object(frame, index=False).to_numpy()
    return (h % np.uint64(n)).astype(np.int64)


def split_frame(df: pd.DataFrame, key_idx: Sequence[int],
                n: int) -> List[pd.DataFrame]:
    """One map task's output split into n reduce-partition frames."""
    pids = hash_partition_ids(df, key_idx, n)
    out = []
    for pid in range(n):
        sel = df[pids == pid]
        out.append(sel.reset_index(drop=True))
    return out


def stats_from_map_outputs(
        map_outputs: List[List[pd.DataFrame]]) -> MapOutputStatistics:
    """Fold per-(map, partition) frames into MapOutputStatistics."""
    bytes_by_map = [[estimate_frame_bytes(f) for f in pids]
                    for pids in map_outputs]
    rows_by_map = [[len(f) for f in pids] for pids in map_outputs]
    return MapOutputStatistics(bytes_by_map, rows_by_map)
