"""Scan sources (counterpart of the JAX package's ``sql/sources.py``):
``InMemorySource``, a pandas frame split into partitions (the session's
``create_dataframe``), and ``ParquetSource``, Parquet files (the
session's ``read.parquet``).

Footer work and split planning run on the host: one split per row group.
``ParquetSource`` has two routes, as the JAX package's has:
``raw_partitions`` hands each split's planning to the scan pipeline
(``sql/scan_pipeline``), which yields ``ops/parquet_decode.RawRowGroup``
decode plans for the device decode, or a pandas frame for a row group
whose columns all fall back to the host; ``cpu_partitions`` reads each
row group to pandas with pyarrow on the same pipeline. Each source gives
a size estimate for the planner's broadcast choice. Row-group pruning
(``prune_splits``), directories, hive partition columns and the CSV and
ORC sources are not ported yet (ROADMAP A.7): a source is a list of
files.
"""

from __future__ import annotations

import itertools
import os
from typing import List, Optional

import pandas as pd

from spark_rapids_tpu_torch.columnar import dtype as dtmod
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.sql import parquet_raw as praw
from spark_rapids_tpu_torch.sql.scan_pipeline import (
    DEFAULT_DEPTH, Partition, build_partitions,
)


_DATA_UIDS = itertools.count()


class DataSource:
    """What the planner and the scans read of a source."""

    schema: Schema

    def data_uid(self) -> str:
        """Identity of the data behind this source, shared by its
        projection views (``with_columns``); a new source gets a new one,
        from a process-wide counter (never an ``id()`` the allocator could
        reuse)."""
        base = getattr(self, "_base", self)
        if getattr(base, "_data_uid", None) is None:
            base._data_uid = next(_DATA_UIDS)
        return f"{type(base).__name__}#{base._data_uid}"

    def describe(self) -> str:
        return type(self).__name__

    def estimated_size_bytes(self) -> Optional[int]:
        """Size hint for broadcast-join planning (None = unknown)."""
        return None

    def split_rows(self) -> Optional[List[int]]:
        """Each split's row count, for a source whose splits the scan packs
        into partitions of at most ``batchSizeRows`` rows; None for a
        source whose partitions are uploaded as they come."""
        return None

    def cpu_partitions(self) -> List[Partition]:
        """The source's partitions of pandas frames."""
        raise NotImplementedError

    def raw_partitions(self, blocked: int, depth: int = DEFAULT_DEPTH,
                       threads: Optional[int] = None
                       ) -> Optional[List[Partition]]:
        """Device-decode partitions (``ops/parquet_decode.RawRowGroup``
        decode plans), or None for a source with no raw-page reader."""
        return None


class InMemorySource(DataSource):
    """createDataFrame: a pandas frame split into ``num_partitions``
    contiguous slices."""

    def __init__(self, df: pd.DataFrame, num_partitions: int = 1):
        self.df = df
        self.num_partitions = max(1, num_partitions)
        self.schema = Schema.from_pandas(df)

    def describe(self) -> str:
        return f"InMemory[{len(self.df)} rows x {len(self.df.columns)} cols]"

    def estimated_size_bytes(self) -> Optional[int]:
        # deep=True so object/string columns count their payload, not just
        # the 8-byte pointers (a shallow count broadcasts huge tables); the
        # whole frame's, also for a projection view, and counted once a
        # frame, since every execution plans again
        base = getattr(self, "_base", self)
        if getattr(base, "_size_bytes", None) is None:
            base._size_bytes = int(base.df.memory_usage(deep=True).sum())
        return base._size_bytes

    def with_columns(self, columns: List[str]) -> "InMemorySource":
        """Projection-pushdown view: only the referenced columns (a pandas
        column view, no copy)."""
        keep = [c for c in self.df.columns if c in columns]
        src = InMemorySource.__new__(InMemorySource)
        src.df = self.df[keep]
        src.num_partitions = self.num_partitions
        src.schema = Schema(keep, [self.schema.dtype_of(c) for c in keep])
        src._base = getattr(self, "_base", self)
        return src

    def cpu_partitions(self) -> List[Partition]:
        n = len(self.df)
        per = -(-n // self.num_partitions) if n else 0
        if per == 0:
            def empty():
                yield self.df.iloc[0:0]

            def nothing():
                return iter(())
            return [empty] + [nothing] * (self.num_partitions - 1)

        def part(i: int) -> Partition:
            def run():
                yield self.df.iloc[i * per:(i + 1) * per] \
                    .reset_index(drop=True)
            return run
        return [part(i) for i in range(self.num_partitions)]


class ParquetSource(DataSource):
    """Parquet scan: one split per row group (reference:
    GpuParquetScan.scala parses footers and clips row groups on the CPU
    before the device decode)."""

    def __init__(self, paths, columns: Optional[List[str]] = None):
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        if not self.paths:
            raise FileNotFoundError("no parquet files given")
        arrow_schema = praw.file_metadata(
            self.paths[0]).schema.to_arrow_schema()
        names, dts = [], []
        for field in arrow_schema:
            if columns and field.name not in columns:
                continue
            names.append(field.name)
            dts.append(dtmod.from_arrow(field.type))
        self.columns = list(names)
        self.schema = Schema(names, dts)
        # partition plan: (path, row group index)
        self.splits = [(p, rg) for p in self.paths
                       for rg in range(praw.file_metadata(p).num_row_groups)]

    def describe(self) -> str:
        return (f"Parquet[{len(self.paths)} files, {len(self.splits)} row "
                "groups]")

    def estimated_size_bytes(self) -> Optional[int]:
        return sum(os.path.getsize(p) for p in self.paths)

    def split_rows(self) -> List[int]:
        """Each split's row count, from the footers."""
        return [praw.file_metadata(p).row_group(rg).num_rows
                for p, rg in self.splits]

    def with_columns(self, columns: List[str]) -> "ParquetSource":
        """Projection view (no footer re-parse): read only ``columns``, in
        the file's column order."""
        import copy
        src = copy.copy(self)
        src._base = getattr(self, "_base", self)
        src.columns = [c for c in self.columns if c in columns]
        src.schema = Schema(src.columns, [self.schema.dtype_of(c)
                                          for c in src.columns])
        return src

    def raw_partitions(self, blocked: int, depth: int = DEFAULT_DEPTH,
                       threads: Optional[int] = None) -> List[Partition]:
        """Device-decode split plan: planning threads produce RawRowGroup
        decode plans (raw page bytes + run tables) that the consumer
        decodes on the device (``exec/transitions.upload_partition``).
        ``blocked`` is the widest char-slab stride a plain string column
        may take. A row group where NO column rides the device path comes
        back as its pandas frame."""
        columns = list(self.columns)
        dtypes_by_name = dict(zip(self.schema.names, self.schema.dtypes))

        def decode_task(path: str, rg: int):
            def decode():
                from spark_rapids_tpu_torch.ops.parquet_decode import (
                    prepare_rowgroup,
                )
                return prepare_rowgroup(path, rg, columns, dtypes_by_name,
                                        blocked)
            return decode
        return build_partitions(
            [decode_task(p, rg) for p, rg in self.splits],
            [p for p, _rg in self.splits], depth, threads)

    def cpu_partitions(self) -> List[Partition]:
        """Host-decode split plan: pyarrow reads each row group's columns
        and ``_arrow_decode`` turns them into a pandas frame, on the same
        planning pipeline. A file with no row groups gives one empty
        frame."""
        columns = list(self.columns)
        if not self.splits:
            def empty():
                from spark_rapids_tpu_torch.exec.cpu import _empty_df
                yield _empty_df(self.schema)
            return [empty]

        def decode_task(path: str, rg: int):
            def decode():
                import pyarrow.parquet as pq
                table = pq.ParquetFile(path).read_row_group(rg,
                                                            columns=columns)
                return _arrow_decode(table)
            return decode
        return build_partitions(
            [decode_task(p, rg) for p, rg in self.splits],
            [p for p, _rg in self.splits])


# ---------------------------------------------------------------------------
# host decode of fallback columns (copies of the JAX package's helpers)
# ---------------------------------------------------------------------------

def _types_mapper(pa_type):
    import pyarrow as pa
    # nullable ints map to pandas extension dtypes so nulls survive
    m = {pa.int8(): pd.Int8Dtype(), pa.int16(): pd.Int16Dtype(),
         pa.int32(): pd.Int32Dtype(), pa.int64(): pd.Int64Dtype(),
         pa.float32(): pd.Float32Dtype(), pa.float64(): pd.Float64Dtype(),
         pa.bool_(): pd.BooleanDtype()}
    return m.get(pa_type)


def _arrow_to_pandas(table) -> pd.DataFrame:
    return table.to_pandas(types_mapper=_types_mapper)


def _arrow_decode(table) -> pd.DataFrame:
    """arrow Table -> pandas for the host-decoded columns: non-nullable
    primitive (int/float/bool) columns convert arrow -> numpy -> Series
    directly, skipping the pandas nullable extension; columns with nulls,
    strings, dates/timestamps and dictionaries go through
    ``_arrow_to_pandas``, so values and null masks are the JAX package's
    (its ``direct`` decode)."""
    if table.num_rows == 0 or table.num_columns == 0:
        return _arrow_to_pandas(table)
    import pyarrow as pa
    series: List = []
    fallback_idx = []
    for i in range(table.num_columns):
        col = table.column(i)
        t = col.type
        if (col.null_count == 0
                and (pa.types.is_integer(t) or pa.types.is_floating(t)
                     or pa.types.is_boolean(t))):
            series.append(pd.Series(col.to_numpy(zero_copy_only=False),
                                    copy=False))
        else:
            series.append(None)
            fallback_idx.append(i)
    if fallback_idx:
        fb = _arrow_to_pandas(table.select(fallback_idx))
        for j, i in enumerate(fallback_idx):
            series[i] = fb.iloc[:, j].reset_index(drop=True)
    df = pd.concat(series, axis=1)
    df.columns = list(table.column_names)
    return df

