"""Scan sources (counterpart of the JAX package's ``sql/sources.py``):
``InMemorySource``, a pandas frame split into partitions (the session's
``create_dataframe``), and the file sources of ``s.read``:
``ParquetSource``, ``CsvSource`` and ``OrcSource``.

Footer work, pruning and split planning run on the host. A file source
takes files and directories: a directory is read recursively, and each
``key=value`` segment of a file's path under it becomes a partition value
of that file (the hive layout; ``__HIVE_DEFAULT_PARTITION__`` is NULL).
The partition keys are columns after the data columns, typed by every
directory's value (all integers: int64; numbers: float64; else string).

``ParquetSource`` plans one split per row group, ``(path, row group,
partition values)``. ``prune_splits`` drops the splits that the pushed
filters (``sql/pushdown``) rule out: by the row group's footer statistics
(kept in a bounded cache keyed by the file's stamp,
``parquet_raw.file_stamp``) and by the partition values. It has two
routes, as the JAX package's has: ``raw_partitions`` hands each split's
planning to the scan pipeline (``sql/scan_pipeline``), which yields
``ops/parquet_decode.RawRowGroup`` decode plans for the device decode
(through the session's encoded-page cache, ``memory/spill``), or a pandas
frame for a row group whose columns all fall back to the host;
``cpu_partitions`` reads each row group to pandas with pyarrow on the same
pipeline, partition values appended. ``OrcSource`` plans one split per
stripe and prunes by a min/max index it builds once a column (pyarrow
gives no stripe statistics); ``CsvSource`` one split per file. Both decode
on the host with pyarrow, as the JAX package does, and the device scan
uploads their frames. Each source gives a size estimate for the planner's
broadcast choice.
"""

from __future__ import annotations

import itertools
import os
from typing import List, Optional, Tuple

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

    def split_rows(self, splits=None) -> Optional[List[int]]:
        """Each split's row count (of ``splits``, default all), for a
        source whose splits the scan packs into partitions of at most
        ``batchSizeRows`` rows; None for a source whose partitions are
        uploaded as they come."""
        return None

    def cpu_partitions(self, splits=None) -> List[Partition]:
        """The source's partitions of pandas frames (of ``splits``, the
        kept part of a source with ``prune_splits``; default all)."""
        raise NotImplementedError

    def raw_partitions(self, blocked: int, depth: int = DEFAULT_DEPTH,
                       threads: Optional[int] = None, splits=None,
                       page_cache=None) -> Optional[List[Partition]]:
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

    def cpu_partitions(self, splits=None) -> List[Partition]:
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


def _expand_paths(paths: List[str], suffix: str):
    """[(file, {partition key: value text})]: a directory is walked
    recursively for its files ending in ``suffix`` (not those starting
    with ``_`` or ``.``), and the ``key=value`` segments of a file's path
    under it are its partition values (the reference appends them as
    scalar columns a partition, ColumnarPartitionReaderWithPartitionValues);
    a file path is taken as it is."""
    out = []
    for p in paths:
        if not os.path.isdir(p):
            out.append((p, {}))
            continue
        for root, _dirs, files in sorted(os.walk(p)):
            rel = os.path.relpath(root, p)
            pvals = {}
            if rel != ".":
                for seg in rel.split(os.sep):
                    if "=" in seg:
                        k, v = seg.split("=", 1)
                        pvals[k] = v
            for f in sorted(files):
                if f.endswith(suffix) and not f.startswith(("_", ".")):
                    out.append((os.path.join(root, f), dict(pvals)))
    return out


_HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _infer_partition_value(text: str):
    if text == _HIVE_NULL:  # the writer's NULL sentinel reads back as NULL
        return None
    try:
        return int(text)
    except ValueError:
        try:
            return float(text)
        except ValueError:
            return text


def _partition_key_dtype(values):
    """The common dtype of every directory value of one key: all integers
    int64, all numbers float64, else (mixed or unparseable) string."""
    kinds = {type(_infer_partition_value(v)) for v in values
             if _infer_partition_value(v) is not None}
    if kinds == {int}:
        return dtmod.INT64
    if kinds <= {int, float} and kinds:
        return dtmod.FLOAT64
    return dtmod.STRING


def partition_scalar(pvals: dict, key: str, dt):
    """A split's value of partition key ``key`` as its column holds it:
    None (NULL), a str, or a numpy scalar of ``dt``."""
    v = _infer_partition_value(pvals[key]) if key in pvals else None
    if v is None:
        return None
    return str(v) if dt.is_string else dt.np_dtype.type(v)


def append_partition_columns(df: pd.DataFrame, pvals: dict, pkeys,
                             pkey_dtypes) -> pd.DataFrame:
    """A host split's frame with its partition values appended as columns
    (the JAX package's ``decode_task``)."""
    for k in pkeys:
        dt = pkey_dtypes[k]
        df[k] = pd.Series([partition_scalar(pvals, k, dt)] * len(df),
                          dtype=object if dt.is_string
                          else dt.pandas_nullable)
    return df


class ParquetSource(DataSource):
    """Parquet scan: one split per row group, pruned by the pushed filters
    (reference: GpuParquetScan.scala:204-373 parses footers and clips row
    groups on the CPU before the device decode). Directory inputs resolve
    hive-partitioned layouts (``key=value`` directories)."""

    # row-group statistics cache bound: footers are small, but a long
    # session scanning many files would otherwise grow the cache forever
    _RG_STATS_CACHE_CAP = 4096
    # the query metric of the splits prune_splits drops
    pruned_metric = "numRowGroupsPruned"

    def __init__(self, paths, columns: Optional[List[str]] = None):
        paths = [paths] if isinstance(paths, str) else list(paths)
        self._files = _expand_paths(paths, ".parquet")
        if not self._files:
            raise FileNotFoundError(f"no parquet files under {paths}")
        self.paths = [f for f, _ in self._files]
        arrow_schema = praw.file_metadata(
            self.paths[0]).schema.to_arrow_schema()
        names, dts = [], []
        for field in arrow_schema:
            if columns and field.name not in columns:
                continue
            names.append(field.name)
            dts.append(dtmod.from_arrow(field.type))
        self.columns = list(names)  # the data columns
        # partition keys after the data columns, typed by every
        # directory's value
        self._pkeys = sorted({k for _, pv in self._files for k in pv})
        self._pkey_dtypes = {}
        for k in self._pkeys:
            dt = _partition_key_dtype([pv[k] for _, pv in self._files
                                       if k in pv])
            self._pkey_dtypes[k] = dt
            names.append(k)
            dts.append(dt)
        self.schema = Schema(names, dts)
        # the split plan: (path, row group, partition values)
        self.splits = [(p, rg, pvals) for p, pvals in self._files
                       for rg in range(praw.file_metadata(p).num_row_groups)]

    def describe(self) -> str:
        return (f"Parquet[{len(self.paths)} files, {len(self.splits)} row "
                "groups]")

    def estimated_size_bytes(self) -> Optional[int]:
        return sum(os.path.getsize(p) for p in self.paths)

    def split_rows(self, splits=None) -> List[int]:
        """Each split's row count (of ``splits``, default all), from the
        footers."""
        return [praw.file_metadata(p).row_group(rg).num_rows
                for p, rg, _pv in (self.splits if splits is None
                                   else splits)]

    def with_columns(self, columns: List[str]) -> "ParquetSource":
        """Projection view (no footer re-parse): read only ``columns``
        (data columns in the file's order, then the partition keys
        named)."""
        import copy
        src = copy.copy(self)
        src._base = getattr(self, "_base", self)
        src.columns = [c for c in self.columns if c in columns]
        src._pkeys = [k for k in self._pkeys if k in columns]
        names = list(src.columns) + list(src._pkeys)
        src.schema = Schema(names, [self.schema.dtype_of(n) for n in names])
        return src

    def _rg_stats(self, path: str, rg: int):
        """{column: (min, max, null_count, num_values)} of one row group
        from its footer, cached by (path, stamp, row group) so that a
        rewritten file's statistics never prune its replacement's row
        groups; oldest-half eviction past the cap."""
        base = getattr(self, "_base", self)
        cache = base.__dict__.setdefault("_stats_cache", {})
        stamp = praw.file_stamp(path)
        key = (path, stamp, rg)
        if key not in cache:
            if len(cache) >= self._RG_STATS_CACHE_CAP:
                for k in list(cache)[:len(cache)
                                     - self._RG_STATS_CACHE_CAP // 2]:
                    del cache[k]
            md = praw.file_metadata(path, stamp).row_group(rg)
            stats = {}
            for ci in range(md.num_columns):
                col = md.column(ci)
                st = col.statistics
                if st is None:
                    stats[col.path_in_schema] = (None, None, None, None)
                else:
                    stats[col.path_in_schema] = (
                        st.min if st.has_min_max else None,
                        st.max if st.has_min_max else None,
                        st.null_count, st.num_values)
            cache[key] = stats
        return cache[key]

    def prune_splits(self, filters) -> Tuple[list, int]:
        """(kept splits, pruned count): row-group statistics and
        partition-value pruning for the pushed conjuncts (ParquetFilters,
        GpuParquetScan.scala:204-246)."""
        from spark_rapids_tpu_torch.sql.pushdown import (
            maybe_matches, partition_value_matches,
        )
        keep = []
        for p, rg, pvals in self.splits:
            ok = True
            for name, op, value in filters:
                if name in self._pkeys:
                    pv = (_infer_partition_value(pvals[name])
                          if name in pvals else None)
                    if not partition_value_matches(pv, op, value):
                        ok = False
                        break
                    continue
                if name not in self.columns:
                    continue
                mn, mx, nulls, nvals = self._rg_stats(p, rg).get(
                    name, (None, None, None, None))
                if not maybe_matches(mn, mx, nulls, nvals, op, value):
                    ok = False
                    break
            if ok:
                keep.append((p, rg, pvals))
        return keep, len(self.splits) - len(keep)

    def raw_partitions(self, blocked: int, depth: int = DEFAULT_DEPTH,
                       threads: Optional[int] = None, splits=None,
                       page_cache=None) -> List[Partition]:
        """Device-decode split plan of ``splits`` (default all): planning
        threads produce RawRowGroup decode plans (raw page bytes + run
        tables, through ``page_cache`` where given) that the consumer
        decodes on the device (``exec/transitions.upload_partition``).
        ``blocked`` is the widest char-slab stride a plain string column
        may take. A row group where NO data column rides the device path
        comes back as its pandas frame, partition values appended."""
        splits = self.splits if splits is None else splits
        if not splits:
            return self._empty_partitions()
        columns = list(self.columns)
        dtypes_by_name = dict(zip(self.schema.names, self.schema.dtypes))
        pkeys, pkey_dtypes = list(self._pkeys), dict(self._pkey_dtypes)

        def decode_task(path: str, rg: int, pvals: dict):
            def decode():
                from spark_rapids_tpu_torch.ops.parquet_decode import (
                    prepare_rowgroup,
                )
                raw = prepare_rowgroup(path, rg, columns, dtypes_by_name,
                                       blocked, pvals, page_cache)
                if getattr(raw, "is_raw_rowgroup", False):
                    return raw
                return append_partition_columns(raw, pvals, pkeys,
                                                pkey_dtypes)
            return decode
        return build_partitions(
            [decode_task(p, rg, pv) for p, rg, pv in splits],
            [p for p, _rg, _pv in splits], depth, threads)

    def cpu_partitions(self, splits=None) -> List[Partition]:
        """Host-decode split plan of ``splits`` (default all): pyarrow
        reads each row group's columns and ``_arrow_decode`` turns them
        into a pandas frame, partition values appended, on the same
        planning pipeline. No split gives one empty frame."""
        splits = self.splits if splits is None else splits
        if not splits:
            return self._empty_partitions()
        columns = list(self.columns)
        pkeys, pkey_dtypes = list(self._pkeys), dict(self._pkey_dtypes)

        def decode_task(path: str, rg: int, pvals: dict):
            def decode():
                import pyarrow.parquet as pq
                table = pq.ParquetFile(path).read_row_group(rg,
                                                            columns=columns)
                return append_partition_columns(_arrow_decode(table), pvals,
                                                pkeys, pkey_dtypes)
            return decode
        return build_partitions(
            [decode_task(p, rg, pv) for p, rg, pv in splits],
            [p for p, _rg, _pv in splits])

    def _empty_partitions(self) -> List[Partition]:
        def empty():
            from spark_rapids_tpu_torch.exec.cpu import _empty_df
            yield _empty_df(self.schema)
        return [empty]


class CsvSource(DataSource):
    """CSV scan through pyarrow's host parse, one split a file (reference:
    Table.readCSV from GpuBatchScanExec.scala:477, with host-side line
    splitting). Without ``schema`` the columns and their types are the
    parser's over the first file (its first line the header); with one,
    its names and types are read (the first line skipped where
    ``header``). The JAX package's reader takes a schema's names only, the
    types staying the parser's, and always treats the first line as the
    header."""

    def __init__(self, paths, schema: Optional[Schema] = None,
                 header: bool = True):
        paths = [paths] if isinstance(paths, str) else list(paths)
        self.paths = [f for f, _ in _expand_paths(paths, ".csv")] or paths
        self.header = header
        # the schema the reader applies (None: the parser's)
        self._read_schema = schema
        if schema is not None:
            self.schema = schema
        else:
            t = self._read(self.paths[0])
            self.schema = Schema([f.name for f in t.schema],
                                 [dtmod.from_arrow(f.type)
                                  for f in t.schema])

    def _read(self, path: str):
        import pyarrow.csv as pacsv
        schema = self._read_schema
        if schema is None:
            return pacsv.read_csv(path, read_options=pacsv.ReadOptions(
                autogenerate_column_names=not self.header))
        return pacsv.read_csv(
            path, read_options=pacsv.ReadOptions(
                column_names=list(schema.names),
                skip_rows=1 if self.header else 0),
            convert_options=pacsv.ConvertOptions(column_types={
                n: dt.pa_type for n, dt in zip(schema.names,
                                               schema.dtypes)}))

    def describe(self) -> str:
        return f"CSV[{len(self.paths)} files]"

    def estimated_size_bytes(self) -> Optional[int]:
        return sum(os.path.getsize(p) for p in self.paths)

    def cpu_partitions(self, splits=None) -> List[Partition]:
        names = list(self.schema.names)

        def decode_task(path: str):
            def decode():
                df = _arrow_decode(self._read(path))
                df.columns = names
                return df
            return decode
        return build_partitions([decode_task(p) for p in self.paths],
                                list(self.paths))


class OrcSource(DataSource):
    """ORC scan: one split per stripe, decoded on the host by pyarrow.orc
    (reference: GpuOrcScan.scala:711 decodes via Table.readORC after
    host-side stripe clipping; its OrcFilters pushdown is host-side too)."""

    pruned_metric = "numStripesPruned"

    def __init__(self, paths, columns: Optional[List[str]] = None):
        import pyarrow.orc as paorc
        paths = [paths] if isinstance(paths, str) else list(paths)
        self.paths = [f for f, _ in _expand_paths(paths, ".orc")] or paths
        f = paorc.ORCFile(self.paths[0])
        names, dts = [], []
        for field in f.schema:
            if columns and field.name not in columns:
                continue
            names.append(field.name)
            dts.append(dtmod.from_arrow(field.type))
        self.columns = names
        self.schema = Schema(names, dts)
        # the split plan: (path, stripe)
        self.splits = [(p, s) for p in self.paths
                       for s in range(paorc.ORCFile(p).nstripes)]

    def describe(self) -> str:
        return f"ORC[{len(self.paths)} files, {len(self.splits)} stripes]"

    def estimated_size_bytes(self) -> Optional[int]:
        return sum(os.path.getsize(p) for p in self.paths)

    def with_columns(self, columns: List[str]) -> "OrcSource":
        import copy
        src = copy.copy(self)
        src._base = getattr(self, "_base", self)
        src.columns = [c for c in self.columns if c in columns]
        src.schema = Schema(list(src.columns), [self.schema.dtype_of(n)
                                                for n in src.columns])
        return src

    def _stripe_index(self, col: str):
        """{(path, stripe): (min, max, null_count, num_values)} of one
        column, built once by reading just that column of every stripe:
        pyarrow's ORC reader gives no stripe statistics (the reference
        reads them natively, sql/rapids/OrcFilters.scala), so this index
        plays their part across queries."""
        base = getattr(self, "_base", self)
        cache = base.__dict__.setdefault("_stripe_stats", {})
        if col not in cache:
            import pyarrow.compute as pc
            import pyarrow.orc as paorc
            idx = {}
            for p in self.paths:
                fh = paorc.ORCFile(p)
                for s in range(fh.nstripes):
                    arr = fh.read_stripe(s, columns=[col]).column(0)
                    n = len(arr)
                    nulls = arr.null_count
                    if n - nulls > 0:
                        mn, mx = pc.min(arr).as_py(), pc.max(arr).as_py()
                    else:
                        mn = mx = None
                    idx[(p, s)] = (mn, mx, nulls, n - nulls)
            cache[col] = idx
        return cache[col]

    def prune_splits(self, filters) -> Tuple[list, int]:
        """(kept stripes, pruned count) for the pushed conjuncts."""
        from spark_rapids_tpu_torch.sql.pushdown import maybe_matches
        keep = []
        for p, s in self.splits:
            ok = True
            for name, op, value in filters:
                if name not in self.columns:
                    continue
                mn, mx, nulls, nvals = self._stripe_index(name).get(
                    (p, s), (None, None, None, None))
                if not maybe_matches(mn, mx, nulls, nvals, op, value):
                    ok = False
                    break
            if ok:
                keep.append((p, s))
        return keep, len(self.splits) - len(keep)

    def cpu_partitions(self, splits=None) -> List[Partition]:
        """One partition of one pandas frame per stripe of ``splits``
        (default all); no stripe gives one empty frame."""
        splits = self.splits if splits is None else splits
        if not splits:
            def empty():
                from spark_rapids_tpu_torch.exec.cpu import _empty_df
                yield _empty_df(self.schema)
            return [empty]
        columns = list(self.columns)

        def decode_task(path: str, stripe: int):
            def decode():
                import pyarrow as pa
                import pyarrow.orc as paorc
                table = paorc.ORCFile(path).read_stripe(stripe,
                                                        columns=columns)
                if isinstance(table, pa.RecordBatch):
                    table = pa.Table.from_batches([table])
                return _arrow_decode(table)
            return decode
        return build_partitions([decode_task(p, s) for p, s in splits],
                                [p for p, _s in splits])


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

