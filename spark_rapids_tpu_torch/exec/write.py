"""Data-writing command execs: Parquet, ORC and CSV output with a commit
protocol (counterpart of the JAX package's ``exec/write.py``).

reference: GpuDataWritingCommandExec (94), ColumnarOutputWriter (183),
GpuFileFormatWriter (338), GpuParquetFileFormat / GpuOrcFileFormat: the
accelerator writes columnar batches straight to the file format, and the
commit protocol (task staging directory -> rename into place +
``_SUCCESS``) comes from Spark. Here a device batch's columns become one
arrow table (``_arrow_table_from_batch``: the copy to the host is the only
one, inside one counted sync a batch, ``write.fetch``; strings go from
their chars and offsets, a dictionary as its values taken by its codes,
never through Python objects) and pyarrow encodes on the host, as in the
JAX package: neither package has a device encoder. Every column takes the
JAX package's arrow type (``dtype.pa_type``), so both packages' files hold
the same schema.

Where the port differs from the JAX package:

  * a float NaN is written as NaN, not as NULL (the JAX package converts
    through ``from_pandas=True``, which makes NaN NULL);
  * an overwrite removes the target's earlier entries at commit, not at
    setup, so a failed overwrite leaves them in place and each new file
    is made while the old one still exists (a new inode: the readers'
    caches key on it, ``sql/parquet_raw.file_stamp``);
  * a Parquet column is dictionary-encoded only where its dictionary
    cannot overflow pyarrow's dictionary page limit, so that no column
    chunk switches to PLAIN midway, which only the host decodes
    (``ops/parquet_decode``, reason ``mixedEncoding``); the JAX package
    writes pyarrow's defaults. The tables read back are the same;
  * partition directories are split on the host by the partition
    columns alone (their values rendered as the JAX package renders them,
    from pandas), the other columns taken from the arrow table by row
    positions, not through pandas.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from typing import Iterator, List

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, _pandas_to_numpy,
)
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.obs import compileledger
from spark_rapids_tpu_torch.obs.syncledger import sync_scope

_HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"
_EXTENSIONS = {"parquet": ".parquet", "csv": ".csv", "orc": ".orc"}
# pyarrow's dictionary page limit (its ``dictionary_pagesize_limit``
# default); a column whose distinct values take more than half of it is
# written PLAIN
_DICT_PAGE_LIMIT = 1 << 20


def _validity_buffer(validity: np.ndarray):
    """An arrow validity bitmap of a bool array, or None where all valid."""
    import pyarrow as pa
    if validity.all():
        return None
    return pa.py_buffer(np.packbits(validity, bitorder="little"))


def _arrow_array(values: np.ndarray, validity: np.ndarray, dt):
    """A fixed-width column's arrow array of type ``dt.pa_type`` over its
    physical values (date: int32 days; timestamp: int64 microseconds)."""
    import pyarrow as pa
    n = len(values)
    if dt.name == "bool":
        return pa.array(values.astype(np.bool_), type=pa.bool_(),
                        mask=None if validity.all() else ~validity)
    data = np.ascontiguousarray(values, dtype=dt.np_dtype)
    return pa.Array.from_buffers(
        dt.pa_type, n, [_validity_buffer(validity), pa.py_buffer(data)],
        null_count=int(n - validity.sum()))


def _string_array(chars: np.ndarray, offsets: np.ndarray,
                  validity: np.ndarray):
    """An arrow string array over chars and int32 offsets."""
    import pyarrow as pa
    n = len(validity)
    return pa.StringArray.from_buffers(
        n, pa.py_buffer(np.ascontiguousarray(offsets, dtype=np.int32)),
        pa.py_buffer(np.ascontiguousarray(chars, dtype=np.uint8)),
        _validity_buffer(validity), int(n - validity.sum()))


def _host_parts(col, n: int) -> dict:
    """The device tensors of one column's leading ``n`` rows that its
    arrow array is built from, still on the device: a dictionary's codes,
    any other string form's chars and offsets (``plain_parts`` rebuilds a
    slab's), a fixed-width column's values; each with its validity."""
    from spark_rapids_tpu_torch.columnar.column import is_dict, plain_parts
    out = {"validity": col.validity[:n]}
    if not col.dtype.is_string:
        out["data"] = col.data[:n]
    elif is_dict(col):
        out["codes"] = col.dict_codes[:n]
    else:
        chars, offsets = plain_parts(col)
        out["offsets"] = offsets[:n + 1]
        out["chars"] = chars
    return out


def _arrow_table_from_batch(batch: DeviceBatch):
    """Device batch -> pyarrow table from the column buffers (no row
    pivot): one counted sync for the row count where the host does not
    know it, one for the copies."""
    import pyarrow as pa
    n = (batch.host_rows if batch.host_rows is not None
         else batch.num_rows_host())
    parts = [_host_parts(col, n) for col in batch.columns]
    nbytes = sum(t.numel() * t.element_size() for p in parts
                 for t in p.values())
    t0 = time.perf_counter()
    with sync_scope("write.fetch", nbytes=nbytes):
        host = [{k: t.cpu().numpy() for k, t in p.items()} for p in parts]
    compileledger.note_transfer(time.perf_counter() - t0, "d2h")
    arrays = []
    for col, h, dt in zip(batch.columns, host, batch.schema.dtypes):
        validity = h["validity"]
        if not dt.is_string:
            arrays.append(_arrow_array(h["data"], validity, dt))
        elif "codes" in h:
            dictionary = pa.array(list(col.dict_values), type=pa.string())
            codes = pa.array(h["codes"], type=pa.int32(),
                             mask=~validity)
            arrays.append(dictionary.take(codes))
        else:
            offsets = h["offsets"]
            arrays.append(_string_array(h["chars"][:int(offsets[-1])],
                                        offsets, validity))
    return pa.Table.from_arrays(arrays, names=list(batch.schema.names))


def _arrow_table_from_pandas(df: pd.DataFrame, schema: Schema):
    """A host frame -> pyarrow table of the schema's types; NULL by the
    port's host rules (``_pandas_to_numpy``: a float NaN is a value)."""
    import pyarrow as pa
    arrays = []
    for i, dt in enumerate(schema.dtypes):
        values, validity = _pandas_to_numpy(df.iloc[:, i], dt)
        if dt.is_string:
            arrays.append(pa.array(values, type=pa.string(),
                                   mask=~validity))
        else:
            arrays.append(_arrow_array(values, validity, dt))
    return pa.Table.from_arrays(arrays, names=list(schema.names))


class WriteCommitProtocol:
    """Task staging and commit (reference: GpuFileFormatWriter.scala:338
    riding Spark's HadoopMapReduceCommitProtocol): tasks write under
    ``<path>/_temporary/<job>/``, the commit removes the target's earlier
    entries (overwrite) and renames the staged files into place, an abort
    removes the staging tree. A reader never sees partial files in the
    target listing."""

    def __init__(self, path: str):
        self.path = path
        self.job_id = uuid.uuid4().hex[:12]
        self.staging = os.path.join(path, "_temporary", self.job_id)
        self.mode = "error"

    def _entries(self) -> List[str]:
        return [e for e in os.listdir(self.path) if e != "_temporary"]

    def setup(self, mode: str) -> None:
        self.mode = mode
        if (mode == "error" and os.path.isdir(self.path)
                and self._entries()):
            raise FileExistsError(
                f"path {self.path} already exists (mode=error)")
        os.makedirs(self.staging, exist_ok=True)

    def task_file(self, partition_id: int, ext: str,
                  subdir: str = "") -> str:
        d = os.path.join(self.staging, subdir) if subdir else self.staging
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"part-{partition_id:05d}{ext}")

    def commit(self) -> None:
        if self.mode == "overwrite":
            for entry in self._entries():
                full = os.path.join(self.path, entry)
                (shutil.rmtree if os.path.isdir(full) else os.unlink)(full)
        # move the staged files, keeping their key=value directories
        for root, _dirs, files in os.walk(self.staging):
            rel = os.path.relpath(root, self.staging)
            target = (self.path if rel == "."
                      else os.path.join(self.path, rel))
            os.makedirs(target, exist_ok=True)
            for f in sorted(files):
                os.replace(os.path.join(root, f), os.path.join(target, f))
        shutil.rmtree(os.path.join(self.path, "_temporary"),
                      ignore_errors=True)
        open(os.path.join(self.path, "_SUCCESS"), "w").close()

    def abort(self) -> None:
        shutil.rmtree(os.path.join(self.path, "_temporary"),
                      ignore_errors=True)


def _render(v) -> str:
    return _HIVE_NULL if pd.isna(v) else str(v)


def _partition_subdirs(table, pcols: List[str]):
    """Split an arrow table by its partition-column tuples into
    (key=value/... subdirectory, table without the partition columns)
    pairs, in key order, rows in their order (Spark's dynamic-partition
    layout; NULL renders as __HIVE_DEFAULT_PARTITION__). The keys group
    in pandas, as the JAX package's do, so their directory names are
    its."""
    if not pcols:
        yield "", table
        return
    keys = table.select(pcols).to_pandas()
    data = table.drop_columns(pcols)
    for key, group in keys.groupby(pcols, dropna=False, sort=True):
        key = key if isinstance(key, tuple) else (key,)
        subdir = os.path.join(*[f"{c}={_render(v)}"
                                for c, v in zip(pcols, key)])
        yield subdir, data.take(group.index.to_numpy())


def _write_partitioned(tables, protocol: WriteCommitProtocol, task_id: int,
                       ext: str, fmt: str, pcols: List[str]) -> dict:
    """Write one task's tables; returns the write statistics the
    reference's BasicColumnarWriteJobStatsTracker reports (numFiles,
    numOutputRows, numOutputBytes) and the partition directories
    written (``partDirs``)."""
    import pyarrow as pa
    table = pa.concat_tables(tables)
    stats = {"numFiles": 0, "numOutputRows": 0, "numOutputBytes": 0}
    part_dirs = set()
    for subdir, tbl in _partition_subdirs(table, pcols):
        path = protocol.task_file(task_id, ext, subdir)
        _encode_table(tbl, path, fmt)
        stats["numFiles"] += 1
        stats["numOutputRows"] += tbl.num_rows
        stats["numOutputBytes"] += os.path.getsize(path)
        if subdir:
            part_dirs.add(subdir)
    stats["partDirs"] = part_dirs
    return stats


def _record_write_stats(ctx: ExecContext, op: str, st: dict,
                        state: dict) -> None:
    """One task's write statistics -> the query's metrics of ``op``.
    Callers hold state["lock"]. numParts (the distinct partition
    directories of all tasks) is added by _finish_write_task when the
    last task completes."""
    state["parts"] |= st.pop("partDirs", set())
    for k, v in st.items():
        ctx.metric_add(op, k, v)


def _finish_write_task(ctx: ExecContext, op: str, state: dict,
                       protocol: WriteCommitProtocol) -> None:
    """Last-task bookkeeping: count down under the lock, then commit and
    add numParts once, whether or not the last task wrote."""
    with state["lock"]:
        state["remaining"] -= 1
        done = state["remaining"] == 0 and not state["failed"]
        parts = len(state["parts"])
    if done:
        if parts:
            ctx.metric_add(op, "numParts", parts)
        protocol.commit()


class _WriteExec(PhysicalPlan):
    """One task a child partition: its tables (``_tables``) written as
    one file a partition directory, the job committed after the last
    task, aborted (and the error raised) where a task fails."""

    def __init__(self, child: PhysicalPlan, path: str, fmt: str,
                 mode: str = "error", partition_cols: List[str] = ()):
        super().__init__([child])
        self.path = path
        self.fmt = fmt
        self.mode = mode
        self.partition_cols = list(partition_cols)

    def output_schema(self) -> Schema:
        return Schema([], [])

    def describe(self) -> str:
        return f"{self.name}({self.fmt}, {self.path})"

    def _tables(self, part: Partition, schema: Schema) -> list:
        raise NotImplementedError

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        schema = self.children[0].output_schema()
        protocol = WriteCommitProtocol(self.path)
        protocol.setup(self.mode)
        ext = _EXTENSIONS[self.fmt]
        state = {"remaining": len(child_parts), "failed": False,
                 "parts": set(), "lock": threading.Lock()}
        op = self.describe()

        def make(i: int, part: Partition) -> Partition:
            def run() -> Iterator[pd.DataFrame]:
                try:
                    tables = self._tables(part, schema)
                    if tables:
                        st = _write_partitioned(tables, protocol, i, ext,
                                                self.fmt,
                                                self.partition_cols)
                        with state["lock"]:
                            _record_write_stats(ctx, op, st, state)
                except BaseException:
                    state["failed"] = True
                    protocol.abort()
                    raise
                _finish_write_task(ctx, op, state, protocol)
                yield pd.DataFrame()
            return run
        return [make(i, p) for i, p in enumerate(child_parts)]


class CpuWriteExec(_WriteExec):
    """Host path: pandas partition -> arrow -> file."""

    def _tables(self, part: Partition, schema: Schema) -> list:
        return [_arrow_table_from_pandas(df, schema)
                for df in part() if len(df)]


class TpuWriteExec(_WriteExec):
    """Columnar path: device batches -> arrow (one copy to the host) ->
    file (reference: ColumnarOutputWriter + GpuParquetFileFormat)."""

    columnar_output = False  # a terminal command: produces no batches
    columnar_input = True    # ...but consumes device batches

    def _tables(self, part: Partition, schema: Schema) -> list:
        tables = [_arrow_table_from_batch(b) for b in part()]
        return [t for t in tables if t.num_rows]


def _fits_dictionary(col, limit: int) -> bool:
    """Whether the distinct values of ``col`` take at most ``limit``
    bytes: counted over prefixes growing 4x from 2^16 rows, so a column
    that passes the limit early is decided on its first rows."""
    import pyarrow.compute as pc
    rows = 1 << 16
    while True:
        if pc.unique(col.slice(0, rows)).nbytes > limit:
            return False
        if rows >= len(col):
            return True
        rows <<= 2


def _dictionary_columns(table) -> List[str]:
    """The columns whose distinct values fit half of pyarrow's dictionary
    page limit, which no row group's dictionary then passes."""
    import pyarrow as pa
    return [name for name, col in zip(table.column_names, table.columns)
            if not pa.types.is_boolean(col.type)
            and _fits_dictionary(col, _DICT_PAGE_LIMIT // 2)]


def _encode_table(table, f: str, fmt: str) -> None:
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, f, use_dictionary=_dictionary_columns(table))
    elif fmt == "orc":
        import pyarrow.orc as paorc
        paorc.write_table(table, f)
    else:
        import pyarrow.csv as pacsv
        pacsv.write_csv(table, f)
