"""TPC-H queries over Parquet files on the device scan (the counterpart of
the JAX package's ``models/tpch.py`` queries over
``session.read.parquet`` with ``spark.rapids.sql.scan.deviceDecode`` on).

``scan_tables`` reads each table's columns with the device Parquet decode
(``sql/sources.ParquetSource`` -> ``sql/scan_pipeline`` ->
``exec/transitions.upload_partition``): one DeviceBatch per row group,
host planning of the next row groups overlapping the device decode of the
current one. The ``run_*_parquet`` drivers feed those batches to the same
``*_from_batches`` compositions as the pandas upload path
(``models/q1_step.py``, ``models/tpch_joins.py``) and return pandas.
``customer_segment_collect`` scans every customer column, string columns
included, filters on ``c_mktsegment`` and collects.

Files: ``models/tpch_data.write_parquet``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import pandas as pd

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, bucket_capacity
from spark_rapids_tpu_torch.exec.transitions import (
    upload_blocked_chars, upload_partition,
)
from spark_rapids_tpu_torch.models import q1_step as Q
from spark_rapids_tpu_torch.models import tpch_joins as J
from spark_rapids_tpu_torch.ops import rowops
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.scan_pipeline import DEFAULT_DEPTH
from spark_rapids_tpu_torch.sql.sources import ParquetSource

Tables = Dict[str, List[DeviceBatch]]


def scan_table(path: str, columns: Optional[Sequence[str]] = None,
               device="cuda", depth: int = DEFAULT_DEPTH,
               threads: Optional[int] = None) -> List[DeviceBatch]:
    """``columns`` of the Parquet file(s) at ``path`` (default: all), one
    DeviceBatch per row group, with one dictionary registry for the scan.
    ``depth`` row groups are planned ahead on ``threads`` threads (0: plan
    each on this thread when it is decoded)."""
    src = ParquetSource(path)
    if columns is not None:
        src = src.with_columns(list(columns))
    dict_state: dict = {}
    return [batch
            for part in src.raw_partitions(upload_blocked_chars(), depth,
                                           threads)
            for batch in upload_partition(part, src.schema, dict_state,
                                          device)]


def scan_tables(paths: Dict[str, str], columns: Dict[str, Sequence[str]],
                device="cuda", depth: int = DEFAULT_DEPTH,
                threads: Optional[int] = None) -> Tables:
    """``scan_table`` of each table named in ``columns``."""
    return {name: scan_table(paths[name], cols, device, depth, threads)
            for name, cols in columns.items()}


def collect(batches: Sequence[DeviceBatch]) -> pd.DataFrame:
    """The rows of a scan's batches as one pandas frame (one concat on the
    device, then the collect)."""
    out = rowops.concat_batches(
        batches, bucket_capacity(sum(b.capacity for b in batches)))
    return out.to_pandas()


def run_q1_parquet(path: str, device="cuda") -> pd.DataFrame:
    return Q.q1_from_batches(scan_table(path, Q.Q1_COLUMNS,
                                        device)).to_pandas()


def run_q6_parquet(path: str, device="cuda") -> pd.DataFrame:
    return Q.q6_from_batches(scan_table(path, Q.Q6_COLUMNS,
                                        device)).to_pandas()


def run_q18_agg_parquet(path: str, device="cuda") -> pd.DataFrame:
    """The Q18 group-by's having rows (``sum_qty > 300``)."""
    _grouped, having = Q.q18_agg_from_batches(
        scan_table(path, Q.Q18_COLUMNS, device))
    return having.to_pandas()


def run_q3_parquet(paths: Dict[str, str], device="cuda") -> pd.DataFrame:
    """TPC-H Q3 over the ``customer``, ``orders`` and ``lineitem`` files."""
    return J.q3_from_batches(scan_tables(paths, J.Q3_COLUMNS,
                                         device)).to_pandas()


def run_q4_parquet(paths: Dict[str, str], device="cuda") -> pd.DataFrame:
    """TPC-H Q4 over the ``orders`` and ``lineitem`` files."""
    return J.q4_from_batches(scan_tables(paths, J.Q4_COLUMNS,
                                         device)).to_pandas()


def customer_segment_batches(batches: Sequence[DeviceBatch],
                             segment: str = "BUILDING") -> DeviceBatch:
    """The customer rows of ``segment``, every column, in one batch."""
    kept = [Q.filter_rows(b, F.col("c_mktsegment") == segment)
            for b in batches]
    return rowops.concat_batches(
        kept, bucket_capacity(sum(b.capacity for b in kept)))


def customer_segment_collect(path: str, segment: str = "BUILDING",
                             device="cuda") -> pd.DataFrame:
    """Scan all customer columns, keep ``c_mktsegment = segment``,
    collect."""
    return customer_segment_batches(scan_table(path, device=device),
                                    segment).to_pandas()
