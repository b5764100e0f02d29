"""Host -> device transition of a file scan (the device-decode branch of the
JAX package's ``exec/transitions.upload_partition``).

``upload_partition`` turns one scan partition into DeviceBatches: a
``RawRowGroup`` decode plan goes through ``ops/parquet_decode
.decode_rowgroup`` (one host-to-device copy, then the decode kernels), one
DeviceBatch per row group at ``bucket_capacity(rows)``. A split whose
columns all fell back to the host arrives as a pandas frame and takes the
same upload, every column as a host-decoded one. The JAX package's device
scan cache, HBM metering, double-buffered pandas upload and re-chunking to
a batch size are not ported.
"""

from __future__ import annotations

from typing import Iterator, Optional

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.ops.parquet_decode import (
    RawRowGroup, decode_rowgroup,
)
from spark_rapids_tpu_torch.sql.scan_pipeline import Partition

# widest per-row byte stride of a char slab (the JAX package's default
# spark.rapids.sql.dict.blockedChars.maxStride)
MAX_SLAB_STRIDE = 64


def upload_blocked_chars() -> int:
    """Max byte stride of the char-slab layout for plain string columns."""
    return MAX_SLAB_STRIDE


def _as_rowgroup(df, schema: Schema) -> RawRowGroup:
    """A host-decoded split as a RawRowGroup whose columns all fell back."""
    raw = RawRowGroup(len(df))
    raw.fallback = [(name, "host") for name in schema.names]
    raw.fallback_df = df
    return raw


def upload_partition(part: Partition, schema: Schema,
                     dict_state: Optional[dict],
                     device="cuda") -> Iterator[DeviceBatch]:
    """DeviceBatches of one scan partition. ``dict_state`` is shared by
    every partition of one scan, so all its batches agree on each string
    column's dictionary and slab stride."""
    for split in part():
        raw = split if getattr(split, "is_raw_rowgroup", False) \
            else _as_rowgroup(split, schema)
        yield decode_rowgroup(raw, schema, dict_state, device)
