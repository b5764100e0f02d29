"""Test helpers that carry data between the JAX package and the port.

``batch_from_reference`` builds a port DeviceBatch from a JAX package
DeviceBatch's host buffers and dictionaries, so that both packages run on
identical codes. It reads the batch through its attributes and
``numpy.asarray`` and imports nothing of the JAX package (nor JAX).
``batch_to_numpy`` is the port-side counterpart for comparing outputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


def batch_from_reference(ref_batch, device="cpu") -> DeviceBatch:
    """Port DeviceBatch holding the same buffers as the JAX package's
    ``ref_batch`` (same capacity, validity, data, dictionary codes and
    values). Plain (non-dictionary) string columns are not ported and
    raise NotImplementedError."""
    device = torch.device(device)
    names = list(ref_batch.schema.names)
    dts = [dtypes.by_name(d.name) for d in ref_batch.schema.dtypes]
    cols = []
    for dt, c in zip(dts, ref_batch.columns):
        # copies: the reference's host views are read-only
        data = None if dt.is_string else np.array(c.data)
        codes = None if c.dict_values is None else np.array(c.dict_codes)
        cols.append(DeviceColumn.from_host_buffers(
            dt, data, np.array(c.validity), codes, c.dict_values, device))
    num_rows = torch.tensor(int(np.asarray(ref_batch.num_rows)),
                            dtype=torch.int32, device=device)
    return DeviceBatch(Schema(names, dts), cols, num_rows)


def batch_to_numpy(batch: DeviceBatch) -> Dict[str, Tuple[np.ndarray,
                                                          np.ndarray]]:
    """{column name: (values, validity)} over the live rows; string values
    decode to python str (None where null)."""
    n = int(batch.num_rows.item())
    return {name: col.to_numpy(n)
            for name, col in zip(batch.schema.names, batch.columns)}
