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
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, np_build_slab, plain_strings_unsupported, slab_stride_for,
)


def batch_from_reference(ref_batch, device="cpu") -> DeviceBatch:
    """Port DeviceBatch holding the same buffers as the JAX package's
    ``ref_batch`` (same capacity, validity, data, dictionary codes and
    values). A string column without a dictionary arrives as a char slab,
    as the port's upload makes one: the reference's slab as it is, or its
    packed chars laid out at the stride the upload would choose (a value
    longer than the widest slab raises NotImplementedError, as the upload
    does)."""
    device = torch.device(device)
    names = list(ref_batch.schema.names)
    dts = [dtypes.by_name(d.name) for d in ref_batch.schema.dtypes]
    cols = []
    for dt, c in zip(dts, ref_batch.columns):
        # copies: the reference's host views are read-only
        validity = np.array(c.validity)
        if dt.is_string and c.dict_values is None:
            slab, lens = _slab_of(c, validity)
            cols.append(DeviceColumn(
                dt, None, torch.from_numpy(validity).to(device),
                slab64=torch.from_numpy(slab.view(np.int64)).to(device),
                lens=torch.from_numpy(lens).to(device)))
            continue
        data = None if dt.is_string else np.array(c.data)
        codes = None if c.dict_values is None else np.array(c.dict_codes)
        cols.append(DeviceColumn.from_host_buffers(
            dt, data, validity, codes, c.dict_values, device))
    num_rows = torch.tensor(int(np.asarray(ref_batch.num_rows)),
                            dtype=torch.int32, device=device)
    return DeviceBatch(Schema(names, dts), cols, num_rows)


def _slab_of(ref_col, validity: np.ndarray):
    """(uint64 slab, int32 lens) of a reference string column without a
    dictionary; lens are 0 on invalid rows, as the port's upload sets."""
    from spark_rapids_tpu_torch.exec.transitions import MAX_SLAB_STRIDE
    if ref_col.has_slab:
        slab = np.array(ref_col._slab64).astype(np.uint64)
        lens = np.array(ref_col.lens_()).astype(np.int32)
    else:
        offsets = np.array(ref_col.offsets).astype(np.int32)
        chars = np.array(ref_col.data).astype(np.uint8)
        lens = offsets[1:] - offsets[:-1]
        stride = slab_stride_for(int(lens.max(initial=0)), MAX_SLAB_STRIDE)
        if not stride:
            raise plain_strings_unsupported("a string longer than a slab")
        slab, lens = np_build_slab(chars, offsets, len(validity), stride)
    return slab, np.where(validity, lens, 0).astype(np.int32)


def batch_to_numpy(batch: DeviceBatch) -> Dict[str, Tuple[np.ndarray,
                                                          np.ndarray]]:
    """{column name: (values, validity)} over the live rows; string values
    decode to python str (None where null)."""
    n = int(batch.num_rows.item())
    return {name: col.to_numpy(n)
            for name, col in zip(batch.schema.names, batch.columns)}
