"""Test helpers that carry data between the JAX package and the port.

``batch_from_reference`` builds a port DeviceBatch from a JAX package
DeviceBatch's host buffers and dictionaries, so that both packages run on
identical codes. It reads the batch through its attributes and
``numpy.asarray`` and imports nothing of the JAX package (nor JAX).
``batch_same_forms`` keeps every string column in the reference's own form
(dictionary, slab or plain chars), for comparisons that depend on it (the
shuffle wire's frames). ``batch_to_numpy`` is the port-side counterpart
for comparing outputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, np_build_slab, slab_stride_for,
)


def batch_from_reference(ref_batch, device="cpu") -> DeviceBatch:
    """Port DeviceBatch holding the same buffers as the JAX package's
    ``ref_batch`` (same capacity, validity, data, dictionary codes and
    values). A string column without a dictionary arrives in the form the
    port's upload would give it: the reference's slab as it is; its packed
    chars as a slab at the power-of-two stride of the longest value where
    that fits the upload's stride limit (``upload_blocked_chars``), else as
    the same plain offsets and chars."""
    device = torch.device(device)
    names = list(ref_batch.schema.names)
    dts = [dtypes.by_name(d.name) for d in ref_batch.schema.dtypes]
    cols = []
    for dt, c in zip(dts, ref_batch.columns):
        # copies: the reference's host views are read-only
        validity = np.array(c.validity)
        if dt.is_string and c.dict_values is None:
            plain = _plain_of(c, validity)
            if plain is not None:
                chars, offsets = plain
                cols.append(DeviceColumn(
                    dt, None, torch.from_numpy(validity).to(device),
                    chars=torch.from_numpy(chars).to(device),
                    offsets=torch.from_numpy(offsets).to(device)))
                continue
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


def batch_same_forms(ref_batch, device="cpu") -> DeviceBatch:
    """Port DeviceBatch holding ``ref_batch``'s buffers in its forms: a
    dictionary string column as its codes and values, a slab as its words
    and lengths, packed chars as the same offsets and chars, a fixed-width
    column as its data (a numeric column's dictionary is not carried)."""
    device = torch.device(device)
    dts = [dtypes.by_name(d.name) for d in ref_batch.schema.dtypes]

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)
    cols = []
    for dt, c in zip(dts, ref_batch.columns):
        valid = t(c.validity)
        if dt.is_string and c.dict_values is not None:
            cols.append(DeviceColumn(dt, None, valid,
                                     dict_codes=t(c.dict_codes),
                                     dict_values=c.dict_values))
        elif dt.is_string and c.has_slab:
            cols.append(DeviceColumn(
                dt, None, valid,
                slab64=t(np.asarray(c._slab64).view(np.int64)),
                lens=t(c._lens)))
        elif dt.is_string:
            cols.append(DeviceColumn(dt, None, valid, chars=t(c.data),
                                     offsets=t(c.offsets)))
        else:
            cols.append(DeviceColumn(dt, t(c.data), valid))
    num_rows = torch.tensor(int(np.asarray(ref_batch.num_rows)),
                            dtype=torch.int32, device=device)
    return DeviceBatch(Schema(list(ref_batch.schema.names), dts), cols,
                       num_rows)


def _plain_of(ref_col, validity: np.ndarray):
    """(chars, offsets) of a reference packed string column whose longest
    value passes the upload's slab limit (invalid rows emptied), else
    None."""
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    if ref_col.has_slab:
        return None
    offsets = np.array(ref_col.offsets).astype(np.int32)
    lens = np.where(validity, offsets[1:] - offsets[:-1], 0)
    if slab_stride_for(int(lens.max(initial=0)), upload_blocked_chars()):
        return None
    chars = np.array(ref_col.data).astype(np.uint8)
    starts = offsets[:-1].astype(np.int64)
    new_off = np.zeros(len(lens) + 1, np.int32)
    new_off[1:] = np.cumsum(lens)
    out = np.zeros(max(int(new_off[-1]), 1), np.uint8)
    for i in np.flatnonzero(lens):
        out[new_off[i]:new_off[i + 1]] = chars[starts[i]:starts[i] + lens[i]]
    return out, new_off


def _slab_of(ref_col, validity: np.ndarray):
    """(uint64 slab, int32 lens) of a reference string column without a
    dictionary; lens are 0 on invalid rows, as the port's upload sets."""
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    if ref_col.has_slab:
        slab = np.array(ref_col._slab64).astype(np.uint64)
        lens = np.array(ref_col.lens_()).astype(np.int32)
    else:
        offsets = np.array(ref_col.offsets).astype(np.int32)
        chars = np.array(ref_col.data).astype(np.uint8)
        lens = offsets[1:] - offsets[:-1]
        stride = slab_stride_for(int(lens.max(initial=0)),
                                 upload_blocked_chars())
        slab, lens = np_build_slab(chars, offsets, len(validity), stride)
    return slab, np.where(validity, lens, 0).astype(np.int32)


def batch_to_numpy(batch: DeviceBatch) -> Dict[str, Tuple[np.ndarray,
                                                          np.ndarray]]:
    """{column name: (values, validity)} over the live rows; string values
    decode to python str (None where null)."""
    n = int(batch.num_rows.item())
    return {name: col.to_numpy(n)
            for name, col in zip(batch.schema.names, batch.columns)}
