"""Self-describing contiguous columnar wire format (counterpart of the JAX
package's ``shuffle/wire.py``; the same frames, byte for byte).

The JCudfSerialization equivalent (reference call sites:
GpuColumnarBatchSerializer.scala:84-212 writeToStream/readTableFrom): a
header describing schema + buffer extents, followed by the raw column
buffers back to back.

Layout (little-endian):
  magic   u32  0x54505543 ('TPUC')
  version u32
  nrows   u32
  ncols   u32
  per column:
    name_len u16, name utf-8 bytes
    dtype_len u8, dtype name bytes
    data_len u64, validity_len u64, offsets_len u64
  then per column: data bytes, validity bytes, offsets bytes

Version 2 (``spark.rapids.sql.dict.wire``) adds a ``kind`` byte per
column after the dtype name: 0 = plain (v1 layout), 1 = dictionary-encoded
string — ``data`` then carries int32 CODES, ``offsets_len`` covers a
values blob (u32 count, then per value u32 len + utf-8 bytes) instead of
an offsets vector, and the reduce side rebuilds the column codes-only. A
frame is only written as v2 when it contains a dictionary column.

Where the JAX package reads each column to the host with its own
``np.asarray`` (one wait each), ``serialize_batch`` reads the batch's live
rows in ONE counted ``exchange.wire`` scope (detail ``serialize``): a
small read of the row count and each plain string column's char total,
then every live buffer copied at once (into pinned memory on a CUDA
device) and one wait for the stream. A char slab packs into chars and
offsets on the host and a dictionary column under ``dict.wire=false``
rebuilds its chars on the host from the codes, as in the JAX package.
``deserialize_batch`` uploads a frame's buffers through pinned memory,
stream-ordered, so it makes no host wait; the batch carries its row count
on the host. The JAX package's native frame writer
(``native/src/tpu_native.cpp``) is not ported: its Python path, this one,
writes byte-identical frames.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, char_bucket, host_to_device, is_dict, is_plain, is_slab,
    np_slab_to_packed,
)

MAGIC = 0x54505543
VERSION = 1


def serialize_host_table(schema: Schema, num_rows: int,
                         columns: List[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]) -> bytes:
    """columns: per column (data, validity, offsets-or-None) numpy arrays
    already trimmed to num_rows (strings: offsets has num_rows+1, data has
    offsets[-1] chars). A v1 frame."""
    head = [struct.pack("<IIII", MAGIC, VERSION, num_rows, len(schema))]
    bufs = []
    for (name, dt), (data, validity, offsets) in zip(
            zip(schema.names, schema.dtypes), columns):
        nb = name.encode("utf-8")
        db = dt.name.encode("ascii")
        data_b = data.tobytes()
        val_b = np.packbits(validity.astype(np.bool_),
                            bitorder="little").tobytes()
        off_b = offsets.tobytes() if offsets is not None else b""
        head.append(struct.pack("<H", len(nb)) + nb)
        head.append(struct.pack("<B", len(db)) + db)
        head.append(struct.pack("<QQQ", len(data_b), len(val_b), len(off_b)))
        bufs.extend((data_b, val_b, off_b))
    return b"".join(head + bufs)


def _np_dict_packed(dict_values: tuple, codes: np.ndarray,
                    validity: np.ndarray, n: int):
    """Host-side packed chars+offsets of a dictionary column's first ``n``
    rows, rebuilt from fetched CODES through the static dictionary (the
    v1 spelling when dict.wire is off)."""
    codes = np.asarray(codes[:n], dtype=np.int32)
    validity = np.asarray(validity[:n])
    vals_b = [v.encode("utf-8") for v in dict_values]
    card = len(vals_b)
    lens_tab = np.asarray([len(v) for v in vals_b] + [0], np.int64)
    starts_tab = np.zeros(card + 1, np.int64)
    starts_tab[1:] = np.cumsum(lens_tab[:-1])
    dchars = np.frombuffer(b"".join(vals_b) or b"\0", np.uint8)
    code_c = np.clip(codes, 0, card)
    lens = np.where(validity, lens_tab[code_c], 0)
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lens).astype(np.int32)
    # one table gather over (n, maxlen), no per-row Python loop
    maxlen = int(lens_tab[:card].max()) if card else 0
    if n and maxlen:
        j = np.arange(maxlen)
        idx = np.clip(starts_tab[code_c][:, None] + j[None, :], 0,
                      len(dchars) - 1)
        mask = j[None, :] < lens[:, None]
        chars = np.ascontiguousarray(dchars[idx][mask])
    else:
        chars = np.empty(0, np.uint8)
    return chars, validity, offsets


def _dict_values_blob(values: tuple) -> bytes:
    parts = [struct.pack("<I", len(values))]
    for v in values:
        raw = v.encode("utf-8")
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _dict_values_unblob(blob) -> tuple:
    (count,) = struct.unpack_from("<I", blob, 0)
    pos = 4
    out = []
    for _ in range(count):
        (ln,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        out.append(bytes(blob[pos:pos + ln]).decode("utf-8"))
        pos += ln
    return tuple(out)


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of device tensors. On a CUDA device every copy is
    queued into pinned memory and the stream waited on once; the caller
    holds the sync scope."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in hosts]


def _fetch_live(batch: DeviceBatch):
    """(n, per column its host buffers): the row count and the live
    buffers of every column, inside the caller's scope."""
    plain = [c for c in batch.columns if c.dtype.is_string and is_plain(c)]
    n = batch.host_rows
    if plain or n is None:
        # the row count and each plain column's char total in one read
        nr = batch.num_rows.to(torch.int64).reshape(1)
        head = [nr] + [torch.index_select(c.offsets, 0, nr).to(torch.int64)
                       for c in plain]
        got = _to_host([torch.cat(head)])[0]
        n = int(got[0])
        totals = [int(t) for t in got[1:]]
    else:
        totals = []
    tensors: List[torch.Tensor] = []
    layout = []
    it = iter(totals)
    for col in batch.columns:
        if col.dtype.is_string and is_dict(col):
            parts = (col.dict_codes[:n], col.validity[:n])
            kind = "dict"
        elif col.dtype.is_string and is_slab(col):
            parts = (col.slab64[:n], col.lens[:n], col.validity[:n])
            kind = "slab"
        elif col.dtype.is_string:
            total = next(it)
            parts = (col.offsets[:n + 1], col.chars[:total if n else 0],
                     col.validity[:n])
            kind = "plain"
        else:
            parts = (col.data[:n], col.validity[:n])
            kind = "fixed"
        layout.append((kind, len(tensors), len(parts)))
        tensors.extend(parts)
    host = _to_host([t.contiguous() for t in tensors])
    return n, [(kind, host[at:at + k]) for kind, at, k in layout]


def serialize_batch(batch: DeviceBatch) -> bytes:
    """Device batch -> wire bytes: the live rows read in one counted
    ``exchange.wire`` scope, the frame assembled on the host."""
    from spark_rapids_tpu_torch.columnar import dictionary as dict_mod
    from spark_rapids_tpu_torch.obs.syncledger import sync_scope
    with sync_scope("exchange.wire", detail="serialize") as sc:
        n, host = _fetch_live(batch)
        sc.add_bytes(sum(a.nbytes for _k, parts in host for a in parts))
    dict_wire = dict_mod.wire_enabled()
    cols = []
    kinds = []
    for col, (kind, parts) in zip(batch.columns, host):
        if kind == "dict":
            codes, validity = parts
            if dict_wire:
                cols.append((np.ascontiguousarray(codes, dtype=np.int32),
                             validity, ("dict", col.dict_values)))
                kinds.append(1)
                continue
            cols.append(_np_dict_packed(col.dict_values, codes, validity, n))
        elif kind == "slab":
            slab, lens, validity = parts
            chars, offsets = np_slab_to_packed(slab.view(np.uint64), lens,
                                               validity)
            cols.append((chars, validity, offsets))
        elif kind == "plain":
            offsets, chars, validity = parts
            cols.append((chars, validity,
                         np.asarray(offsets, dtype=np.int32)))
        else:
            data, validity = parts
            cols.append((np.ascontiguousarray(data), validity, None))
        kinds.append(0)
    if any(kinds):
        return _serialize_v2(batch.schema, n, cols, kinds)
    return serialize_host_table(batch.schema, n, cols)


def _serialize_v2(schema: Schema, num_rows: int, columns, kinds) -> bytes:
    head = [struct.pack("<IIII", MAGIC, 2, num_rows, len(schema))]
    bufs = []
    for (name, dt), (data, validity, offsets), kind in zip(
            zip(schema.names, schema.dtypes), columns, kinds):
        nb = name.encode("utf-8")
        db = dt.name.encode("ascii")
        data_b = data.tobytes()
        val_b = np.packbits(validity.astype(np.bool_),
                            bitorder="little").tobytes()
        if kind == 1:
            off_b = _dict_values_blob(offsets[1])
        else:
            off_b = offsets.tobytes() if offsets is not None else b""
        head.append(struct.pack("<H", len(nb)) + nb)
        head.append(struct.pack("<B", len(db)) + db)
        head.append(struct.pack("<B", kind))
        head.append(struct.pack("<QQQ", len(data_b), len(val_b), len(off_b)))
        bufs.extend((data_b, val_b, off_b))
    return b"".join(head + bufs)


def deserialize_table(buf: bytes):
    """wire bytes -> (schema, num_rows, [(data, validity, offsets)])
    with numpy arrays viewing ``buf`` zero-copy."""
    mv = memoryview(buf)
    magic, version, nrows, ncols = struct.unpack_from("<IIII", mv, 0)
    # the JAX package's exception type, raised also under python -O
    if magic != MAGIC:
        raise AssertionError("bad magic in shuffle payload")
    if version not in (VERSION, 2):
        raise AssertionError(f"unsupported wire version {version}")
    pos = 16
    names, dts, extents, kinds = [], [], [], []
    for _ in range(ncols):
        (nlen,) = struct.unpack_from("<H", mv, pos); pos += 2
        names.append(bytes(mv[pos:pos + nlen]).decode("utf-8")); pos += nlen
        (dlen,) = struct.unpack_from("<B", mv, pos); pos += 1
        dts.append(dtypes.by_name(bytes(mv[pos:pos + dlen]).decode("ascii")))
        pos += dlen
        if version >= 2:
            (kind,) = struct.unpack_from("<B", mv, pos); pos += 1
        else:
            kind = 0
        kinds.append(kind)
        extents.append(struct.unpack_from("<QQQ", mv, pos)); pos += 24
    cols = []
    for dt, kind, (data_len, val_len, off_len) in zip(dts, kinds, extents):
        if kind == 1:
            data = np.frombuffer(mv, dtype=np.int32, count=data_len // 4,
                                 offset=pos)
        elif dt.is_string:
            data = np.frombuffer(mv, dtype=np.uint8, count=data_len,
                                 offset=pos)
        else:
            data = np.frombuffer(mv, dtype=dt.np_dtype,
                                 count=data_len // dt.np_dtype.itemsize,
                                 offset=pos)
        pos += data_len
        packed = np.frombuffer(mv, dtype=np.uint8, count=val_len, offset=pos)
        validity = np.unpackbits(packed, bitorder="little")[:nrows] \
            .astype(np.bool_)
        pos += val_len
        offsets = None
        if off_len:
            if kind == 1:
                # a dictionary column: the third buffer is the values blob,
                # surfaced as ("dict", values) for a codes-only rebuild
                offsets = ("dict", _dict_values_unblob(mv[pos:pos + off_len]))
            else:
                offsets = np.frombuffer(mv, dtype=np.int32,
                                        count=off_len // 4, offset=pos)
            pos += off_len
        cols.append((data, validity, offsets))
    return Schema(names, dts), nrows, cols


def deserialize_batch(buf: bytes, device="cuda") -> DeviceBatch:
    """wire bytes -> device batch on ``device``: every buffer uploaded
    through pinned memory, stream-ordered (no host wait); the batch knows
    its row count on the host. A v1 string column arrives plain (offsets
    and chars), a v2 dictionary column codes-only."""
    schema, nrows, cols = deserialize_table(buf)
    cap = bucket_capacity(max(nrows, 1))
    out = []
    for dt, (data, validity, offsets) in zip(schema.dtypes, cols):
        vpad = np.zeros(cap, np.bool_)
        vpad[:nrows] = validity
        valid = host_to_device(vpad, device)
        if isinstance(offsets, tuple) and offsets and offsets[0] == "dict":
            values = offsets[1]
            card = len(values)
            codes = np.full(cap, card, np.int32)
            codes[:nrows] = data
            codes[:nrows][~validity] = card
            out.append(DeviceColumn(dt, None, valid,
                                    dict_codes=host_to_device(codes, device),
                                    dict_values=values))
            continue
        if dt.is_string:
            chars = np.zeros(char_bucket(max(len(data), 1)), np.uint8)
            chars[:len(data)] = data
            offs = np.zeros(cap + 1, np.int32)
            offs[:nrows + 1] = offsets
            offs[nrows + 1:] = offs[nrows]
            out.append(DeviceColumn(dt, None, valid,
                                    chars=host_to_device(chars, device),
                                    offsets=host_to_device(offs, device)))
        else:
            dpad = np.zeros(cap, dt.np_dtype)
            dpad[:nrows] = data
            out.append(DeviceColumn(dt, host_to_device(dpad, device), valid))
    batch = DeviceBatch(schema, out, torch.full((), nrows, dtype=torch.int32,
                                                device=device))
    batch.host_rows = nrows
    return batch
