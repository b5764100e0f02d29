"""Device Parquet decode: raw pages -> DeviceBatch (counterpart of the JAX
package's ``ops/parquet_decode.py``).

A row group's decode is split across the two sides of the scan pipeline:

  * ``prepare_rowgroup`` runs on a planning thread (``sql/scan_pipeline``):
    it reads the raw column-chunk bytes (``sql/parquet_raw``), splits and
    decompresses the pages, and builds per-column DECODE PLANS: small numpy
    run tables plus the encoded streams as u32 word buffers. Host work is
    byte shuffling plus O(#runs) header parsing; no value is decoded on the
    host. A column the device path cannot take falls back to pyarrow's host
    decode for that column, with a reason (``_Unsupported``: codec,
    ``pageV2``, ``mixedEncoding``, ``deltaWide`` ...), counted in
    ``scan.device.fallbackColumns`` and journaled as a
    ``scanDeviceFallback`` event (once per file, column and reason in a
    bounded memo, as in the JAX package). The plans are the JAX package's, array
    for array.
  * ``decode_rowgroup`` runs on the consuming thread: it copies every
    plan's buffers to the device in ONE pinned host-to-device copy (inside
    ``sync_scope("scan.upload")``, one per row group, its seconds reported
    as ``note_transfer("h2d")``), then expands them
    with kernels B5-B8 (``ops/kernels``) into the port's column forms:
    dictionary codes, char slabs, dense fixed-width tensors. Every size is
    known on the host from the plans, so the decode makes no host sync.

Where the JAX package launches ``delta_unpack`` once per page, the port
merges a chunk's page tables (``delta_chunk_table``) and decodes all of a
row group's DELTA chunks in one launch. A planning error raises: only the
reasons above fall back.

A split's hive partition values (``RawRowGroup.pvals``) become columns
after the data columns, built on the device as constants with no host
buffer uploaded (``partition_column``): a string value is a dictionary of
that one value with every code 0, a number a ``torch.full``, a NULL an
all-invalid mask. The encoded-page cache (``memory/spill.EncodedPageCache``,
the session's ``page_cache``) keeps each column chunk's decode plan by
(path, file stamp, row group, column): ``prepare_rowgroup`` takes a plan
from it instead of reading the file, and ``decode_rowgroup`` takes a
promoted plan's device buffers instead of uploading them, or promotes the
buffers it uploaded. With the cache, each column's buffers upload into a
device allocation of their own (one host-to-device copy a column, still
one counted sync a row group), so that a column dropped from the device
tier frees its bytes. The JAX package reaches its cache only under
``scan.deviceDecode``, off there by default; every device scan of the
port reaches it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, _pandas_to_numpy, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.column import (
    DICT_MAX_CARD, MAX_SLAB_STRIDE, DeviceColumn, as_plain,
    host_string_packed, host_string_slab, host_to_device, np_build_slab,
    slab_stride_for,
)
from spark_rapids_tpu_torch.obs import compileledger
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.sql import parquet_raw as praw

_DEV_BYTES = REGISTRY.counter("scan.device.bytesDevice")
_HOST_BYTES = REGISTRY.counter("scan.device.bytesHost")
_DEV_COLS = REGISTRY.counter("scan.device.columns")
_FB_COLS = REGISTRY.counter("scan.device.fallbackColumns")
_DEV_SPLITS = REGISTRY.counter("scan.device.splits")
_DEC_TIME = REGISTRY.timer("scan.device.decodeTime")
_HOST_DEC_TIME = REGISTRY.timer("scan.device.hostDecodeTime")
_PREP_TIME = REGISTRY.timer("scan.device.prepTime")

# (path, column, reason) already journaled: one scanDeviceFallback event
# each, not one per row group
_EMITTED: Dict[tuple, bool] = {}
_EMITTED_CAP = 4096


def _note_fallback(path: str, column: str, reason: str, rg: int) -> None:
    _FB_COLS.add(1)
    key = (path, column, reason)
    if key in _EMITTED:
        return
    if len(_EMITTED) >= _EMITTED_CAP:
        _EMITTED.clear()
    _EMITTED[key] = True
    EVENTS.emit("scanDeviceFallback", column=column, reason=reason,
                path=path, rowGroup=rg)

_FIXED_KINDS = {"INT32": ("i32", 4), "INT64": ("i64", 8),
                "FLOAT": ("f32", 4), "DOUBLE": ("f64", 8)}

_DICT_ENCODINGS = (praw.ENC_PLAIN_DICTIONARY, praw.ENC_RLE_DICTIONARY)

_INT32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# Host side: decode plans (copies of the JAX package's numpy code)
# ---------------------------------------------------------------------------

def _words_u8(parts: List[bytes]) -> Tuple[np.ndarray, List[int]]:
    """Concatenate byte streams into one u32 word buffer (8 pad bytes so
    every u64 window load lands in bounds). Returns (words, per-part
    byte offsets)."""
    offs, total = [], 0
    for p in parts:
        offs.append(total)
        total += len(p)
    buf = b"".join(parts) + b"\0" * (((-total) % 4) + 8)
    return np.frombuffer(buf, np.uint32).copy(), offs


def _pad1(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    out = np.full(cap, fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def _pad_run_table(tbl: dict) -> dict:
    """Guard row past the real runs: decode runs at output length = the
    capacity bucket, so the run search must have somewhere sane to land
    for padding rows (values there are masked anyway)."""
    r = len(tbl["kind"])
    return {
        "out_start": np.concatenate(
            [tbl["out_start"], np.asarray([_INT32_MAX], np.int32)]),
        "kind": _pad1(tbl["kind"], r + 1),
        "value": _pad1(tbl["value"], r + 1),
        "bit_start": _pad1(tbl["bit_start"], r + 1),
        "bw": _pad1(tbl["bw"], r + 1),
    }


def _count_level_ones(levels: bytes, num_values: int) -> int:
    """Non-null count of a max_def=1 page from its def-level hybrid
    stream, O(#runs) + popcount over bit-packed spans (the format
    zero-pads partial groups, so popcount is exact)."""
    pos = 0
    out = 0
    ones = 0
    while out < num_values and pos < len(levels):
        header, pos = praw._uvarint(levels, pos)
        if header & 1:
            groups = header >> 1
            span = levels[pos:pos + groups]
            pos += groups
            take = min(groups * 8, num_values - out)
            ones += int(np.unpackbits(
                np.frombuffer(span, np.uint8)).sum())
            out += take
        else:
            count = header >> 1
            v = levels[pos] if pos < len(levels) else 0
            pos += 1
            take = min(count, num_values - out)
            if v & 1:
                ones += take
            out += take
    return min(ones, num_values)


class _Unsupported(Exception):
    """A column chunk the device path does not take, with the reason."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _split_page(chunk, page) -> Tuple[Optional[bytes], bytes]:
    if chunk.max_def == 0:
        return None, page.payload
    n = int.from_bytes(page.payload[:4], "little")
    return page.payload[4:4 + n], page.payload[4 + n:]


def _plan_levels(chunk) -> Tuple[dict, List[int], List[bytes]]:
    """(levels plan-part, per-page non-null counts, per-page value
    streams)."""
    nns: List[int] = []
    streams: List[bytes] = []
    if chunk.max_def == 0:
        for pg in chunk.pages:
            nns.append(pg.num_values)
            streams.append(pg.payload)
        return {}, nns, streams
    lv_parts: List[bytes] = []
    tables: List[dict] = []
    for pg in chunk.pages:
        lv, rest = _split_page(chunk, pg)
        streams.append(rest)
        nns.append(_count_level_ones(lv, pg.num_values))
        lv_parts.append(lv)
    words, offs = _words_u8(lv_parts)
    for lv, off, pg in zip(lv_parts, offs, chunk.pages):
        tables.append(praw.hybrid_run_table(lv, 1, pg.num_values,
                                            base_bit=off * 8))
    tbl = _pad_run_table(praw.merge_run_tables(
        tables, [pg.num_values for pg in chunk.pages]))
    return {"lv_words": words, **{f"lv_{k}": v for k, v in tbl.items()}}, \
        nns, streams


def _plan_codes(streams: List[bytes], nns: List[int]) -> dict:
    """Dictionary-index streams ([bw byte][hybrid]) -> merged run
    table + word buffer (cd_*)."""
    bodies = [s[1:] for s in streams]
    words, offs = _words_u8(bodies)
    tables = []
    for s, off, nn in zip(streams, offs, nns):
        bw = s[0] if s else 0
        if bw > 32:
            raise _Unsupported("dictWide")
        t = praw.hybrid_run_table(s[1:], bw, nn, base_bit=off * 8)
        tables.append(t)
    tbl = _pad_run_table(praw.merge_run_tables(tables, nns))
    return {"cd_words": words, **{f"cd_{k}": v for k, v in tbl.items()}}


def plan_column(chunk: "praw.RawColumnChunk", dt, arrow_type,
                blocked: int) -> dict:
    """One column chunk -> decode plan: {"kind", "upload": {name: np
    array}, "meta": {...}}. Raises _Unsupported(reason) when the chunk
    must ride the host path."""
    if chunk.unsupported:
        raise _Unsupported(chunk.unsupported)
    if chunk.max_rep > 0:
        raise _Unsupported("nested")
    if chunk.max_def > 1:
        raise _Unsupported("defLevels")
    if not chunk.pages:
        raise _Unsupported("empty")
    pt = chunk.physical_type
    encs = {pg.encoding for pg in chunk.pages}
    is_dict = bool(encs & set(_DICT_ENCODINGS))
    if is_dict and not encs <= set(_DICT_ENCODINGS):
        # the writer overflowed its dictionary mid-chunk and switched the
        # remaining pages to PLAIN: decodable only column-at-a-time on
        # the host
        raise _Unsupported("mixedEncoding")
    if is_dict and chunk.dict_page is None:
        raise _Unsupported("noDictPage")
    if not is_dict and len(encs) > 1:
        raise _Unsupported("mixedEncoding")
    enc = next(iter(encs))
    lv, nns, streams = _plan_levels(chunk)
    nn_total = sum(nns)
    nv_cap = bucket_capacity(max(nn_total, 1))
    meta = {"n": chunk.num_values, "nn": nn_total,
            "max_def": chunk.max_def, "ts": None, "cast": None}
    upload = dict(lv)
    import pyarrow as pa
    if pa.types.is_timestamp(arrow_type):
        meta["ts"] = arrow_type.unit

    if pt == "BOOLEAN":
        if enc != praw.ENC_PLAIN:
            raise _Unsupported(f"enc:{praw.ENCODING_NAMES.get(enc, enc)}")
        # PLAIN booleans ARE a bit-packed stream: spell each page as one
        # bw=1 bit-packed run and ride the hybrid expander
        words, offs = _words_u8(streams)
        tbl = _pad_run_table({
            "out_start": np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(nns)]).astype(np.int32),
            "kind": np.ones(len(nns), np.uint8),
            "value": np.zeros(len(nns), np.int32),
            "bit_start": np.asarray([o * 8 for o in offs], np.int64),
            "bw": np.ones(len(nns), np.int32),
        })
        upload.update({"cd_words": words,
                       **{f"cd_{k}": v for k, v in tbl.items()}})
        meta["kind"] = "bool"
        return {"kind": "bool", "upload": upload, "meta": meta}

    if pt == "BYTE_ARRAY":
        if not dt.is_string:
            raise _Unsupported("binary")
        if is_dict:
            dvals = praw.parse_plain_byte_array(chunk.dict_page.payload,
                                                chunk.dict_page.num_values)
            return _plan_str_dict(upload, meta, streams, nns, dvals,
                                  blocked)
        if enc != praw.ENC_PLAIN:
            raise _Unsupported(f"enc:{praw.ENCODING_NAMES.get(enc, enc)}")
        return _plan_str_plain(upload, meta, streams, nn_total, nv_cap,
                               blocked)

    if pt not in _FIXED_KINDS:
        raise _Unsupported(f"type:{pt}")  # INT96, FLBA
    pkind, isize = _FIXED_KINDS[pt]
    meta["pkind"] = pkind
    if dt.np_dtype is not None and pkind in ("i32", "i64") \
            and dt.np_dtype.itemsize < isize:
        meta["cast"] = dt.np_dtype.str  # int8/int16 stored as INT32

    if is_dict:
        # dictionary page is a PLAIN fixed stream of `card` values:
        # upload it raw, decode it device-side, gather by codes
        card = chunk.dict_page.num_values
        dw, _ = _words_u8([chunk.dict_page.payload])
        if len(chunk.dict_page.payload) < card * isize:
            raise _Unsupported("dictShort")
        upload.update({"dv_words": dw})
        upload.update(_plan_codes(streams, nns))
        meta["card"] = card
        return {"kind": "fixed_dict", "upload": upload, "meta": meta}

    if enc == praw.ENC_DELTA_BINARY_PACKED:
        if pkind not in ("i32", "i64"):
            raise _Unsupported("deltaFloat")
        words, offs = _words_u8(streams)
        pages = []
        for j, (s, off, nn) in enumerate(zip(streams, offs, nns)):
            res = praw.delta_header_table(s, base_bit=off * 8)
            if res is None:
                raise _Unsupported("deltaWide")
            first, _vpm, total, tbl = res
            if total != nn:
                raise _Unsupported("deltaCount")
            guard = {"out_start": np.concatenate(
                [tbl["out_start"],
                 np.asarray([_INT32_MAX], np.int32)]),
                "bit_width": _pad1(tbl["bit_width"],
                                   len(tbl["bit_width"]) + 1),
                "min_delta": _pad1(tbl["min_delta"],
                                   len(tbl["min_delta"]) + 1),
                "bit_start": _pad1(tbl["bit_start"],
                                   len(tbl["bit_start"]) + 1)}
            for k, v in guard.items():
                upload[f"d{j}_{k}"] = v
            upload[f"d{j}_first"] = np.asarray([first], np.int64)
            pages.append((j, total))
        upload["dl_words"] = words
        meta["delta_pages"] = pages
        return {"kind": "fixed_delta", "upload": upload, "meta": meta}

    if enc != praw.ENC_PLAIN:
        raise _Unsupported(f"enc:{praw.ENCODING_NAMES.get(enc, enc)}")
    # PLAIN fixed width: the value streams concatenate into one aligned
    # buffer (each page's stream is exactly nn_p * itemsize bytes)
    clipped = [s[:nn * isize] for s, nn in zip(streams, nns)]
    for s, nn in zip(clipped, nns):
        if len(s) != nn * isize:
            raise _Unsupported("levelMismatch")
    words, _ = _words_u8(clipped)
    upload["vals"] = words
    return {"kind": "fixed_plain", "upload": upload, "meta": meta}


def _plan_str_plain(upload: dict, meta: dict, streams: List[bytes],
                    nn_total: int, nv_cap: int, blocked: int) -> dict:
    if blocked <= 0:
        raise _Unsupported("slabOff")
    chars = b"".join(streams)
    starts, lens = praw.plain_byte_array_starts(chars, nn_total)
    max_len = int(lens.max()) if nn_total else 0
    stride = slab_stride_for(max_len, blocked)
    if not stride:
        raise _Unsupported("slabStride")
    pad = np.zeros(((-len(chars)) % 4) + max(stride, 8), np.uint8)
    upload["chars"] = np.concatenate(
        [np.frombuffer(chars, np.uint8), pad])
    upload["st"] = _pad1(starts, nv_cap)
    upload["ln"] = _pad1(lens, nv_cap)
    meta["stride"] = stride
    return {"kind": "str_plain", "upload": upload, "meta": meta}


def _dict_slab(svals: List[bytes], stride: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Char slab (uint64) and int32 lengths of a dictionary's values, plus
    a zero-length null row at index ``len(svals)``."""
    card = len(svals)
    offs = np.zeros(card + 2, np.int32)
    offs[1:card + 1] = np.cumsum([len(v) for v in svals])
    offs[card + 1] = offs[card]
    return np_build_slab(np.frombuffer(b"".join(svals) or b"\0", np.uint8),
                         offs, card + 1, stride)


def _plan_str_dict(upload: dict, meta: dict, streams: List[bytes],
                   nns: List[int], dvals: List[bytes],
                   blocked: int) -> dict:
    """Dictionary string column: codes ride the hybrid expander; the
    page dictionary (sorted, as the host dictionary encoding sorts its
    values) becomes either the batch dictionary (codes-only column) or a
    host-built char slab the device gathers rows from (large-cardinality
    or NUL-bearing dictionaries)."""
    card = len(dvals)
    order = sorted(range(card), key=lambda i: dvals[i])
    remap = np.empty(card + 1, np.int32)
    for rank, i in enumerate(order):
        remap[i] = rank
    remap[card] = card
    svals = [dvals[i] for i in order]
    has_nul = any(b"\0" in v for v in svals)
    try:
        vals_tuple = tuple(v.decode("utf-8") for v in svals)
    except UnicodeDecodeError:
        raise _Unsupported("dictUtf8")
    if sorted(vals_tuple) != list(vals_tuple):
        # bytewise and str sort orders diverge past the BMP; keep the
        # canonical contract by re-sorting in str space
        order2 = sorted(range(card), key=lambda i: vals_tuple[i])
        inv = np.empty(card + 1, np.int32)
        for rank, i in enumerate(order2):
            inv[i] = rank
        inv[card] = card
        remap = inv[remap]
        svals = [svals[i] for i in order2]
        vals_tuple = tuple(vals_tuple[i] for i in order2)
    max_len = max((len(v) for v in svals), default=0)
    stride = slab_stride_for(max_len, blocked) if blocked > 0 else 0
    dict_ok = card <= DICT_MAX_CARD and card > 0 and not has_nul
    if not dict_ok and not stride:
        raise _Unsupported("dictStride")
    if stride:
        upload["slab"], upload["slens"] = _dict_slab(svals, stride)
        meta["stride"] = stride
    else:
        meta["stride"] = 0
    upload["rm"] = remap
    upload.update(_plan_codes(streams, nns))
    meta["card"] = card
    meta["dict_ok"] = dict_ok
    meta["vals"] = vals_tuple if dict_ok else None
    return {"kind": "str_dict", "upload": upload, "meta": meta}


class RawRowGroup:
    """Planning-side product of the device scan: per-column decode plans
    plus the host-decoded fallback frame and the split's partition values.
    Flows through the scan prefetcher like a DataFrame (``nbytes`` feeds
    its budget). ``key(name)`` is column ``name``'s page-cache key."""

    is_raw_rowgroup = True

    def __init__(self, n: int, path: str = "", rg: int = 0,
                 pvals: Optional[dict] = None, stamp=None,
                 blocked: int = 0):
        self.n = n
        self.path = path
        self.rg = rg
        self.pvals = dict(pvals or {})
        self.stamp = stamp
        self.blocked = blocked  # a string plan's slab limit
        self.plans: Dict[str, dict] = {}       # column -> decode plan
        self.fallback: List[Tuple[str, str]] = []
        self.fallback_df = None
        self.nbytes = 0
        # integer columns' footer (min, max): the session's advisory
        # statistics (exec/transitions.note_bounds)
        self.stats: Dict[str, Tuple[int, int]] = {}

    def __len__(self) -> int:
        return self.n

    def key(self, name: str) -> tuple:
        # the slab limit shapes a string column's plan, so it keys it too
        return (self.path, self.stamp, self.rg, name, self.blocked)


def prepare_rowgroup(path: str, rg: int, columns: List[str],
                     dtypes_by_name: dict, blocked: int,
                     pvals: Optional[dict] = None, page_cache=None):
    """Build a RawRowGroup on a planning thread, each column's plan taken
    from ``page_cache`` where it holds one (no file read) and put there
    where it did not. Returns a plain pandas DataFrame instead when NO
    data column can ride the device path."""
    from spark_rapids_tpu_torch.sql.sources import _arrow_decode
    stamp = praw.file_stamp(path)
    md = praw.file_metadata(path, stamp)
    rg_meta = md.row_group(rg)
    arrow_schema = md.schema.to_arrow_schema()
    ci_by_name = {rg_meta.column(ci).path_in_schema: ci
                  for ci in range(rg_meta.num_columns)}
    raw = RawRowGroup(int(rg_meta.num_rows), path, rg, pvals, stamp,
                      blocked)
    with _PREP_TIME.time():
        for name in columns:
            ci = ci_by_name.get(name)
            if ci is None:
                raw.fallback.append((name, "missing"))
                _note_fallback(path, name, "missing", rg)
                continue
            plan = (page_cache.get(raw.key(name)) if page_cache is not None
                    else None)
            if plan is None:
                chunk = praw.read_column_chunk(path, rg, ci, md=md,
                                               stamp=stamp)
                try:
                    plan = plan_column(chunk, dtypes_by_name[name],
                                       arrow_schema.field(name).type,
                                       blocked)
                except _Unsupported as e:
                    raw.fallback.append((name, e.reason))
                    _note_fallback(path, name, e.reason, rg)
                    continue
                plan["nbytes"] = sum(a.nbytes
                                     for a in plan["upload"].values())
                if page_cache is not None:
                    page_cache.put(raw.key(name), plan, plan["nbytes"])
            raw.plans[name] = plan
            raw.nbytes += plan["nbytes"]
            st = rg_meta.column(ci).statistics
            if (dtypes_by_name[name].is_integral and st is not None
                    and st.has_min_max and isinstance(st.min, int)
                    and isinstance(st.max, int)):
                raw.stats[name] = (int(st.min), int(st.max))
    if raw.fallback:
        import pyarrow.parquet as pq
        fb_cols = [name for name, _ in raw.fallback]
        with _HOST_DEC_TIME.time():
            table = pq.ParquetFile(path).read_row_group(rg,
                                                        columns=fb_cols)
            df = _arrow_decode(table)
        _HOST_BYTES.add(int(df.memory_usage(deep=False).sum()))
        raw.fallback_df = df
        raw.nbytes += int(df.memory_usage(deep=False).sum())
    if not raw.plans and columns:
        # nothing rides the device path: hand back the host frame
        return raw.fallback_df
    return raw


# ---------------------------------------------------------------------------
# Device side: plans -> DeviceBatch
# ---------------------------------------------------------------------------

def delta_chunk_table(up: dict, meta: dict) -> dict:
    """The per-page DELTA tables of a ``fixed_delta`` plan merged into the
    one table ``kernels.delta_unpack`` takes for the whole chunk: miniblock
    starts in element space (page start + 1 + the page's delta index; a
    guard row last), and the pages' starts and first values. Host numpy,
    built before the upload."""
    mstart, bw, mind, bits, firsts = [], [], [], [], []
    page_start = [0]
    for j, total in meta["delta_pages"]:
        m = len(up[f"d{j}_bit_width"]) - 1  # real miniblocks, guard off
        base = page_start[-1]
        mstart.append(up[f"d{j}_out_start"][:m].astype(np.int64) + base + 1)
        bw.append(up[f"d{j}_bit_width"][:m])
        mind.append(up[f"d{j}_min_delta"][:m])
        bits.append(up[f"d{j}_bit_start"][:m])
        firsts.append(up[f"d{j}_first"][:1])
        page_start.append(base + total)
    mstart.append(np.asarray([_INT32_MAX]))
    for parts, dt in ((bw, np.int32), (mind, np.int64), (bits, np.int64)):
        parts.append(np.zeros(1, dt))
    return {"dl_words": up["dl_words"],
            "dc_mstart": np.concatenate(mstart).astype(np.int32),
            "dc_bw": np.concatenate(bw).astype(np.int32),
            "dc_min_delta": np.concatenate(mind).astype(np.int64),
            "dc_bit_start": np.concatenate(bits).astype(np.int64),
            "dc_page_start": np.asarray(page_start, np.int32),
            "dc_first": np.concatenate(firsts).astype(np.int64)}


def _device_upload(plan: dict) -> dict:
    """The host arrays a plan's decode reads from the device: its upload
    arrays, a ``fixed_delta`` plan's merged chunk table instead of its
    per-page tables."""
    if plan["kind"] == "fixed_delta":
        up = delta_chunk_table(plan["upload"], plan["meta"])
        for k, v in plan["upload"].items():
            if k.startswith("lv_"):
                up[k] = v
        return up
    return plan["upload"]


def _as_signed(a: np.ndarray) -> np.ndarray:
    """uint32/uint64 words as the int32/int64 bit patterns torch holds."""
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a


def upload_arrays(tree: Dict[str, Dict[str, np.ndarray]], device,
                  per_column: bool = False
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copy every host array of ``tree`` ({column: {name: array}}) to
    ``device``: the arrays are packed, 16-byte aligned, into one pinned
    host buffer whose device copy is cut into typed views of the same
    shapes. One host-to-device copy, or with ``per_column`` one a column
    into a device allocation of its own (a column's views then keep only
    its own bytes alive)."""
    layout, off, spans = [], 0, {}
    for col, arrays in tree.items():
        lo = off
        for name, a in arrays.items():
            a = np.ascontiguousarray(_as_signed(np.asarray(a)))
            layout.append((col, name, a, off))
            off += -(-a.nbytes // 16) * 16
        spans[col] = (lo, off)
    device = torch.device(device)
    host = torch.empty(max(off, 16), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    for _col, _name, a, o in layout:
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    if per_column:
        bufs = {col: (host[lo:hi].to(device, non_blocking=True), lo)
                for col, (lo, hi) in spans.items()}
    else:
        dev = host.to(device, non_blocking=True)
        bufs = {col: (dev, 0) for col in tree}
    out: Dict[str, Dict[str, torch.Tensor]] = {col: {} for col in tree}
    for col, name, a, o in layout:
        dev, base = bufs[col]
        t = dev[o - base:o - base + a.nbytes].view(
            torch.from_numpy(a[:0]).dtype)
        out[col][name] = t.view(a.shape)
    return out


def _upload_bytes(arrays: Dict[str, np.ndarray]) -> int:
    """Device bytes of one column's uploaded arrays."""
    return sum(np.asarray(a).nbytes for a in arrays.values())


def partition_column(dt, value, n: int, cap: int, dev) -> DeviceColumn:
    """A partition key's column of ``n`` rows (capacity ``cap``) holding
    ``value`` (None: NULL), made on the device with no host buffer: a
    string is a dictionary of that one value with every code 0 (an empty
    dictionary for NULL), a number ``torch.full``, a NULL an all-invalid
    mask; padding rows hold the NULL code or the fill value."""
    live = torch.arange(cap, dtype=torch.int32, device=dev) < n
    validity = live if value is not None else torch.zeros(
        cap, dtype=torch.bool, device=dev)
    if dt.is_string:
        vals = (value,) if value is not None else ()
        codes = torch.where(validity, _zero(torch.int32, dev),
                            torch.full((), len(vals), dtype=torch.int32,
                                       device=dev))
        return DeviceColumn(dt, None, validity, dict_codes=codes,
                            dict_values=vals)
    want = dtypes.torch_dtype(dt.np_dtype)
    fill = (value.item() if value is not None
            else dtypes.null_fill_value(dt))
    data = torch.where(validity, torch.full((), fill, dtype=want,
                                            device=dev),
                       torch.zeros((), dtype=want, device=dev))
    return DeviceColumn(dt, data, validity)


def _decode_levels(levels: Optional[torch.Tensor], meta, cap: int, n: int,
                   dev) -> torch.Tensor:
    """Row validity from the expanded definition levels (None where the
    column has no level stream)."""
    row_mask = torch.arange(cap, dtype=torch.int32, device=dev) < n
    if levels is None:
        return row_mask
    return (levels == meta["max_def"]) & row_mask


def _value_positions(validity: torch.Tensor) -> torch.Tensor:
    """Value-stream index of every row: the count of valid rows before it
    (null rows point at the next value, clipped by the callers)."""
    pos = torch.cumsum(validity, 0, dtype=torch.int32) - 1
    return pos.clamp(min=0)


def _gather_rows(vals_v: torch.Tensor, validity: torch.Tensor, fill):
    """Value-space stream -> row space: non-null row k takes value
    cumsum(validity)[k]-1, null rows take the canonical fill."""
    fill_t = torch.full((), fill, dtype=vals_v.dtype, device=vals_v.device)
    if vals_v.shape[0] == 0:  # no values at all: every row is null
        return fill_t.expand(validity.shape[0]).clone()
    idx = _value_positions(validity).clamp(max=vals_v.shape[0] - 1).long()
    return torch.where(validity, vals_v[idx], fill_t)


def _apply_ts(vals: torch.Tensor, unit) -> torch.Tensor:
    """Timestamps of ``unit`` -> microseconds (TIMESTAMP_US)."""
    if unit in (None, "us"):
        return vals
    if unit == "ms":
        return vals * 1000
    if unit == "s":
        return vals * 1000000
    return torch.div(vals, 1000, rounding_mode="floor")  # ns


def _finish_fixed(dt, vals_v, validity, meta, fill) -> DeviceColumn:
    out = _gather_rows(vals_v, validity, fill)
    if meta.get("cast"):
        out = out.to(dtypes.torch_dtype(np.dtype(meta["cast"])))
    if meta.get("ts"):
        out = _apply_ts(out, meta["ts"])
    want = dtypes.torch_dtype(dt.np_dtype)
    if out.dtype != want:
        out = out.to(want)
    out = torch.where(validity, out,
                      torch.full((), fill, dtype=want, device=out.device))
    return DeviceColumn(dt, out, validity)


def _widen_slab(dt, slab, lens, validity, stride: int,
                dict_state: Optional[dict], i: int) -> DeviceColumn:
    """Honor the per-scan widen-only stride registry: later batches of a
    scan pad to the widest stride seen so far."""
    if dict_state is not None:
        prev = int(dict_state.get(("slab", i), 0) or 0)
        if prev > stride:
            slab = torch.nn.functional.pad(slab, (0, (prev - stride) // 8))
            stride = prev
        dict_state[("slab", i)] = stride
    return DeviceColumn(dt, None, validity, slab64=slab, lens=lens)


def _zero(dtype, device) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


_HYBRID_FIELDS = ("words", "out_start", "kind", "value", "bit_start", "bw")


def hybrid_streams(plans: dict, dev_tree: dict, cap: int) -> List[tuple]:
    """[((column, "lv" or "cd"), (words, out_start, kind, value, bit_start,
    bw, n))] of a row group's RLE/bit-packed hybrid streams: each nullable
    column's definition levels at the batch capacity ``cap``, and the
    dictionary codes of ``bool``, ``fixed_dict`` and ``str_dict`` plans at
    their value capacity, the arguments of one ``hybrid_expand_many``
    call."""
    out = []
    for name, plan in plans.items():
        up, meta = dev_tree[name], plan["meta"]
        if meta["max_def"] > 0 and "lv_words" in up:
            out.append(((name, "lv"), tuple(
                up[f"lv_{f}"] for f in _HYBRID_FIELDS) + (cap,)))
        if plan["kind"] in ("bool", "fixed_dict", "str_dict"):
            out.append(((name, "cd"), tuple(
                up[f"cd_{f}"] for f in _HYBRID_FIELDS)
                + (bucket_capacity(max(meta["nn"], 1)),)))
    return out


def plain_streams(plans: dict, dev_tree: dict) -> List[tuple]:
    """[(column, (words, kind, n))] of a row group's PLAIN fixed-width
    streams: ``fixed_plain`` value streams and ``fixed_dict`` dictionary
    pages, the arguments of one ``plain_fixed_many`` call."""
    out = []
    for name, plan in plans.items():
        meta = plan["meta"]
        if plan["kind"] == "fixed_plain":
            out.append((name, (dev_tree[name]["vals"], meta["pkind"],
                               bucket_capacity(max(meta["nn"], 1)))))
        elif plan["kind"] == "fixed_dict":
            out.append((name, (dev_tree[name]["dv_words"], meta["pkind"],
                               max(meta["card"], 1))))
    return out


def delta_streams(plans: dict, dev_tree: dict) -> List[tuple]:
    """[(column, (words, mstart, bwid, min_delta, bit_start, page_start,
    first, n))] of a row group's DELTA_BINARY_PACKED chunks (``fixed_delta``
    plans, each as its merged chunk table), the arguments of one
    ``delta_unpack_many`` call."""
    fields = ("dl_words", "dc_mstart", "dc_bw", "dc_min_delta",
              "dc_bit_start", "dc_page_start", "dc_first")
    return [(name, tuple(dev_tree[name][f] for f in fields)
             + (plan["meta"]["nn"],))
            for name, plan in plans.items() if plan["kind"] == "fixed_delta"]


def _decode_column(plan: dict, up: dict, dt, cap: int,
                   dict_state: Optional[dict], i: int, dev,
                   plain_vals: Optional[torch.Tensor],
                   levels: Optional[torch.Tensor],
                   codes_v: Optional[torch.Tensor]) -> DeviceColumn:
    """One uploaded plan -> DeviceColumn. ``plain_vals``: the decoded PLAIN
    stream of a ``fixed_plain`` or ``fixed_dict`` plan (``plain_streams``),
    or the decoded values of a ``fixed_delta`` one (``delta_streams``);
    ``levels`` and ``codes_v``: its expanded definition levels and
    dictionary codes (``hybrid_streams``); each None where the plan has
    none."""
    meta = plan["meta"]
    kind = plan["kind"]
    validity = _decode_levels(levels, meta, cap, meta["n"], dev)
    fill = dtypes.null_fill_value(dt)

    if kind == "bool":
        vals_v = codes_v != 0
        return DeviceColumn(dt, _gather_rows(vals_v, validity, False),
                            validity)

    if kind == "fixed_plain":
        return _finish_fixed(dt, plain_vals, validity, meta, fill)

    if kind == "fixed_delta":
        vals_v = plain_vals
        if meta["pkind"] == "i32":
            vals_v = vals_v.to(torch.int32)
        return _finish_fixed(dt, vals_v, validity, meta, fill)

    if kind == "fixed_dict":
        vals_v = plain_vals[codes_v.clamp(0, max(meta["card"] - 1, 0)).long()]
        return _finish_fixed(dt, vals_v, validity, meta, fill)

    if kind == "str_plain":
        nv = up["st"].shape[0]
        slab_v = K.slab_pack(up["chars"], up["st"], up["ln"], nv,
                             meta["stride"])
        idx = _value_positions(validity).clamp(max=nv - 1).long()
        slab = torch.where(validity[:, None], slab_v[idx],
                           _zero(torch.int64, dev))
        lens = torch.where(validity, up["ln"][idx], _zero(torch.int32, dev))
        return _widen_slab(dt, slab, lens, validity, meta["stride"],
                           dict_state, i)

    # str_dict: canonical codes in row space first
    nv = bucket_capacity(max(meta["nn"], 1))
    card = meta["card"]
    canon_v = up["rm"][codes_v.clamp(0, card).long()]
    idx = _value_positions(validity).clamp(max=nv - 1).long()
    codes_row = torch.where(validity, canon_v[idx],
                            torch.full((), card, dtype=torch.int32,
                                       device=dev))
    use_dict = meta["dict_ok"]
    if use_dict and dict_state is not None:
        st = dict_state.get(i)
        if st is False:
            use_dict = False
        elif st is None:
            dict_state[i] = meta["vals"]
        elif tuple(st) != meta["vals"]:
            # remap into the established dictionary when this page
            # dictionary is a subset; otherwise close the column for the
            # rest of the scan
            held = {v: k for k, v in enumerate(st)}
            if all(v in held for v in meta["vals"]):
                tbl = np.asarray(
                    [held[v] for v in meta["vals"]] + [len(st)], np.int32)
                codes_row = host_to_device(tbl, dev)[
                    codes_row.clamp(0, card).long()]
                return DeviceColumn(dt, None, validity,
                                    dict_codes=codes_row,
                                    dict_values=tuple(st))
            dict_state[i] = False
            use_dict = False
    if use_dict:
        return DeviceColumn(dt, None, validity, dict_codes=codes_row,
                            dict_values=meta["vals"])
    rows = codes_row.clamp(0, card).long()  # card = the empty null row
    if meta["stride"]:
        slab = up["slab"][rows]
        lens = torch.where(validity, up["slens"][rows],
                           _zero(torch.int32, dev))
        return _widen_slab(dt, slab, lens, validity, meta["stride"],
                           dict_state, i)
    # the scan closed this column's dictionary and the plan built no slab
    # (the dictionary is small): build one from the dictionary values, or
    # plain chars where a value passes the slab limit
    svals = [v.encode("utf-8") for v in meta["vals"]]
    stride = slab_stride_for(max((len(v) for v in svals), default=0),
                             1 << 30)
    if stride > MAX_SLAB_STRIDE:
        return as_plain(DeviceColumn(dt, None, validity, dict_codes=rows,
                                     dict_values=meta["vals"]))
    slab_h, lens_h = _dict_slab(svals, stride)
    slab = host_to_device(slab_h.view(np.int64), dev)[rows]
    lens = torch.where(validity, host_to_device(lens_h, dev)[rows],
                       _zero(torch.int32, dev))
    return _widen_slab(dt, slab, lens, validity, stride, dict_state, i)


def _fallback_arrays(df, name: str, dt, cap: int) -> Dict[str, np.ndarray]:
    """A host-decoded column's device-layout buffers: data and validity,
    or for a string column a char slab where its longest value fits the
    slab limit, else plain chars and offsets (the upload's rule)."""
    values, validity = _pandas_to_numpy(df[name], dt)
    data, vpad = DeviceColumn.build_host_buffers(values, validity, dt, cap)
    if not dt.is_string:
        return {"data": data, "validity": vpad}
    slab = host_string_slab(values, vpad, cap, MAX_SLAB_STRIDE)
    if slab is None:
        chars, offsets = host_string_packed(values, vpad, cap)
        return {"validity": vpad, "chars": chars, "offsets": offsets}
    return {"validity": vpad, "slab": slab[0], "slens": slab[1]}


def _fallback_column(dt, arrays: Dict[str, torch.Tensor]) -> DeviceColumn:
    if dt.is_string and "chars" in arrays:
        return DeviceColumn(dt, None, arrays["validity"],
                            chars=arrays["chars"], offsets=arrays["offsets"])
    if dt.is_string:
        return DeviceColumn(dt, None, arrays["validity"],
                            slab64=arrays["slab"], lens=arrays["slens"])
    return DeviceColumn(dt, arrays["data"], arrays["validity"])


def decode_rowgroup(raw: RawRowGroup, schema, dict_state: Optional[dict],
                    device="cuda", page_cache=None) -> DeviceBatch:
    """RawRowGroup -> one DeviceBatch at ``bucket_capacity(rows)``: one
    host-to-device copy of every plan's buffers and every fallback
    column's host buffers (one a column under ``page_cache``, whose
    promoted plans upload nothing), then the kernel decode (no host sync),
    with every RLE/bit-packed hybrid stream in one B5 launch, every DELTA
    chunk in one B6 launch and every PLAIN fixed-width stream in one B7
    launch; the partition keys as device constants. ``dict_state`` is the
    scan's dictionary and slab-stride registry, shared by all its row
    groups."""
    from spark_rapids_tpu_torch.sql.sources import partition_scalar
    n = raw.n
    cap = bucket_capacity(max(n, 1))
    dt_by_name = dict(zip(schema.names, schema.dtypes))
    device = torch.device(device)
    dev_tree, tree = {}, {}
    for name, plan in raw.plans.items():
        hit = (page_cache.get_device(raw.key(name))
               if page_cache is not None else None)
        if hit is not None:
            dev_tree[name] = hit
        else:
            tree[name] = _device_upload(plan)
    fresh = list(tree)
    for name, _reason in raw.fallback:
        tree[name] = _fallback_arrays(raw.fallback_df, name,
                                      dt_by_name[name], cap)
    if tree:
        nbytes = sum(_upload_bytes(arrays) for arrays in tree.values())
        t0 = time.perf_counter()
        with sync_scope("scan.upload", nbytes=nbytes):
            dev_tree.update(upload_arrays(tree, device,
                                          per_column=page_cache is not None))
        compileledger.note_transfer(time.perf_counter() - t0, "h2d")
        if page_cache is not None:
            for name in fresh:
                page_cache.promote(raw.key(name), dev_tree[name],
                                   _upload_bytes(tree[name]))
    _DEV_BYTES.add(sum(p["nbytes"] for p in raw.plans.values()))
    _DEV_COLS.add(len(raw.plans))
    _DEV_SPLITS.add(1)
    with _DEC_TIME.time():
        hybrid, plain = {}, {}
        streams = hybrid_streams(raw.plans, dev_tree, cap)
        if streams:
            keys, args = zip(*streams)
            hybrid = dict(zip(keys, K.hybrid_expand_many(list(args))))
        streams = plain_streams(raw.plans, dev_tree)
        if streams:
            names, args = zip(*streams)
            plain = dict(zip(names, K.plain_fixed_many(list(args))))
        streams = delta_streams(raw.plans, dev_tree)
        if streams:
            names, args = zip(*streams)
            plain.update(zip(names, K.delta_unpack_many(list(args))))
        cols = []
        for i, name in enumerate(schema.names):
            dt = dt_by_name[name]
            if name in raw.plans:
                cols.append(_decode_column(
                    raw.plans[name], dev_tree[name], dt, cap, dict_state, i,
                    device, plain.get(name), hybrid.get((name, "lv")),
                    hybrid.get((name, "cd"))))
            elif name in dev_tree:
                cols.append(_fallback_column(dt, dev_tree[name]))
            else:
                cols.append(partition_column(
                    dt, partition_scalar(raw.pvals, name, dt), n, cap,
                    device))
    num_rows = torch.full((), n, dtype=torch.int32, device=device)
    return DeviceBatch(schema, cols, num_rows)
