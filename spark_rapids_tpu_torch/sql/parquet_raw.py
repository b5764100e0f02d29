"""Raw Parquet page access for the device decode path (copy of the JAX
package's ``sql/parquet_raw.py``; the port imports nothing of that package).

Device decode needs what pyarrow's table reader hides: the column-chunk
BYTES and their page structure. pyarrow's low-level metadata
(FileMetaData / ColumnChunkMetaData) exposes every offset and size needed,
but NOT the per-page headers: those are Thrift compact-protocol structs
inline in the data stream, so this module carries a minimal Thrift reader
for exactly the three structs a flat Parquet file uses (PageHeader,
DataPageHeader, DictionaryPageHeader).

Everything here is host-side byte shuffling: read the chunk's byte range,
split pages, decompress payloads, and parse the *sequential* encodings'
headers (RLE/bit-packed run headers, DELTA_BINARY_PACKED block headers)
into small numpy run tables the device kernels expand in parallel
(ops/parquet_decode.py). No value-level decode happens on the host.

``file_metadata`` keeps parsed footers keyed by the path and its
``file_stamp`` (the modification time in nanoseconds, the size and the
inode), so split planning and the page reader parse each footer once. A
file rewritten in place within one tick of the file system's clock keeps
its mtime; an overwrite's commit (``os.replace``) gives it a new inode,
so the stamp still changes. The JAX package keys on the mtime alone.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.obs.metrics import REGISTRY

# parquet-format enums (format/PageType, format/Encoding)
PAGE_DATA = 0
PAGE_DICTIONARY = 2
PAGE_DATA_V2 = 3

ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_BIT_PACKED = 4
ENC_DELTA_BINARY_PACKED = 5
ENC_RLE_DICTIONARY = 8

ENCODING_NAMES = {
    0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
    5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
    7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT",
}

# codecs the raw reader decompresses host-side via pyarrow.Codec. LZ4 is
# deliberately absent: parquet's legacy LZ4 framing is hadoop-specific and
# round-trips wrong through the plain codec.
_CODECS = {"UNCOMPRESSED", "SNAPPY", "GZIP", "ZSTD", "BROTLI"}

_FILE_READS = REGISTRY.counter("scan.device.fileReads")
_FILE_READ_BYTES = REGISTRY.counter("scan.device.fileReadBytes")


# ---------------------------------------------------------------------------
# Shared footer-metadata cache
# ---------------------------------------------------------------------------

Stamp = Optional[Tuple[int, int, int]]

_META_CACHE: Dict[Tuple[str, Stamp], object] = {}
_META_LOCK = threading.Lock()
_META_CACHE_CAP = 512


def file_stamp(path: str) -> Stamp:
    """(mtime in ns, size, inode) of ``path``, or None where it cannot be
    read: the version of a file that the footer, statistics and page
    caches key on."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def file_metadata(path: str, stamp: Stamp = None):
    """Parsed footer (pyarrow FileMetaData) for ``path``, cached by
    (path, stamp) with oldest-half eviction: one footer parse per file
    per version, shared by split planning and the raw-page reader."""
    import pyarrow.parquet as pq
    if stamp is None:
        stamp = file_stamp(path)
    key = (path, stamp)
    with _META_LOCK:
        md = _META_CACHE.get(key)
    if md is not None:
        return md
    md = pq.read_metadata(path)
    with _META_LOCK:
        if len(_META_CACHE) >= _META_CACHE_CAP:
            for k in list(_META_CACHE)[:_META_CACHE_CAP // 2]:
                del _META_CACHE[k]
        _META_CACHE[key] = md
    return md


# ---------------------------------------------------------------------------
# Thrift compact-protocol reader (just enough for page headers)
# ---------------------------------------------------------------------------

def _uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


_T_BOOL_TRUE, _T_BOOL_FALSE = 1, 2
_T_BYTE, _T_I16, _T_I32, _T_I64, _T_DOUBLE = 3, 4, 5, 6, 7
_T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 8, 9, 10, 11, 12


def _skip_value(buf: bytes, pos: int, ftype: int) -> int:
    if ftype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
        return pos
    if ftype == _T_BYTE:
        return pos + 1
    if ftype in (_T_I16, _T_I32, _T_I64):
        _, pos = _uvarint(buf, pos)
        return pos
    if ftype == _T_DOUBLE:
        return pos + 8
    if ftype == _T_BINARY:
        n, pos = _uvarint(buf, pos)
        return pos + n
    if ftype in (_T_LIST, _T_SET):
        h = buf[pos]
        pos += 1
        n, etype = h >> 4, h & 0x0F
        if n == 15:
            n, pos = _uvarint(buf, pos)
        for _ in range(n):
            pos = _skip_value(buf, pos, etype)
        return pos
    if ftype == _T_MAP:
        n, pos = _uvarint(buf, pos)
        if n:
            kv = buf[pos]
            pos += 1
            for _ in range(n):
                pos = _skip_value(buf, pos, kv >> 4)
                pos = _skip_value(buf, pos, kv & 0x0F)
        return pos
    if ftype == _T_STRUCT:
        return _skip_struct(buf, pos)
    raise ValueError(f"unknown thrift compact type {ftype}")


def _skip_struct(buf: bytes, pos: int) -> int:
    fid = 0
    while True:
        b = buf[pos]
        pos += 1
        if b == 0:
            return pos
        delta, ftype = b >> 4, b & 0x0F
        if delta:
            fid += delta
        else:
            z, pos = _uvarint(buf, pos)
            fid = _zigzag(z)
        pos = _skip_value(buf, pos, ftype)


@dataclass
class PageHeader:
    page_type: int = -1
    uncompressed_size: int = 0
    compressed_size: int = 0
    num_values: int = 0
    encoding: int = -1
    def_encoding: int = -1
    header_len: int = 0          # bytes consumed by the thrift struct


def _parse_inner_data_header(buf: bytes, pos: int, hdr: PageHeader) -> int:
    """DataPageHeader: 1 num_values, 2 encoding, 3 definition_level_
    encoding, 4 repetition_level_encoding, 5 statistics (skipped)."""
    fid = 0
    while True:
        b = buf[pos]
        pos += 1
        if b == 0:
            return pos
        delta, ftype = b >> 4, b & 0x0F
        if delta:
            fid += delta
        else:
            z, pos = _uvarint(buf, pos)
            fid = _zigzag(z)
        if fid in (1, 2, 3) and ftype in (_T_I16, _T_I32, _T_I64):
            z, pos = _uvarint(buf, pos)
            v = _zigzag(z)
            if fid == 1:
                hdr.num_values = v
            elif fid == 2:
                hdr.encoding = v
            else:
                hdr.def_encoding = v
        else:
            pos = _skip_value(buf, pos, ftype)


def _parse_inner_dict_header(buf: bytes, pos: int, hdr: PageHeader) -> int:
    """DictionaryPageHeader: 1 num_values, 2 encoding, 3 is_sorted."""
    fid = 0
    while True:
        b = buf[pos]
        pos += 1
        if b == 0:
            return pos
        delta, ftype = b >> 4, b & 0x0F
        if delta:
            fid += delta
        else:
            z, pos = _uvarint(buf, pos)
            fid = _zigzag(z)
        if fid in (1, 2) and ftype in (_T_I16, _T_I32, _T_I64):
            z, pos = _uvarint(buf, pos)
            v = _zigzag(z)
            if fid == 1:
                hdr.num_values = v
            else:
                hdr.encoding = v
        else:
            pos = _skip_value(buf, pos, ftype)


def parse_page_header(buf: bytes, pos: int) -> PageHeader:
    """PageHeader: 1 type, 2 uncompressed_page_size, 3 compressed_page_
    size, 4 crc, 5 data_page_header, 7 dictionary_page_header,
    8 data_page_header_v2 (left unparsed: v2 pages fall back)."""
    start = pos
    hdr = PageHeader()
    fid = 0
    while True:
        b = buf[pos]
        pos += 1
        if b == 0:
            break
        delta, ftype = b >> 4, b & 0x0F
        if delta:
            fid += delta
        else:
            z, pos = _uvarint(buf, pos)
            fid = _zigzag(z)
        if fid in (1, 2, 3) and ftype in (_T_I16, _T_I32, _T_I64):
            z, pos = _uvarint(buf, pos)
            v = _zigzag(z)
            if fid == 1:
                hdr.page_type = v
            elif fid == 2:
                hdr.uncompressed_size = v
            else:
                hdr.compressed_size = v
        elif fid == 5 and ftype == _T_STRUCT:
            pos = _parse_inner_data_header(buf, pos, hdr)
        elif fid == 7 and ftype == _T_STRUCT:
            pos = _parse_inner_dict_header(buf, pos, hdr)
        else:
            pos = _skip_value(buf, pos, ftype)
    hdr.header_len = pos - start
    return hdr


# ---------------------------------------------------------------------------
# Column-chunk page reader
# ---------------------------------------------------------------------------

@dataclass
class RawPage:
    num_values: int            # rows covered (incl. nulls)
    encoding: int
    payload: bytes             # decompressed page body


@dataclass
class RawColumnChunk:
    """One column chunk's pages, decompressed, plus the footer facts the
    decode planner needs. ``unsupported`` carries the first reason this
    chunk cannot ride the device path (None = fully parseable)."""
    name: str
    physical_type: str
    num_values: int
    max_def: int
    max_rep: int
    dict_page: Optional[RawPage] = None
    pages: List[RawPage] = field(default_factory=list)
    unsupported: Optional[str] = None


def _decompress(data: bytes, codec: str, usize: int) -> bytes:
    # a v1 page under a codec is always compressed, even where the codec's
    # output is as long as its input (the JAX package skips such a page
    # and parses compressed bytes)
    if codec == "UNCOMPRESSED":
        return data
    import pyarrow as pa
    return pa.Codec(codec.lower()).decompress(data, usize).to_pybytes()


def read_column_chunk(path: str, rg: int, ci: int,
                      md=None, stamp: Stamp = None) -> RawColumnChunk:
    """Read + page-split one column chunk."""
    if md is None:
        md = file_metadata(path, stamp)
    col = md.row_group(rg).column(ci)
    schema_col = md.schema.column(ci)
    chunk = RawColumnChunk(
        name=col.path_in_schema,
        physical_type=str(col.physical_type),
        num_values=int(col.num_values),
        max_def=int(schema_col.max_definition_level),
        max_rep=int(schema_col.max_repetition_level))
    codec = str(col.compression)
    if codec not in _CODECS:
        chunk.unsupported = f"codec:{codec}"
        return chunk
    start = int(col.data_page_offset)
    dict_off = col.dictionary_page_offset
    if dict_off is not None and 0 < int(dict_off) < start:
        start = int(dict_off)
    size = int(col.total_compressed_size)
    with open(path, "rb") as f:
        f.seek(start)
        raw = f.read(size)
    _FILE_READS.add(1)
    _FILE_READ_BYTES.add(len(raw))
    pos = 0
    seen = 0
    while seen < chunk.num_values and pos < len(raw):
        hdr = parse_page_header(raw, pos)
        pos += hdr.header_len
        body = raw[pos:pos + hdr.compressed_size]
        pos += hdr.compressed_size
        if hdr.page_type == PAGE_DICTIONARY:
            payload = _decompress(body, codec, hdr.uncompressed_size)
            chunk.dict_page = RawPage(hdr.num_values, hdr.encoding, payload)
            continue
        if hdr.page_type != PAGE_DATA:
            chunk.unsupported = ("pageV2" if hdr.page_type == PAGE_DATA_V2
                                 else f"pageType:{hdr.page_type}")
            return chunk
        if hdr.def_encoding not in (-1, ENC_RLE, ENC_BIT_PACKED) \
                and chunk.max_def > 0:
            chunk.unsupported = f"defEncoding:{hdr.def_encoding}"
            return chunk
        payload = _decompress(body, codec, hdr.uncompressed_size)
        chunk.pages.append(RawPage(hdr.num_values, hdr.encoding, payload))
        seen += hdr.num_values
    return chunk


# ---------------------------------------------------------------------------
# Sequential-encoding header parsers -> numpy run tables
# ---------------------------------------------------------------------------

def hybrid_run_table(buf: bytes, bit_width: int, num_values: int,
                     base_bit: int = 0):
    """RLE/bit-packed hybrid stream -> run tables for vectorized device
    expansion. Host cost is O(#runs) (runs cover >= 8 values each in the
    bit-packed case and arbitrarily many in the RLE case), not O(values).
    A stream's last bit-packed run counts its padded final group of 8
    too, so the runs may cover a few values past ``num_values``.

    Returns dict of numpy arrays:
      out_start (R+1,) int32 — cumulative output index of each run
      kind      (R,)  uint8  — 0 = RLE, 1 = bit-packed
      value     (R,)  int32  — the RLE run's value (0 for BP runs)
      bit_start (R,)  int64  — BP run's first bit, offset by ``base_bit``
                               (the stream's bit position in the upload
                               buffer; RLE runs carry 0)
      bw        (R,)  int32  — the run's bit width (per run, because a
                               multi-page chunk merges pages that may
                               carry different dictionary index widths)
    """
    kinds: List[int] = []
    values: List[int] = []
    bit_starts: List[int] = []
    counts: List[int] = []
    pos = 0
    out = 0
    byte_w = (bit_width + 7) // 8
    while out < num_values and pos < len(buf):
        header, pos = _uvarint(buf, pos)
        if header & 1:
            groups = header >> 1
            count = groups * 8
            kinds.append(1)
            values.append(0)
            bit_starts.append(base_bit + pos * 8)
            pos += groups * bit_width
        else:
            count = header >> 1
            v = int.from_bytes(buf[pos:pos + byte_w], "little")
            pos += byte_w
            kinds.append(0)
            values.append(v)
            bit_starts.append(0)
        if count <= 0:
            kinds.pop(); values.pop(); bit_starts.pop()
            continue
        counts.append(count)
        out += count
    out_start = np.zeros(len(counts) + 1, np.int32)
    np.cumsum(counts, out=out_start[1:])
    return {
        "out_start": out_start,
        "kind": np.asarray(kinds, np.uint8),
        "value": np.asarray(values, np.int32),
        "bit_start": np.asarray(bit_starts, np.int64),
        "bw": np.full(len(counts), bit_width, np.int32),
    }


def merge_run_tables(tables: List[dict],
                     num_values: Optional[List[int]] = None) -> dict:
    """Concatenate per-page hybrid run tables into one chunk-wide table
    (each page's bit_start values already carry its stream's base_bit).

    ``num_values``: each page's value count. Page i + 1 then starts right
    after page i's values, and page i's last run is cut there: a last
    bit-packed run counts the padding of its final group of 8, which
    without the cut would shift every later page (the JAX package's merge
    shifts them). The last page keeps its padded run, as a single page
    does."""
    if len(tables) == 1:
        return tables[0]
    out_start = [np.zeros(1, np.int32)]
    base = 0
    for i, t in enumerate(tables):
        starts = t["out_start"][1:] + base
        if num_values is not None and i < len(tables) - 1:
            starts = np.minimum(starts, base + num_values[i])
            base += num_values[i]
        else:
            base += int(t["out_start"][-1])
        out_start.append(starts.astype(np.int32))
    return {
        "out_start": np.concatenate(out_start),
        "kind": np.concatenate([t["kind"] for t in tables]),
        "value": np.concatenate([t["value"] for t in tables]),
        "bit_start": np.concatenate([t["bit_start"] for t in tables]),
        "bw": np.concatenate([t["bw"] for t in tables]),
    }


def delta_header_table(buf: bytes, base_bit: int = 0):
    """DELTA_BINARY_PACKED stream -> per-miniblock header table.

    Returns (first_value, values_per_miniblock, total_count, table) with
    table arrays (one row per miniblock that holds data):
      out_start (M+1,) int32 — cumulative DELTA index (value k's delta is
                               delta index k-1)
      bit_width (M,)  int32
      min_delta (M,)  int64  — the owning block's min delta
      bit_start (M,)  int64  — first bit of the miniblock's packed deltas
    Returns None when the stream uses a bit width > 32 (the u64 window
    extraction cannot span it — per-column fallback, reason deltaWide).
    """
    pos = 0
    block_size, pos = _uvarint(buf, pos)
    mpb, pos = _uvarint(buf, pos)
    total, pos = _uvarint(buf, pos)
    z, pos = _uvarint(buf, pos)
    first_value = _zigzag(z)
    vpm = block_size // max(mpb, 1)
    bws: List[int] = []
    mins: List[int] = []
    starts: List[int] = []
    counts: List[int] = []
    remaining = total - 1
    while remaining > 0 and pos < len(buf):
        z, pos = _uvarint(buf, pos)
        min_delta = _zigzag(z)
        widths = buf[pos:pos + mpb]
        pos += mpb
        for m in range(mpb):
            if remaining <= 0:
                break
            bw = widths[m]
            if bw > 32:
                return None
            bws.append(bw)
            mins.append(min_delta)
            starts.append(base_bit + pos * 8)
            counts.append(min(vpm, remaining))
            pos += bw * vpm // 8
            remaining -= vpm
    out_start = np.zeros(len(counts) + 1, np.int32)
    np.cumsum(counts, out=out_start[1:])
    return first_value, vpm, total, {
        "out_start": out_start,
        "bit_width": np.asarray(bws, np.int32),
        "min_delta": np.asarray(mins, np.int64),
        "bit_start": np.asarray(starts, np.int64),
    }


def plain_byte_array_starts(buf: bytes, num_values: int):
    """(starts, lens) int64/int32 arrays for a PLAIN byte-array stream
    ([u32 len][bytes]...), via vectorized numpy pointer doubling — the
    host never touches value bytes, only the length chain. O(B log n)
    vectorized passes over the page instead of an O(n) python loop."""
    b = np.frombuffer(buf, np.uint8)
    nb = len(b)
    if num_values <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    # len32 at every byte position p (little-endian, 0 past the end)
    padded = np.zeros(nb + 4, np.uint32)
    padded[:nb] = b
    len_at = (padded[:nb] | (padded[1:nb + 1] << 8)
              | (padded[2:nb + 2] << 16) | (padded[3:nb + 3] << 24))
    nxt = np.minimum(np.arange(nb, dtype=np.int64) + 4
                     + len_at.astype(np.int64), nb)
    starts = np.empty(num_values, np.int64)
    starts[0] = 0
    filled = 1
    jump = nxt  # 2^k-step jump table, squared each round
    while filled < num_values:
        take = min(filled, num_values - filled)
        src = np.clip(starts[:take], 0, nb - 1)
        starts[filled:filled + take] = jump[src]
        filled += take
        if filled < num_values:
            jump = jump[np.clip(jump, 0, nb - 1)]
    starts = np.clip(starts, 0, max(nb - 1, 0))
    lens = len_at[starts].astype(np.int32)
    return starts + 4, lens


def parse_plain_byte_array(buf: bytes, count: int) -> List[bytes]:
    """Host parse of a (small) PLAIN byte-array stream — dictionary pages
    only; data pages ride the vectorized path above."""
    out: List[bytes] = []
    pos = 0
    for _ in range(count):
        n = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        out.append(buf[pos:pos + n])
        pos += n
    return out
