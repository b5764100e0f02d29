"""Device-resident column vectors (torch counterpart of the JAX package's
``columnar/column.py``).

A column is a plain object holding torch tensors: ``data`` of shape
(capacity,) in the physical dtype, ``validity`` bool (capacity,), and for
dictionary-encoded columns ``dict_codes`` int32 (capacity,) against
``dict_values``, a static host tuple in canonical sorted order
(code == len(dict_values) is the NULL/padding sentinel). Capacity is static
and the live row count rides on the batch, as in the JAX package.

A string column has ``data`` None and one of three device forms:

  * dictionary codes, as above;
  * a char slab (the JAX package's blocked chars): ``slab64`` int64
    (capacity, stride/8) holding uint64 bit patterns, row i's byte j at bit
    8*(j%8) of word j//8 and zero past the row's length, plus ``lens`` int32
    (capacity,). The device Parquet scan builds slabs for plain byte-array
    columns (kernel B8) and for dictionaries too large to hold on the host.
    Rows move as one 2-D gather; ``to_numpy`` unpacks them on the host;
  * plain offsets and chars (the JAX package's ``data``/``offsets``):
    ``chars`` uint8 (char capacity,) and ``offsets`` int32 (capacity + 1,),
    row i's bytes at [offsets[i], offsets[i + 1]), offsets[0] == 0, invalid
    and padding rows empty, bytes past offsets[capacity] zero. Its device
    bytes are the total of its values, not rows x the longest value.

The pandas upload (``DeviceBatch.from_pandas``) makes a dictionary of a
low-cardinality string column, a slab of any other whose longest value
fits the stride limit (``spark.rapids.sql.dict.blockedChars.maxStride``,
64 bytes by default), and plain chars of the rest, the JAX package's rule.
``plain_parts`` gives any form's offsets and chars (a dictionary or a slab
rebuilt into them, as the JAX package's ``_materialize_chars`` and
``_materialize_from_slab`` do), ``string_lens`` any form's lengths.

The host dictionary encoding (``dict_factorize_hint``, ``host_dict_encode``,
``host_dict_encode_stateful``) is a copy of the JAX package's numpy code.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.dtype import DType


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host constant on ``device`` without a host sync: to a CUDA
    device the copy goes through pinned memory and is stream-ordered
    (a copy from pageable memory would synchronize the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceColumn:
    """One column on the device (see the module docstring for layout)."""

    def __init__(self, dtype: DType, data: Optional[torch.Tensor],
                 validity: torch.Tensor,
                 dict_codes: Optional[torch.Tensor] = None,
                 dict_values: Optional[tuple] = None,
                 slab64: Optional[torch.Tensor] = None,
                 lens: Optional[torch.Tensor] = None,
                 chars: Optional[torch.Tensor] = None,
                 offsets: Optional[torch.Tensor] = None):
        if dtype.is_string:
            has_dict = dict_values is not None and dict_codes is not None
            if (not has_dict and (slab64 is None or lens is None)
                    and (chars is None or offsets is None)):
                raise ValueError("a string column needs dictionary codes, "
                                 "a char slab or offsets and chars")
            data = None
        elif data is None:
            raise ValueError(f"{dtype} column needs a data tensor")
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.dict_codes = dict_codes
        self.dict_values = dict_values
        self.slab64 = slab64
        self.lens = lens
        self.chars = chars
        self.offsets = offsets

    @property
    def has_slab(self) -> bool:
        """True for a char-slab string column (no dictionary codes)."""
        return self.slab64 is not None and self.dict_values is None

    @property
    def is_plain(self) -> bool:
        """True for a plain offsets+chars string column."""
        return is_plain(self)

    def lens_(self) -> torch.Tensor:
        """Per-row byte lengths (int32, 0 where invalid) of any string
        form, without rebuilding chars."""
        return string_lens(self)

    @property
    def char_stride(self) -> int:
        """Per-row byte stride of the slab layout."""
        assert self.slab64 is not None
        return int(self.slab64.shape[1]) * 8

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @property
    def dict_card(self) -> int:
        """Number of real dictionary values (code == dict_card is NULL)."""
        assert self.dict_values is not None
        return len(self.dict_values)

    def __repr__(self) -> str:
        return f"DeviceColumn({self.dtype}, capacity={self.capacity})"

    # --- construction ------------------------------------------------------
    @staticmethod
    def build_host_buffers(values: np.ndarray,
                           validity: Optional[np.ndarray],
                           dtype: DType, capacity: int):
        """Device-layout numpy buffers ``(data, validity)`` padded to
        ``capacity``; null slots hold the dtype's canonical fill value.
        String columns carry no data buffer (``data`` is None): their device
        form is the dictionary codes built by ``host_dict_encode``."""
        n = len(values)
        assert n <= capacity, (n, capacity)
        if validity is None:
            validity = np.ones(n, dtype=np.bool_)
        vpad = np.zeros(capacity, dtype=np.bool_)
        vpad[:n] = validity
        if dtype.is_string:
            return None, vpad
        fill = dtypes.null_fill_value(dtype)
        vals = np.asarray(values, dtype=dtype.np_dtype)
        dpad = np.empty(capacity, dtype=dtype.np_dtype)
        dpad[:n] = vals
        dpad[n:] = fill
        v = validity[:n]
        if not v.all():
            np.copyto(dpad[:n], np.asarray(fill, dtype=dtype.np_dtype),
                      where=~v)
        return dpad, vpad

    @staticmethod
    def from_host_buffers(dtype: DType, data: Optional[np.ndarray],
                          validity: np.ndarray, codes: Optional[np.ndarray],
                          dict_values: Optional[tuple],
                          device) -> "DeviceColumn":
        """Upload host buffers (``build_host_buffers`` + optional codes)."""
        def up(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(device)
        return DeviceColumn(dtype, up(data), up(validity), up(codes),
                            dict_values)

    # --- host access -------------------------------------------------------
    def to_numpy(self, num_rows: int):
        """Leading ``num_rows`` on the host as (values, validity). String
        columns decode their codes through the static dictionary into an
        object array of python str (None where null)."""
        validity = self.validity[:num_rows].cpu().numpy()
        if self.is_plain:
            offsets = self.offsets[:num_rows + 1].cpu().numpy()
            chars = self.chars[:int(offsets[-1])].cpu().numpy()
            return numpy_from_host_packed(chars, offsets, validity), validity
        if self.has_slab:
            slab = self.slab64[:num_rows].cpu().numpy().view(np.uint64)
            lens = self.lens[:num_rows].cpu().numpy()
            chars, offsets = np_slab_to_packed(slab, lens, validity)
            return numpy_from_host_packed(chars, offsets, validity), validity
        if self.dtype.is_string:
            codes = self.dict_codes[:num_rows].cpu().numpy()
            card = len(self.dict_values)
            table = np.asarray(list(self.dict_values) + [None], dtype=object)
            out = table[np.clip(codes, 0, card)]
            out[~validity] = None
            return out, validity
        return self.data[:num_rows].cpu().numpy(), validity


# ---------------------------------------------------------------------------
# char slabs (copies of the JAX package's host helpers)
# ---------------------------------------------------------------------------

def slab_stride_for(max_len: int, max_stride: int) -> int:
    """Power-of-two per-row byte stride (>= 8) for the char-slab layout, or
    0 when the column's longest row exceeds ``max_stride``."""
    stride = 8
    while stride < max_len:
        stride <<= 1
    return stride if stride <= max_stride else 0


def host_string_slab(values: np.ndarray, validity: np.ndarray,
                     capacity: int, max_stride: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A host string column (object values, None where null) as a char
    slab, (uint64 (capacity, stride/8), lens int32 (capacity,)), or None
    when its longest value exceeds ``max_stride`` bytes."""
    import pyarrow as pa
    arr = pa.array(values, type=pa.string(), from_pandas=True)
    n = len(arr)
    offs = (np.frombuffer(arr.buffers()[1], np.int32, count=n + 1,
                          offset=arr.offset * 4) if n
            else np.zeros(1, np.int32))
    chars = (np.frombuffer(arr.buffers()[2], np.uint8)
             if n and arr.buffers()[2] is not None else np.zeros(1, np.uint8))
    lens = offs[1:] - offs[:-1]
    stride = slab_stride_for(int(lens.max()) if n else 0, max_stride)
    if not stride:
        return None
    padded = np.full(capacity + 1, offs[-1], np.int32)
    padded[:n + 1] = offs
    slab, slens = np_build_slab(chars, padded, capacity, stride)
    slens[:n] = np.where(np.asarray(validity[:n], dtype=bool), slens[:n], 0)
    return slab, slens


def np_build_slab(chars: np.ndarray, offsets: np.ndarray, capacity: int,
                  stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side packed -> fixed-stride slab conversion: (slab uint64
    (capacity, stride/8), lens int32 (capacity,)). Bytes past each row's
    length are zero; byte j of a row sits at bit 8*(j%8) of word j//8."""
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    starts = offsets[:-1].astype(np.int64)
    nc = max(len(chars), 1)
    j = np.arange(stride)
    idx = np.clip(starts[:, None] + j[None, :], 0, nc - 1)
    mask = j[None, :] < lens[:, None]
    bytes_ = np.where(mask, chars[idx], 0).astype(np.uint64)
    shifts = np.uint64(8) * np.arange(8, dtype=np.uint64)
    words = (bytes_.reshape(capacity, stride // 8, 8)
             << shifts[None, None, :]).sum(axis=2, dtype=np.uint64)
    return words, lens.astype(np.int32)


def np_slab_to_packed(slab: np.ndarray, lens: np.ndarray,
                      validity: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side slab (uint64) -> packed chars + int32 offsets."""
    n, w = slab.shape
    stride = w * 8
    lens = np.clip(np.asarray(lens, np.int64), 0, stride)
    lens = np.where(validity, lens, 0)
    shifts = np.uint64(8) * np.arange(8, dtype=np.uint64)
    bytes_ = ((slab[:, :, None] >> shifts[None, None, :])
              & np.uint64(0xFF)).astype(np.uint8).reshape(n, stride)
    mask = np.arange(stride)[None, :] < lens[:, None]
    chars = np.ascontiguousarray(bytes_[mask])
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lens).astype(np.int32)
    return chars, offsets


def numpy_from_host_packed(chars: np.ndarray, offsets: np.ndarray,
                           validity: np.ndarray) -> np.ndarray:
    """Packed chars + offsets -> object array of python str (None where
    null), through pyarrow; invalid UTF-8 (a byte-oriented substring of a
    multi-byte character) decodes leniently, as in the JAX package."""
    import pyarrow as pa
    n = len(validity)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    chars = np.ascontiguousarray(chars, dtype=np.uint8)
    null_count = int(n - validity.sum())
    vbuf = (pa.py_buffer(np.packbits(validity, bitorder="little"))
            if null_count else None)
    arr = pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets), pa.py_buffer(chars), vbuf, null_count)
    try:
        arr.validate(full=True)
        return arr.to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, UnicodeDecodeError):
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = (bytes(chars[offsets[i]:offsets[i + 1]]).decode(
                "utf-8", errors="replace") if validity[i] else None)
        return out


def host_string_packed(values: np.ndarray, validity: np.ndarray,
                       capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """A host string column (object values, None where null) as plain
    (chars uint8, offsets int32 (capacity + 1,)): pyarrow's own buffers,
    null rows empty, padding rows empty."""
    import pyarrow as pa
    n = len(values)
    valid = np.asarray(validity[:n], dtype=bool)
    arr = pa.array(np.asarray(values, dtype=object), type=pa.string(),
                   mask=~valid if n else None, from_pandas=True)
    offs = (np.frombuffer(arr.buffers()[1], np.int32, count=n + 1,
                          offset=arr.offset * 4) if n
            else np.zeros(1, np.int32))
    offsets = np.empty(capacity + 1, np.int32)
    offsets[:n + 1] = offs - offs[0]
    offsets[n + 1:] = offsets[n]
    total = int(offsets[n])
    chars = np.zeros(max(total, 1), np.uint8)
    if total:
        chars[:total] = np.frombuffer(arr.buffers()[2], np.uint8,
                                      count=total, offset=int(offs[0]))
    return chars, offsets


# ---------------------------------------------------------------------------
# plain offsets+chars on the device (duck-typed: a DeviceColumn or an
# expression's DevCol, both of which carry every form's fields)
# ---------------------------------------------------------------------------

# widest per-row byte stride of a char slab (the JAX package's default
# spark.rapids.sql.dict.blockedChars.maxStride): an upload, a concat or a
# string function whose values would need a wider slab makes plain chars
MAX_SLAB_STRIDE = 64

# chars processed per step by the char-space loops: bounds their int64
# temporaries (8 bytes a char) on a column of a gigabyte of chars
CHAR_BLOCK = 1 << 25


def is_dict(col) -> bool:
    return col.dict_values is not None and col.dict_codes is not None


def is_slab(col) -> bool:
    return col.slab64 is not None and col.dict_values is None


def is_plain(col) -> bool:
    return (getattr(col, "chars", None) is not None
            and col.dict_values is None and col.slab64 is None)


def char_bucket(n: int) -> int:
    """Power-of-two char capacity >= n (at least 16), the JAX package's
    ``_char_capacity_for``."""
    cap = 16
    while cap < n:
        cap <<= 1
    return cap


@functools.lru_cache(maxsize=256)
def dict_char_tables(dict_values: tuple):
    """Host tables of a dictionary's values: (chars uint8, starts int32
    (card + 1,), lens int32 (card + 1,)); the trailing entry is the NULL
    sentinel (empty)."""
    raw = [v.encode("utf-8") for v in dict_values]
    dchars = np.frombuffer(b"".join(raw) or b"\0", np.uint8).copy()
    dlens = np.asarray([len(v) for v in raw] + [0], np.int32)
    dstarts = np.concatenate([[0], np.cumsum(dlens[:-1])]).astype(np.int32)
    return dchars, dstarts, dlens


def string_lens(col) -> torch.Tensor:
    """int32 (capacity,) byte length of each row of any string form, 0
    where invalid."""
    zero = torch.zeros((), dtype=torch.int32, device=col.validity.device)
    if is_dict(col):
        _c, _s, dlens = dict_char_tables(col.dict_values)
        lens = host_to_device(dlens, col.validity.device)[
            col.dict_codes.to(torch.int64).clamp(0, len(col.dict_values))]
    elif is_slab(col):
        lens = col.lens
    else:
        lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int32)
    return torch.where(col.validity, lens.to(torch.int32), zero)


def offsets_of(lens: torch.Tensor) -> torch.Tensor:
    """int32 (n + 1,) exclusive prefix sum of ``lens`` with the total."""
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                      device=lens.device)
    out[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    return out


def char_rows(offsets: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """int64 row owning each char position in [lo, hi) of a column with
    ``offsets`` (clamped into [0, capacity); positions past the total land
    on the last row)."""
    cap = offsets.shape[0] - 1
    k = torch.arange(lo, hi, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets[1:].contiguous(), k, right=True
                              ).clamp(max=max(cap - 1, 0))


def gather_chars(src: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, out_nchars: int):
    """(chars uint8 (out_nchars,), offsets int32 (rows + 1,)): row r takes
    ``lens[r]`` bytes of ``src`` from ``starts[r]``, packed in row order;
    bytes past the total are zero. ``out_nchars`` must hold the total.
    One char-space pass in blocks of CHAR_BLOCK, no host wait."""
    dev = src.device
    offsets = offsets_of(lens.to(torch.int32))
    out = torch.zeros(max(out_nchars, 1), dtype=torch.uint8, device=dev)
    nsrc = max(int(src.shape[0]), 1)
    if src.shape[0] == 0:
        return out, offsets
    starts64 = starts.to(torch.int64)
    total = offsets[-1]
    for lo in range(0, out_nchars, CHAR_BLOCK):
        hi = min(lo + CHAR_BLOCK, out_nchars)
        row = char_rows(offsets, lo, hi)
        k = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        pos = starts64[row] + (k - offsets[row])
        got = src[pos.clamp(0, nsrc - 1)]
        out[lo:hi] = torch.where(k < total, got, torch.zeros_like(got))
    return out, offsets


def plain_parts(col, min_capacity: int = 0):
    """(chars, offsets) of any string form: a plain column's own; a slab's
    rows packed (char capacity rows x stride); a dictionary's values
    gathered by code (char capacity rows x the longest value, bucketed).
    Invalid rows are empty."""
    dev = col.validity.device
    cap = int(col.validity.shape[0])
    if is_plain(col):
        return col.chars, col.offsets
    lens = string_lens(col)
    if is_slab(col):
        stride = int(col.slab64.shape[1]) * 8
        flat = col.slab64.contiguous().view(torch.uint8).reshape(-1)
        starts = torch.arange(cap, dtype=torch.int64, device=dev) * stride
        return gather_chars(flat, starts, lens,
                            max(cap * stride, min_capacity, 1))
    dchars, dstarts, dlens = dict_char_tables(col.dict_values)
    code = col.dict_codes.to(torch.int64).clamp(0, len(col.dict_values))
    starts = host_to_device(dstarts, dev)[code]
    max_len = int(dlens.max()) if len(dlens) else 0
    return gather_chars(host_to_device(dchars, dev), starts, lens,
                        max(char_bucket(cap * max(max_len, 1)),
                            min_capacity))


def as_plain(col):
    """``col`` in the plain form: itself if plain, else a DeviceColumn of
    its values rebuilt (``plain_parts``)."""
    if is_plain(col):
        return col
    chars, offsets = plain_parts(col)
    return DeviceColumn(col.dtype, None, col.validity, chars=chars,
                        offsets=offsets)


def plain_prefix_words(col, nbytes: int) -> torch.Tensor:
    """int64 (capacity, ceil(nbytes / 8)) slab words of each row's first
    ``nbytes`` bytes (slab layout: byte j at bit 8*(j%8) of word j//8,
    zero past the row's length) of a plain column: a (rows, nbytes)
    gather, whatever the longest value, in blocks of CHAR_BLOCK gathered
    bytes (its int64 index takes 8 bytes a byte: 32 GiB at 2^26 rows of
    64 bytes in one piece)."""
    width = max(8, -(-nbytes // 8) * 8)
    dev = col.chars.device
    cap = int(col.offsets.shape[0]) - 1
    lens = string_lens(col).to(torch.int64)
    j = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    nc = max(int(col.chars.shape[0]), 1)
    out = torch.empty((cap, width), dtype=torch.uint8, device=dev)
    rows = max(CHAR_BLOCK // width, 1)
    for lo in range(0, cap, rows):
        hi = min(lo + rows, cap)
        idx = (col.offsets[lo:hi].to(torch.int64)[:, None] + j).clamp(
            0, nc - 1)
        b = col.chars[idx]
        out[lo:hi] = torch.where(j < lens[lo:hi, None], b,
                                 torch.zeros_like(b))
    return out.view(torch.int64)


def string_values_have_nul(values: np.ndarray, validity: np.ndarray) -> bool:
    """True when a valid string holds a NUL byte. Dictionary encoding is
    gated on it: pandas factorize hashes object strings through a
    NUL-terminated path and MERGES 'a' with 'a\\x00' (the JAX package checks
    its char buffer for the same reason)."""
    import pyarrow as pa
    arr = pa.array(np.asarray(values, dtype=object), type=pa.string(),
                   mask=~np.asarray(validity, dtype=bool), from_pandas=True)
    if len(arr) == 0:
        return False
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32,
                            count=len(arr) + 1, offset=arr.offset * 4)
    used = int(offsets[-1] - offsets[0])
    if used == 0:
        return False
    chars = np.frombuffer(arr.buffers()[2], dtype=np.uint8, count=used,
                          offset=int(offsets[0]))
    return bool((chars == 0).any())


# host dictionary encoding, applied at upload (copied from the JAX package):
# the cardinality cap keeps the static dictionaries small host constants;
# the sample probe keeps the cost near-zero for high-cardinality columns.
DICT_MAX_CARD = 256
_DICT_PROBE = 4096


def dict_factorize_hint(values, is_string: bool):
    """Cardinality probe + full-column factorize. Returns (codes (n,),
    uniques) or None when the column is not a dictionary candidate."""
    import pandas as pd
    n = len(values)
    if n == 0:
        return None
    probe = values[:_DICT_PROBE]
    try:
        nu = pd.unique(probe[~pd.isna(probe)] if is_string else probe)
    except TypeError:
        return None
    if len(nu) > DICT_MAX_CARD or len(nu) > max(64, len(probe) // 4):
        return None
    try:
        codes, uniques = pd.factorize(values, use_na_sentinel=True)
    except TypeError:
        return None
    if len(uniques) > DICT_MAX_CARD or len(uniques) == 0:
        return None
    return codes, uniques


def host_dict_encode(values: np.ndarray, validity: Optional[np.ndarray],
                     dtype: DType, capacity: int, fact=None):
    """Host-side dictionary probe+encode of a column being uploaded.

    Returns (codes int32 (capacity,), values tuple) or None. Codes are in
    [0, card] with card = NULL/padding; ``values`` is sorted so identical
    value SETS across batches produce identical dictionaries.
    """
    n = len(values)
    if n == 0:
        return None
    if fact is None:
        fact = dict_factorize_hint(values, dtype.is_string)
        if fact is None:
            return None
    codes, uniques = fact
    card = len(uniques)
    if card > DICT_MAX_CARD or card == 0:
        return None
    if dtype.is_string:
        if any(not isinstance(u, str) for u in uniques):
            return None  # mixed/NA uniques: not a clean string dictionary
        vals = [str(u) for u in uniques]
        sort_key = np.asarray(vals, dtype=object)
    else:
        arr = np.asarray(uniques, dtype=dtype.np_dtype)
        if np.issubdtype(arr.dtype, np.floating):
            # NaN is a grouping VALUE (SQL NaN, not NULL) but factorize
            # maps it to the NA sentinel, which would collapse NaN keys
            # into the NULL group: such columns are not encoded
            vrows = np.asarray(values[:n], dtype=np.float64)
            if validity is not None:
                vrows = vrows[validity[:n]]
            if np.isnan(vrows).any():
                return None
        vals = arr.tolist()
        sort_key = arr
    order = np.argsort(sort_key, kind="stable")
    remap = np.empty(card + 1, dtype=np.int32)
    remap[order] = np.arange(card, dtype=np.int32)
    remap[card] = card  # null sentinel maps to itself
    new_codes = remap[np.where(codes < 0, card, codes)]
    if validity is not None:
        new_codes = np.where(validity[:n], new_codes, card)
    out = np.full(capacity, card, dtype=np.int32)
    out[:n] = new_codes.astype(np.int32)
    return out, tuple(vals[i] for i in order)


def host_dict_encode_stateful(values: np.ndarray,
                              validity: Optional[np.ndarray], dtype: DType,
                              capacity: int, state: Optional[dict],
                              key, fact=None) -> Optional[tuple]:
    """host_dict_encode with a per-scan registry: the FIRST batch of a scan
    establishes the dictionary and every later batch encodes against it, so
    all batches of one scan share one static dictionary. A later batch
    holding a value outside the established dictionary switches the column
    off for the remainder of the scan."""
    st = state.get(key) if state is not None else None
    if st is False:
        return None
    if st is None:
        enc = host_dict_encode(values, validity, dtype, capacity, fact=fact)
        if state is not None:
            state[key] = enc[1] if enc is not None else False
        return enc
    n = len(values)
    card = len(st)
    out = np.full(capacity, card, dtype=np.int32)
    if n == 0:
        return out, st
    arr = np.asarray(list(st),
                     dtype=object if dtype.is_string else dtype.np_dtype)
    need = (np.asarray(validity[:n], dtype=bool) if validity is not None
            else np.ones(n, dtype=bool))
    if fact is not None:
        codes2, uniq2 = fact
        try:
            u = np.asarray(uniq2,
                           dtype=object if dtype.is_string
                           else dtype.np_dtype)
            idx = np.searchsorted(arr, u)
        except (TypeError, ValueError):
            state[key] = False
            return None
        idx_c = np.clip(idx, 0, card - 1)
        ok_u = arr[idx_c] == u
        remap = np.empty(len(u) + 1, dtype=np.int32)
        remap[:len(u)] = np.where(ok_u, idx_c, -1)
        remap[len(u)] = -1
        codes_n = np.asarray(codes2[:n])
        c = remap[np.where(codes_n < 0, len(u), codes_n)]
        if bool(((c < 0) & need).any()):
            state[key] = False  # unseen value in a valid row
            return None
        out[:n] = np.where(need, c, card).astype(np.int32)
        return out, st
    vals_n = np.asarray(values[:n],
                        dtype=object if dtype.is_string else dtype.np_dtype)
    # null slots may hold None/NaN fills that break object comparisons;
    # park them on a real dictionary entry (their codes are overridden)
    vals_n = np.where(need, vals_n, arr[0])
    try:
        idx = np.searchsorted(arr, vals_n)
    except TypeError:
        state[key] = False
        return None
    idx_c = np.clip(idx, 0, card - 1)
    ok = arr[idx_c] == vals_n
    if not bool(np.all(ok | ~need)):
        state[key] = False  # unseen value: dictionary closed for this scan
        return None
    out[:n] = np.where(need, idx_c, card).astype(np.int32)
    return out, st
