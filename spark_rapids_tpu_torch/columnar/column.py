"""Device-resident column vectors (torch counterpart of the JAX package's
``columnar/column.py``).

A column is a plain object holding torch tensors: ``data`` of shape
(capacity,) in the physical dtype, ``validity`` bool (capacity,), and for
dictionary-encoded columns ``dict_codes`` int32 (capacity,) against
``dict_values``, a static host tuple in canonical sorted order
(code == len(dict_values) is the NULL/padding sentinel). Capacity is static
and the live row count rides on the batch, as in the JAX package.

A string column has ``data`` None and one of two device forms:

  * dictionary codes, as above;
  * a char slab (the JAX package's blocked chars): ``slab64`` int64
    (capacity, stride/8) holding uint64 bit patterns, row i's byte j at bit
    8*(j%8) of word j//8 and zero past the row's length, plus ``lens`` int32
    (capacity,). The device Parquet scan builds slabs for plain byte-array
    columns (kernel B8) and for dictionaries too large to hold on the host.
    Rows move as one 2-D gather; ``to_numpy`` unpacks them on the host.

The pandas upload (``DeviceBatch.from_pandas``) makes a dictionary of a
low-cardinality string column and a slab of any other, at the stride its
caller allows (the scan's upload: any width).

The host dictionary encoding (``dict_factorize_hint``, ``host_dict_encode``,
``host_dict_encode_stateful``) is a copy of the JAX package's numpy code.
"""

from __future__ import annotations

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


def plain_strings_unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: plain (non-dictionary) string columns are not ported yet; "
        "only dictionary-encoded strings reach device code in this slice")


class DeviceColumn:
    """One column on the device (see the module docstring for layout)."""

    def __init__(self, dtype: DType, data: Optional[torch.Tensor],
                 validity: torch.Tensor,
                 dict_codes: Optional[torch.Tensor] = None,
                 dict_values: Optional[tuple] = None,
                 slab64: Optional[torch.Tensor] = None,
                 lens: Optional[torch.Tensor] = None):
        if dtype.is_string:
            has_dict = dict_values is not None and dict_codes is not None
            if not has_dict and (slab64 is None or lens is None):
                raise plain_strings_unsupported("DeviceColumn")
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

    @property
    def has_slab(self) -> bool:
        """True for a char-slab string column (no dictionary codes)."""
        return self.slab64 is not None and self.dict_values is None

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
        if self.has_slab:
            slab = self.slab64[:num_rows].cpu().numpy().view(np.uint64)
            lens = self.lens[:num_rows].cpu().numpy()
            chars, offsets = np_slab_to_packed(slab, lens, validity)
            return strings_from_packed(chars, offsets, validity), validity
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


def strings_from_packed(chars: np.ndarray, offsets: np.ndarray,
                        validity: np.ndarray) -> np.ndarray:
    """Packed chars + offsets -> object array of python str (None where
    null), through pyarrow."""
    import pyarrow as pa
    n = len(validity)
    null_count = int(n - validity.sum())
    vbuf = (pa.py_buffer(np.packbits(validity, bitorder="little"))
            if null_count else None)
    arr = pa.StringArray.from_buffers(
        n, pa.py_buffer(np.ascontiguousarray(offsets)),
        pa.py_buffer(np.ascontiguousarray(chars)), vbuf, null_count)
    return arr.to_numpy(zero_copy_only=False)


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
