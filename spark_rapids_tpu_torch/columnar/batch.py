"""Device-resident columnar batches (torch counterpart of the JAX package's
``columnar/batch.py``).

``DeviceBatch`` holds columns of torch tensors, a static capacity and a
0-d int32 device tensor ``num_rows``, so a step (filter, aggregate) never
waits for the host: a filter's output count is data, not shape. The count
reaches the host only at ``to_pandas`` (the collect), inside a
``sync_scope``.

Capacity bucketing follows the JAX package (power-of-two buckets from
``MIN_CAPACITY``), so both packages pad batches identically.

``device_memory_size`` (the JAX package's rule: the bytes of every tensor
of the batch) is host metadata, read without touching the device; the
spill store (``memory/spill.py``) moves a batch as the flat tensor list of
``flatten_batch`` and rebuilds it with ``unflatten_batch``, the part of
``jax.tree_util`` the JAX package's spill takes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, host_dict_encode_stateful, host_string_packed,
    np_build_slab, slab_stride_for, string_values_have_nul,
)
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.obs.syncledger import sync_scope

MIN_CAPACITY = 8


def bucket_capacity(n: int, growth: float = 2.0,
                    minimum: int = MIN_CAPACITY) -> int:
    """Smallest capacity bucket >= n. growth=2.0 -> power-of-two buckets."""
    assert growth > 1.0, f"bucket growth must exceed 1.0, got {growth}"
    cap = minimum
    while cap < n:
        cap = int(np.ceil(cap * growth))
    return cap


class Schema:
    """Ordered (name, dtype) pairs."""

    def __init__(self, names: Sequence[str], dtypes_: Sequence[DType]):
        assert len(names) == len(dtypes_)
        self.names: Tuple[str, ...] = tuple(names)
        self.dtypes: Tuple[DType, ...] = tuple(dtypes_)

    def __len__(self) -> int:
        return len(self.names)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema) and self.names == other.names
                and self.dtypes == other.dtypes)

    def __hash__(self) -> int:
        return hash((self.names, self.dtypes))

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {d}" for n, d in zip(self.names, self.dtypes))
        return f"Schema({cols})"

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def dtype_of(self, name: str) -> DType:
        return self.dtypes[self.index_of(name)]

    @staticmethod
    def from_pandas(df: pd.DataFrame) -> "Schema":
        names, dts = [], []
        for i, name in enumerate(df.columns):
            names.append(str(name))
            dts.append(_pandas_col_dtype(df.iloc[:, i]))
        return Schema(names, dts)


class DeviceBatch:
    """Columns + a 0-d int32 device row count; static capacity."""

    def __init__(self, schema: Schema, columns: List[DeviceColumn],
                 num_rows: torch.Tensor):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows
        # the row count where the host knows it (an upload), else None
        self.host_rows: Optional[int] = None
        # a row count the host expects but has not verified (a speculated
        # join expansion's cached total): a hint only, never exact
        self.rows_hint: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def column(self, name: str) -> DeviceColumn:
        return self.columns[self.schema.index_of(name)]

    def row_mask(self) -> torch.Tensor:
        """bool (capacity,): True for live rows (the leading num_rows)."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def num_rows_hint(self) -> int:
        """The row count as far as the host can tell without a sync: the
        count where the host knows it, else a speculated count (exact once
        the query's speculation is verified), else the capacity, an upper
        bound."""
        if self.host_rows is not None:
            return self.host_rows
        return self.rows_hint if self.rows_hint is not None \
            else self.capacity

    def num_rows_host(self) -> int:
        with sync_scope("batch.rowCount", nbytes=4):
            return int(self.num_rows.item())

    def device_memory_size(self) -> int:
        """Bytes of device storage held by this batch: every tensor's
        elements (a strided view counts its own elements). Host metadata,
        no device work."""
        return sum(t.numel() * t.element_size()
                   for t in flatten_batch(self)[0])

    def __repr__(self) -> str:
        return (f"DeviceBatch(capacity={self.capacity}, "
                f"schema={self.schema})")

    # --- conversion --------------------------------------------------------
    @staticmethod
    def from_pandas(df: pd.DataFrame, dict_state: Optional[dict] = None,
                    dict_numerics: bool = True, device="cuda",
                    slab_stride: int = 0,
                    schema: Optional[Schema] = None,
                    dict_encode: bool = True) -> "DeviceBatch":
        """Host -> device upload (reference: GpuRowToColumnarExec), padded
        to ``bucket_capacity(len(df))``.

        Each column is probed for low cardinality and gets a host
        dictionary, as in the JAX package: ``dict_state`` makes every batch
        of one scan share one dictionary; ``dict_numerics=False`` probes
        only string columns, ``dict_encode=False`` none
        (``spark.rapids.sql.dict.enabled=false``). A string column that
        does not dictionary-encode uploads, by the JAX package's rule, as a char
        slab when its longest value fits ``slab_stride`` bytes (0: never),
        else as plain offsets and chars. Under ``dict_state`` a column's
        slab stride is the widest any earlier batch of the scan took, and a
        column that once went plain stays plain for the scan. ``schema``
        types the columns (default: from the frame's dtypes)."""
        device = torch.device(device)
        if schema is None:
            schema = Schema.from_pandas(df)
        n = len(df)
        cap = bucket_capacity(n)
        cols = []
        for i, dt in enumerate(schema.dtypes):
            values, validity = _pandas_to_numpy(df.iloc[:, i], dt)
            data, vpad = DeviceColumn.build_host_buffers(values, validity,
                                                         dt, cap)
            if not dict_encode:
                enc = None
            elif dt.is_string and not validity[:n].any():
                # an empty or all-null string column: an empty dictionary,
                # every code the NULL sentinel; the registry stays open
                enc = (np.zeros(cap, dtype=np.int32), ())
            elif dict_numerics or dt.is_string:
                enc = host_dict_encode_stateful(values, validity, dt, cap,
                                                dict_state, i)
            else:
                enc = None
            if (enc is not None and dt.is_string
                    and string_values_have_nul(values, validity)):
                enc = None
                if dict_state is not None:
                    dict_state[i] = False  # close for the whole scan
            if enc is None and dt.is_string:
                cols.append(_upload_chars(values, vpad, cap, slab_stride,
                                          dict_state, i, device))
                continue
            codes, dvals = enc if enc is not None else (None, None)
            cols.append(DeviceColumn.from_host_buffers(dt, data, vpad, codes,
                                                       dvals, device))
        num_rows = torch.tensor(n, dtype=torch.int32, device=device)
        batch = DeviceBatch(schema, cols, num_rows)
        batch.host_rows = n
        return batch

    def to_pandas(self) -> pd.DataFrame:
        """Device -> host (the collect): the row count, then every column's
        leading rows."""
        n = self.num_rows_host()
        nbytes = sum(c.validity[:n].numel() * _row_bytes(c)
                     for c in self.columns)
        with sync_scope("batch.fetch", nbytes=nbytes):
            series: List[pd.Series] = []
            for dt, col in zip(self.schema.dtypes, self.columns):
                values, validity = col.to_numpy(n)
                series.append(_numpy_to_pandas(values, validity, dt)
                              .reset_index(drop=True))
        if not series:
            return pd.DataFrame(index=range(n))
        df = pd.concat(series, axis=1)
        df.columns = list(self.schema.names)
        return df


def _upload_chars(values: np.ndarray, vpad: np.ndarray, cap: int,
                  max_stride: int, dict_state: Optional[dict], i: int,
                  device) -> DeviceColumn:
    """A string column that did not dictionary-encode, on the device: a
    char slab when its longest value fits ``max_stride`` (the per-scan
    stride registry of the JAX package: later batches pad to the widest
    stride seen, and a column past the limit stays plain), else plain
    offsets and chars."""
    from spark_rapids_tpu_torch.columnar import dtypes as dts
    chars, offsets = host_string_packed(values, vpad, cap)
    n = len(values)
    stride = 0
    if max_stride > 0:
        max_len = int((offsets[1:n + 1] - offsets[:n]).max()) if n else 0
        stride = slab_stride_for(max_len, max_stride)
        if dict_state is not None:
            prev = int(dict_state.get(("slab", i), 0) or 0)
            stride = 0 if prev < 0 or not stride else max(stride, prev)
            dict_state[("slab", i)] = stride if stride else -1
    validity = torch.from_numpy(vpad).to(device)
    if stride:
        words, lens = np_build_slab(chars, offsets, cap, stride)
        lens = np.where(vpad, lens, 0).astype(np.int32)
        return DeviceColumn(
            dts.STRING, None, validity,
            slab64=torch.from_numpy(words.view(np.int64)).to(device),
            lens=torch.from_numpy(lens).to(device))
    return DeviceColumn(dts.STRING, None, validity,
                        chars=torch.from_numpy(chars).to(device),
                        offsets=torch.from_numpy(offsets).to(device))


# the tensor fields of a DeviceColumn, in flatten order
_COLUMN_TENSORS = ("data", "validity", "dict_codes", "slab64", "lens",
                   "chars", "offsets")


def flatten_batch(batch: DeviceBatch) -> Tuple[List[torch.Tensor], tuple]:
    """(tensors, layout): the batch's row count, then each column's present
    tensors (data, validity, dictionary codes, char slab, lengths, chars,
    offsets) in that order; ``layout`` holds the rest (schema, dictionary values, which
    fields are present, the host row count) for ``unflatten_batch``."""
    tensors = [batch.num_rows]
    cols = []
    for col in batch.columns:
        present = tuple(f for f in _COLUMN_TENSORS
                        if getattr(col, f) is not None)
        tensors.extend(getattr(col, f) for f in present)
        cols.append((col.dtype, col.dict_values, present))
    return tensors, (batch.schema, tuple(cols), batch.host_rows)


def unflatten_batch(tensors: Sequence[torch.Tensor],
                    layout: tuple) -> DeviceBatch:
    """The batch ``flatten_batch`` took apart, over ``tensors``."""
    schema, cols, host_rows = layout
    it = iter(tensors)
    num_rows = next(it)
    columns = []
    for dtype, dict_values, present in cols:
        fields = {f: next(it) for f in present}
        columns.append(DeviceColumn(
            dtype, fields.get("data"), fields["validity"],
            fields.get("dict_codes"), dict_values, fields.get("slab64"),
            fields.get("lens"), fields.get("chars"), fields.get("offsets")))
    batch = DeviceBatch(schema, columns, num_rows)
    batch.host_rows = host_rows
    return batch


def _row_bytes(col: DeviceColumn) -> int:
    """Device bytes a collect fetches per row of ``col`` (besides its
    validity byte): the slab row and its length, a code, or the value; a
    plain column's offset and its mean bytes a row (its char capacity
    spread over its rows)."""
    if col.is_plain:
        return 4 + -(-int(col.chars.shape[0]) // max(col.capacity, 1))
    if col.has_slab:
        return col.char_stride + 4
    return 4 if col.dtype.is_string else col.dtype.itemsize


# ---------------------------------------------------------------------------
# pandas <-> numpy(+mask) helpers (copied from the JAX package)
# ---------------------------------------------------------------------------

def _pandas_col_dtype(s: pd.Series) -> DType:
    dt = s.dtype
    name = str(dt)
    mapping = {
        "boolean": dtypes.BOOL, "bool": dtypes.BOOL,
        "Int8": dtypes.INT8, "int8": dtypes.INT8,
        "Int16": dtypes.INT16, "int16": dtypes.INT16,
        "Int32": dtypes.INT32, "int32": dtypes.INT32,
        "Int64": dtypes.INT64, "int64": dtypes.INT64,
        "Float32": dtypes.FLOAT32, "float32": dtypes.FLOAT32,
        "Float64": dtypes.FLOAT64, "float64": dtypes.FLOAT64,
    }
    if name in mapping:
        return mapping[name]
    if name.startswith("datetime64"):
        return dtypes.TIMESTAMP_US
    if name in ("object", "str", "string"):
        return dtypes.STRING
    raise TypeError(f"unsupported pandas dtype: {name}")


def _pandas_to_numpy(s: pd.Series, dt: DType) -> Tuple[np.ndarray, np.ndarray]:
    """Null discipline: numpy-backed numeric/bool columns are all-valid
    (float NaN is a *value*, like SQL NaN, not NULL); nullable extension
    dtypes use their mask; datetime64 NaT and object-column None are NULL."""
    if (not dt.is_string and isinstance(s.dtype, np.dtype)
            and s.dtype.kind in "biuf"):
        validity = np.ones(len(s), dtype=np.bool_)
        return s.to_numpy(dtype=dt.np_dtype), validity
    validity = (~s.isna()).to_numpy(dtype=np.bool_)
    if dt.is_string:
        vals = s.to_numpy(dtype=object)
        if not validity.all():
            vals = vals.copy()
            vals[~validity] = None
        return vals, validity
    if dt == dtypes.DATE32:
        if str(s.dtype).startswith("datetime64") or str(s.dtype) == "object":
            vals = pd.to_datetime(s).to_numpy(dtype="datetime64[D]")
            return vals.astype(np.int64).astype(np.int32), validity
        return s.to_numpy(dtype=np.int32, na_value=0), validity
    if dt == dtypes.TIMESTAMP_US:
        if str(s.dtype).startswith("datetime64"):
            out = s.to_numpy(dtype="datetime64[us]").astype(np.int64)
            if not validity.all():
                out = np.where(validity, out, 0)
            return out, validity
        if str(s.dtype) == "object":
            vals = pd.to_datetime(s).to_numpy(dtype="datetime64[us]")
            out = vals.astype(np.int64)
            out = np.where(validity, out, 0)
            return out, validity
        return s.to_numpy(dtype=np.int64, na_value=0), validity
    fill = dtypes.null_fill_value(dt)
    return s.to_numpy(dtype=dt.np_dtype, na_value=fill), validity


def _numpy_to_pandas(values: np.ndarray, validity: np.ndarray,
                     dt: DType) -> pd.Series:
    has_nulls = not bool(validity.all()) if len(validity) else False
    if dt.is_string:
        return pd.Series(values, dtype="str")
    if dt == dtypes.DATE32:
        out = values.astype("datetime64[D]").astype("datetime64[s]")
        s = pd.Series(out)
        if has_nulls:
            s = s.mask(~validity)
        s.attrs["srt_logical_dtype"] = "date32"
        return s
    if dt == dtypes.TIMESTAMP_US:
        out = values.astype("datetime64[us]")
        s = pd.Series(out)
        if has_nulls:
            s = s.mask(~validity)
        return s
    if has_nulls:
        s = pd.Series(values, dtype=dt.pandas_nullable)
        return s.mask(~validity)
    return pd.Series(values)
