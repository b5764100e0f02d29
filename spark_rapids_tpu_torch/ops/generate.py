"""explode(split(str, delim)) on the device (counterpart of the JAX
package's ``ops/generate.py``; reference: GpuGenerateExec.scala).

Two steps, as in the JAX package: ``explode_totals`` gives the output's
row count and the char totals its plain string columns need, which the
operator reads in one host sync (``exec/generate.py``); ``explode_split``
then builds the output at capacities sized from them. The source column
may take any string form: a dictionary or a slab is rebuilt into plain
offsets and chars first (``columnar/column.as_plain``), and the
delimiters are found in char space.

Every child column is copied once per token (Spark's Generate keeps the
child's output, the source text included). A plain column's copy needs
the sum over rows of its length times the row's tokens: that total sizes
its output chars, which int32 offsets address, so a batch whose copy
would pass 2^31 chars raises (``check_char_totals``); it never wraps.
The JAX package computes this in jnp outside any Pallas kernel; here it
is torch code.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, as_plain, gather_chars, is_plain, string_lens,
)
from spark_rapids_tpu_torch.ops.rowops import MAX_PLAIN_CHARS, gather_columns


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """int64 (n + 1,) exclusive prefix sum of ``x`` with the total."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    out[1:] = torch.cumsum(x, 0, dtype=torch.int64)
    return out


def _token_layout(batch: DeviceBatch, col_idx: int, delim: int):
    """(the source as plain chars, tokens a row int64, the delimiters'
    char positions in ascending order, the index of each row's first
    delimiter in that list). A NULL or padding row has no token; an empty
    string has one (empty) token."""
    src = batch.columns[col_idx]
    col = as_plain(src)
    cap = batch.capacity
    chars, offsets = col.chars, col.offsets.to(torch.int64)
    dev = chars.device
    k = torch.arange(chars.shape[0], dtype=torch.int64, device=dev)
    is_delim = (chars == delim) & (k < offsets[cap])
    before = _prefix(is_delim.to(torch.int64))       # delimiters before k
    delim_offsets = before[offsets[:-1]]
    delims = before[offsets[1:]] - delim_offsets
    valid = col.validity & batch.row_mask()
    tokens = torch.where(valid, delims + 1, torch.zeros_like(delims))
    # compact the delimiter positions to the front (non-delimiters write a
    # dump slot past the end): no host sync
    n = int(chars.shape[0])
    slot = torch.where(is_delim, before[1:] - 1, torch.full_like(k, n))
    delim_pos = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    delim_pos.scatter_(0, slot, k)
    return col, tokens, delim_pos, delim_offsets


def explode_totals(batch: DeviceBatch, col_idx: int,
                   delim: int) -> torch.Tensor:
    """int64 [output rows, then for each string column of the batch the
    chars its copy needs (0 for a dictionary or a slab, whose rows move
    without chars), then the token column's chars]: the host sync before
    the expansion."""
    col, tokens, _pos, _off = _token_layout(batch, col_idx, delim)
    totals = [tokens.sum()]
    for c in batch.columns:
        if c.dtype.is_string:
            totals.append((string_lens(c).to(torch.int64) * tokens).sum()
                          if is_plain(c) else tokens.sum() * 0)
    # a row's token chars are its chars less its delimiters
    lens = string_lens(col).to(torch.int64)
    live = tokens > 0
    totals.append(torch.where(live, lens - (tokens - 1),
                              torch.zeros_like(lens)).sum())
    return torch.stack(totals)


def check_char_totals(schema: Schema, totals: Sequence[int],
                      out_name: str) -> None:
    """Raise where a plain column's copy or the token column would pass
    the 2^31 chars int32 offsets address."""
    names = [n for n, dt in zip(schema.names, schema.dtypes) if dt.is_string]
    for name, chars in zip(names + [out_name], totals):
        if chars > MAX_PLAIN_CHARS:
            raise ValueError(
                f"explode: column {name!r} would need {chars} chars in one "
                f"output batch, past the {MAX_PLAIN_CHARS} that int32 "
                "offsets address; use smaller input batches "
                "(spark.rapids.sql.batchSizeRows)")


def explode_split(batch: DeviceBatch, col_idx: int, delim: int,
                  out_name: str, out_cap: int,
                  char_caps: Sequence[Optional[int]], tok_char_cap: int,
                  with_pos: bool, pos_name: str = "pos") -> DeviceBatch:
    """The child's columns copied per token, then [pos INT32], then the
    token STRING column (plain), at ``out_cap`` rows. ``char_caps``: one
    entry a column, the output char capacity of a plain column (None
    otherwise); ``tok_char_cap`` the token column's."""
    col, tokens, delim_pos, delim_offsets = _token_layout(batch, col_idx,
                                                          delim)
    cap = batch.capacity
    dev = tokens.device
    offsets = col.offsets.to(torch.int64)
    tok_offsets = _prefix(tokens)
    total = tok_offsets[cap]
    t = torch.arange(out_cap, dtype=torch.int64, device=dev)
    out_live = t < total
    out_row = torch.searchsorted(tok_offsets[1:].contiguous(), t,
                                 right=True).clamp(max=cap - 1)
    k = t - tok_offsets[out_row]                  # the token's ordinal
    d_base = delim_offsets[out_row]
    last = max(int(delim_pos.shape[0]) - 1, 0)
    starts = torch.where(k == 0, offsets[out_row],
                         delim_pos[(d_base + k - 1).clamp(0, last)] + 1)
    ends = torch.where(k == tokens[out_row] - 1, offsets[out_row + 1],
                       delim_pos[(d_base + k).clamp(0, last)])
    tok_len = torch.where(out_live, (ends - starts).clamp(min=0),
                          torch.zeros_like(ends))
    cols = gather_columns(batch.columns, out_row, out_live, char_caps)
    names, dts = list(batch.schema.names), list(batch.schema.dtypes)
    if with_pos:
        cols.append(DeviceColumn(dtypes.INT32, torch.where(
            out_live, k, torch.zeros_like(k)).to(torch.int32), out_live))
        names.append(pos_name)
        dts.append(dtypes.INT32)
    tchars, toffsets = gather_chars(col.chars, starts, tok_len, tok_char_cap)
    cols.append(DeviceColumn(dtypes.STRING, None, out_live, chars=tchars,
                             offsets=toffsets))
    names.append(out_name)
    dts.append(dtypes.STRING)
    return DeviceBatch(Schema(names, dts), cols, total.to(torch.int32))
