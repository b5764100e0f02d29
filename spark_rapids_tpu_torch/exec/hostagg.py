"""Host-side grouped reductions, the CPU path's aggregate (a copy of the
JAX package's ``exec/hostagg.py``).

Implemented with factorize + stable sort + ``np.ufunc.reduceat`` segments —
the same sort-segment shape as the device kernel (ops/groupby.py) so the two
paths share null/NaN semantics exactly (pandas' skipna conventions would
silently diverge)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.dtype import DType


def group_codes(keys: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, int]:
    """Combine (values, validity) key columns into dense group codes.

    NULL is its own group; float NaN is its own group; -0.0 == 0.0."""
    n = len(keys[0][0]) if keys else 0
    combined = np.zeros(n, dtype=np.int64)
    for values, validity in keys:
        if values.dtype == object:
            # NUL-exact string factorization via arrow: pandas 3.x
            # factorize hashes object strings through a NUL-terminated
            # path and merges 'a' with 'a\x00'
            import pyarrow as pa
            vals = np.where(validity, values, "")
            codes = (pa.array(vals, type=pa.string(), from_pandas=True)
                     .dictionary_encode().indices
                     .to_numpy(zero_copy_only=False).astype(np.int64))
        elif values.dtype.kind == "f":
            vals = np.where(validity, np.where(values == 0.0, 0.0, values), 0.0)
            codes, _ = pd.factorize(vals)
            codes = codes.astype(np.int64)
        else:
            vals = np.where(validity, values, np.zeros(1, dtype=values.dtype))
            codes, _ = pd.factorize(vals)
            codes = codes.astype(np.int64)
        nan_code = codes.max(initial=-1) + 1
        codes = np.where(codes == -1, nan_code, codes)  # NaN group
        codes = np.where(validity, codes + 1, 0)        # NULL group = 0
        combined = combined * (codes.max(initial=0) + 1) + codes
        combined, _ = pd.factorize(combined)
        combined = combined.astype(np.int64)
    return combined, int(combined.max(initial=-1)) + 1


def segment_reduce_host(kind: str, values: np.ndarray, validity: np.ndarray,
                        order: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray,
                        out_dt: DType) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce one column over sorted segments. ``order`` sorts rows by group,
    ``starts``/``ends`` delimit segments in sorted space."""
    n = len(values)
    num_groups = len(starts)
    vs = values[order]
    val_s = validity[order]
    has_valid = (np.add.reduceat(val_s.astype(np.int64), starts) > 0
                 if n else np.zeros(0, np.bool_))

    if kind == "count_valid":
        data = np.add.reduceat(val_s.astype(np.int64), starts)
        return data.astype(out_dt.np_dtype), np.ones(num_groups, np.bool_)
    if kind == "sum":
        x = np.where(val_s, vs, np.zeros(1, dtype=vs.dtype)).astype(out_dt.np_dtype)
        data = np.add.reduceat(x, starts)
        return data, has_valid
    if kind in ("min", "max"):
        if vs.dtype == object:
            # lexicographic min/max over strings; python str comparison is
            # code-point order == UTF-8 byte order, matching Spark/cuDF
            out = np.empty(num_groups, dtype=object)
            pick = min if kind == "min" else max
            for g in range(num_groups):
                seg_valid = val_s[starts[g]:ends[g]]
                seg = vs[starts[g]:ends[g]][seg_valid]
                out[g] = pick(seg) if len(seg) else None
            return out, has_valid
        if vs.dtype.kind == "f":
            neutral = np.inf if kind == "min" else -np.inf
        elif vs.dtype.kind == "b":
            vs = vs.astype(np.int64)
            neutral = 1 if kind == "min" else 0
        else:
            ii = np.iinfo(vs.dtype)
            neutral = ii.max if kind == "min" else ii.min
        x = np.where(val_s, vs, np.asarray(neutral, dtype=vs.dtype))
        op = np.minimum if kind == "min" else np.maximum
        data = op.reduceat(x, starts)
        return data.astype(out_dt.np_dtype), has_valid
    if kind in ("first", "last", "first_valid", "last_valid"):
        pos = np.arange(n, dtype=np.int64)
        if kind.endswith("_valid"):
            if kind.startswith("first"):
                p = np.where(val_s, pos, n)
                sel = np.minimum.reduceat(p, starts)
            else:
                p = np.where(val_s, pos, -1)
                sel = np.maximum.reduceat(p, starts)
            has = (sel >= 0) & (sel < n)
            sel_c = np.clip(sel, 0, max(n - 1, 0))
        else:
            sel_c = starts if kind == "first" else (ends - 1)
            has = np.ones(num_groups, np.bool_)
        if vs.dtype == object:
            data = vs[sel_c]
        else:
            data = vs[sel_c].astype(out_dt.np_dtype)
        validity = np.where(has, val_s[sel_c], False)
        return data, validity
    raise ValueError(f"unknown reduction kind: {kind}")


def grouped_aggregate(keys: List[Tuple[np.ndarray, np.ndarray]],
                      reductions: List[Tuple[str, np.ndarray, np.ndarray, DType]],
                      ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                 List[Tuple[np.ndarray, np.ndarray]]]:
    """Group rows by ``keys`` and apply ``reductions`` (kind, values,
    validity, out_dtype). Returns (key outputs, reduction outputs), one row
    per group in first-occurrence order of the sorted codes."""
    if keys:
        codes, num_groups = group_codes(keys)
    else:
        n = len(reductions[0][1]) if reductions else 0
        codes = np.zeros(n, dtype=np.int64)
        num_groups = 1 if n else 1  # global agg: always one group (even empty)
    n = len(codes)
    if n == 0:
        order = np.zeros(0, np.int64)
        if keys:
            starts = np.zeros(0, np.int64)
            ends = np.zeros(0, np.int64)
            num_groups = 0
        else:
            # global aggregate over empty input still yields one group
            key_out = []
            red_out = []
            for kind, values, validity, out_dt in reductions:
                if kind == "count_valid":
                    red_out.append((np.zeros(1, out_dt.np_dtype),
                                    np.ones(1, np.bool_)))
                else:
                    fill = dtypes.null_fill_value(out_dt) if not out_dt.is_string else None
                    arr = (np.array([fill], dtype=out_dt.np_dtype)
                           if not out_dt.is_string else np.array([None], dtype=object))
                    red_out.append((arr, np.zeros(1, np.bool_)))
            return [], red_out
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    if n:
        boundary = np.concatenate([[True], sorted_codes[1:] != sorted_codes[:-1]])
        starts = np.flatnonzero(boundary)
        ends = np.concatenate([starts[1:], [n]])
        num_groups = len(starts)
    else:
        starts = np.zeros(0, np.int64)
        ends = np.zeros(0, np.int64)
        num_groups = 0

    key_out = []
    for values, validity in keys:
        rep = order[starts] if n else np.zeros(0, np.int64)
        key_out.append((values[rep], validity[rep]))
    red_out = []
    for kind, values, validity, out_dt in reductions:
        red_out.append(segment_reduce_host(kind, values, validity, order,
                                           starts, ends, out_dt))
    return key_out, red_out
