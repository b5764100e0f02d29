"""The Mortgage ETL's ColumnarRdd export as the port's tests and
``chip_smoke.py`` check it (``ml/columnar_rdd.py``).

The trainer's matrix is the ETL's numeric and boolean output columns
(``ETL_FEATURES``; its timestamps and strings are not features), the
label ``delinquency_12`` (``models/mortgage.py``). ``drain`` runs every
partition of an export and keeps, per batch, the feature matrix, the
label, the live-row mask, the key columns and the features' validity on
the batch's device, with no transfer to the host, so that the drain's
counted syncs are the plan's own. ``live_rows`` then brings the live rows
to the host, and ``same_rows`` holds them to a collect of the same ETL as
``testing/mortgagecases.same_answer`` holds the ETL: rows in the order of
the ETL's keys (unique), keys and integer-valued features exact, float
features at ``rtol`` after the float32 cast (float sums over atomics
differ between runs, C.3), a NULL of the collect a NULL in the export.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.testing.mortgagecases import KEYS

ETL_KEYS = KEYS["etl"]
ETL_LABEL = "delinquency_12"
ETL_FEATURES = [
    "loan_id", "interest_rate", "current_actual_upb", "loan_age",
    "current_loan_delinquency_status", "monthly_reporting_period_day",
    "ever_30", "ever_90", "ever_180", "upb_12", "orig_interest_rate",
    "orig_upb", "orig_loan_term", "orig_ltv", "dti",
    "borrower_credit_score", "zip"]
F32_RTOL = 1e-6


def drain(parts, features: List[str] = ETL_FEATURES,
          label: str = ETL_LABEL, keys: List[str] = ETL_KEYS) -> List[dict]:
    """Every batch of the export's partitions as device tensors: ``x``,
    ``y``, ``mask`` (``to_feature_matrix``), ``keys`` (the key columns'
    int64 data) and ``valid`` (the features' validity, rows x k)."""
    from spark_rapids_tpu_torch.ml.columnar_rdd import to_feature_matrix
    out = []
    for part in parts:
        for batch in part():
            x, y, mask = to_feature_matrix(batch, features, label)
            out.append({
                "x": x, "y": y, "mask": mask,
                "keys": torch.stack([batch.column(k).data.to(torch.int64)
                                     for k in keys], dim=1),
                "valid": torch.stack([batch.column(n).validity
                                      for n in features], dim=1),
                "y_valid": batch.column(label).validity})
    return out


def matrix_stats(drained: List[dict]) -> Dict[str, int]:
    """Batches, the matrices' rows (capacity) and their device bytes."""
    rows = sum(int(d["x"].shape[0]) for d in drained)
    nbytes = sum(d["x"].numel() * d["x"].element_size()
                 + d["y"].numel() * d["y"].element_size()
                 + d["mask"].numel() * d["mask"].element_size()
                 for d in drained)
    return {"batches": len(drained), "matrix_rows": rows,
            "matrix_bytes": nbytes}


def live_rows(drained: List[dict]) -> Dict[str, np.ndarray]:
    """The live rows of every batch, on the host."""
    def cat(name):
        parts = [d[name][d["mask"]] for d in drained]
        return torch.cat(parts).cpu().numpy() if parts else np.zeros(0)
    return {n: cat(n) for n in ("x", "y", "keys", "valid", "y_valid")}


def _frame_values(s: pd.Series):
    """(float64 values, null mask) of a collected column."""
    null = s.isna().to_numpy()
    if pd.api.types.is_datetime64_any_dtype(s.dtype):
        v = s.to_numpy("datetime64[us]").astype(np.int64).astype(np.float64)
    else:
        v = s.astype("Float64").to_numpy(np.float64, na_value=np.nan)
    return v, null


def same_rows(got: Dict[str, np.ndarray], want: pd.DataFrame,
              features: List[str] = ETL_FEATURES, label: str = ETL_LABEL,
              keys: List[str] = ETL_KEYS,
              rtol: float = F32_RTOL) -> Dict[str, float]:
    """Hold the export's live rows to the collected frame ``want`` (see
    the module docstring); returns the rows and the largest relative
    float error."""
    assert len(got["keys"]) == len(want), (len(got["keys"]), len(want))
    key_cols = []
    for k in keys:
        s = want[k]
        key_cols.append(s.to_numpy("datetime64[us]").astype(np.int64)
                        if pd.api.types.is_datetime64_any_dtype(s.dtype)
                        else s.to_numpy(np.int64))
    want_order = np.lexsort(key_cols[::-1])
    got_order = np.lexsort([got["keys"][:, i]
                            for i in range(len(keys))][::-1])
    for i in range(len(keys)):
        assert (got["keys"][got_order, i]
                == key_cols[i][want_order]).all(), f"key {keys[i]}"
    worst = 0.0
    cols = [(n, got["x"][:, j], got["valid"][:, j])
            for j, n in enumerate(features)]
    cols.append((label, got["y"], got["y_valid"]))
    for name, g, gvalid in cols:
        g, gvalid = g[got_order], gvalid[got_order]
        w, null = _frame_values(want[name].iloc[want_order])
        s = want[name]
        if pd.api.types.is_float_dtype(s.dtype) and not isinstance(
                s.dtype, pd.api.extensions.ExtensionDtype):
            # a numpy float column's NaN is a NULL or a NaN value: the
            # export's slot is NULL, or valid and NaN
            assert (~gvalid[null] | np.isnan(g[null])).all(), \
                f"{name}: NaN differs"
            assert gvalid[~null].all(), f"{name}: NULLs differ"
        else:
            assert (gvalid == ~null).all(), f"{name}: NULLs differ"
        g, w = g[~null], w[~null].astype(np.float32)
        if pd.api.types.is_float_dtype(s.dtype):
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)
            nz = w != 0
            if nz.any():
                worst = max(worst, float(np.max(
                    np.abs(g[nz] - w[nz]) / np.abs(w[nz]))))
        else:
            bad = np.flatnonzero(g != w)
            assert len(bad) == 0, (name, bad[:5], g[bad[:5]], w[bad[:5]])
    return {"rows": int(len(want)), "max_rel_err": worst}
