"""Host (pandas) evaluation helpers (counterpart of the JAX package's
``sql/exprs/hostutil.py``).

The CPU path unpacks pandas Series (numpy-backed or nullable-extension)
into plain (values, validity) numpy pairs, applies the same formula the
device path uses, and rebuilds a Series, so null semantics match the
device path's (data, validity) discipline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import (
    _numpy_to_pandas, _pandas_col_dtype, _pandas_to_numpy,
)
from spark_rapids_tpu_torch.columnar.dtype import DType


def host_unary_values(s: pd.Series
                      ) -> Tuple[np.ndarray, np.ndarray, pd.Index]:
    dt = _pandas_col_dtype(s)
    values, validity = _pandas_to_numpy(s, dt)
    return values, validity, s.index


def host_binary_values(a: pd.Series, b: pd.Series):
    av, amask, index = host_unary_values(a)
    bv, bmask, _ = host_unary_values(b)
    return (av, bv), amask & bmask, index


def rebuild_series(data: np.ndarray, validity: np.ndarray, dt: DType,
                   index: pd.Index) -> pd.Series:
    data = np.asarray(data)
    if not dt.is_string and data.dtype != dt.np_dtype:
        data = data.astype(dt.np_dtype)
    # canonicalize nulls so padding never leaks values
    if not validity.all():
        if dt.is_string:
            data = data.copy()
            data[~validity] = None
        else:
            data = np.where(validity, data,
                            np.asarray(dtypes.null_fill_value(dt),
                                       dtype=data.dtype))
    s = _numpy_to_pandas(data, validity, dt)
    s.index = index
    return s
