"""Synthetic TPC-H-like lineitem generator (copy of the JAX package's
``models/tpch_data.gen_lineitem``, so both packages see the same rows for
the same scale factor and seed).

Distributions follow the TPC-H spec shapes (uniform quantities 1..50,
discounts 0..0.10, 7-year date range, A/N/R return flags), not dbgen's exact
streams.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

LINEITEM_ROWS_PER_SF = 6_000_000
ORDERS_ROWS_PER_SF = 1_500_000
PART_ROWS_PER_SF = 200_000
SUPPLIER_ROWS_PER_SF = 10_000

_EPOCH_1992 = np.datetime64("1992-01-01", "D").astype(int)
_DATE_RANGE_DAYS = 2526  # 1992-01-01 .. 1998-12-01


def gen_lineitem(sf: float, seed: int = 7) -> pd.DataFrame:
    n = max(1, int(LINEITEM_ROWS_PER_SF * sf))
    rng = np.random.default_rng(seed)
    orderkey = rng.integers(1, max(2, int(ORDERS_ROWS_PER_SF * sf)) * 4, n)
    ship_days = _EPOCH_1992 + rng.integers(0, _DATE_RANGE_DAYS, n)
    returnflag = np.array(["A", "N", "R"], dtype=object)[
        rng.integers(0, 3, n)]
    linestatus = np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)]
    commit_days = ship_days + rng.integers(-30, 60, n)
    receipt_days = ship_days + rng.integers(1, 30, n)
    shipmode = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                         "FOB"], dtype=object)[rng.integers(0, 7, n)]
    shipinstruct = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE",
                             "TAKE BACK RETURN"], dtype=object)[
        rng.integers(0, 4, n)]
    return pd.DataFrame({
        "l_orderkey": orderkey.astype(np.int64),
        "l_partkey": rng.integers(1, max(2, int(PART_ROWS_PER_SF * sf)), n),
        "l_suppkey": rng.integers(1, max(2, int(SUPPLIER_ROWS_PER_SF * sf)), n),
        "l_linenumber": rng.integers(1, 8, n).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105000.0, n), 2),
        "l_discount": np.round(rng.integers(0, 11, n) * 0.01, 2),
        "l_tax": np.round(rng.integers(0, 9, n) * 0.01, 2),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": ship_days.astype("datetime64[D]").astype("datetime64[s]"),
        "l_commitdate": commit_days.astype("datetime64[D]").astype("datetime64[s]"),
        "l_receiptdate": receipt_days.astype("datetime64[D]").astype("datetime64[s]"),
        "l_shipmode": shipmode,
        "l_shipinstruct": shipinstruct,
    })
