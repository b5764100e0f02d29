"""The expression cases of the expression slice (math, bitwise, null-safe,
NaN, dates and unix time, the nondeterministic functions), shared by the
port's CPU tests, its card tests and ``chip_smoke.py``: one seeded frame
and a table of named expressions, each built from a ``functions`` module
(the port's or the JAX package's, whose APIs match), so that one case
runs through both sessions.

The frame (``frame(n)``): nullable ``i32`` and ``i64`` with 0, +-1 and
their extremes, shift amounts ``b`` (negative and past the width), small
day and month counts ``n``, bounded epoch seconds ``secs``; doubles ``f``
(NaN, +-0.0, +-inf, subnormals, 1e+-300, then values over 600 decades)
and ``g``, and a nullable ``fn``; timestamps ``ts`` and ``ts2`` before
1970, on 29 February, at month and year ends, with NULLs; date strings in
both device formats, padded, with invalid days and garbage, as a slab
(``sd``), a dictionary (``sdd``) and plain chars (``sdp``, some values
padded past the 64-byte slab limit).

``CASES`` maps a name to ``lambda M: <Column>``; ``APPROX`` names the
cases held to rtol 1e-13 (the transcendental functions, and sqrt, which
torch on the CPU does not round correctly everywhere; NaN, the
infinities and the sign of zero in the same places; a subnormal result
relative to the smallest normal double), the rest are exact.
``NUMPY_HELD`` names the double functions, the float normalization and
months_between, which the CPU tests hold to the JAX package's CPU
operators (numpy, IEEE division): its device path under XLA on the CPU
flushes subnormals to zero and may round a division by a constant
differently.
``NONDET`` names the cases that read the task context (equal only
between runs with the same partitions and batch boundaries).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

import numpy as np
import pandas as pd

I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)
RTOL = 1e-13
# an approximate value is held relative to at least the smallest normal
# double: a subnormal result's precision is absolute (CUDA's exp and pow
# round some to the next subnormal, or to zero, where numpy does not)
TINY = float(np.finfo(np.float64).tiny)

_DATES_OK = ["2000-02-29", "1969-12-31", "1970-01-01", "2024-12-31",
             "1900-03-01", "0001-01-01", "9999-12-31"]
_TIMES_OK = ["2000-02-29 23:59:59", "1969-12-31 00:00:00",
             "2024-01-31 12:34:56", "1970-01-01 00:00:01"]
_BAD = ["2001-02-29", "2001-13-01", "2001-00-10", "0000-01-01", "abc",
        "", "2000-2-29", "2000-02-29T01:02:03", "2000-02-29 24:00:00",
        "2000-02-29 23:60:00", "2000-02-29 1:02:03", "20000229",
        "2000-02-29x"]


def _exprs(M, module: str):
    """The expression module ``module`` of the package ``M`` (a
    ``functions`` module) belongs to."""
    root = M.__name__.rsplit(".sql.", 1)[0]
    return importlib.import_module(f"{root}.sql.exprs.{module}")


def _nullable(values: np.ndarray, null: np.ndarray, dtype: str):
    return pd.Series(pd.array(values, dtype=dtype)).mask(pd.Series(null))


def frame(n: int, seed: int = 20261018) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.1
    i32 = rng.integers(I32.min, I32.max, n, dtype=np.int64, endpoint=True)
    i32[:7] = [0, 1, -1, I32.min, I32.max, 2, -2]
    i64 = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    i64[:7] = [0, 1, -1, I64.min, I64.max, 2, -2]
    i64[7:n // 2] //= 10 ** rng.integers(0, 18, n // 2 - 7)
    null[:7] = False
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324,
                         -2.5e-310, 1e300, -1e-300, 1.0, -1.0, 0.5, 27.0,
                         -8.0, 2.5, -2.5, 1e-20, 710.0, -745.0, 3.0])
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    f[n // 3:] = rng.uniform(-4, 4, n - n // 3)
    f[:len(specials)] = specials
    g = rng.uniform(-3, 3, n)
    g[:len(specials)] = specials[::-1]
    fn = rng.uniform(-10, 10, n)
    fn[rng.random(n) < 0.1] = np.nan
    fnull = rng.random(n) < 0.1
    micros = rng.integers(-3 * 10**15, 4 * 10**15, n)
    micros2 = rng.integers(-3 * 10**15, 4 * 10**15, n)
    special_ts = np.array(
        ["2000-02-29T23:59:59", "1969-12-31T23:59:59.999999",
         "1970-01-01T00:00:00", "2004-02-29T00:00:00", "2001-01-31T12:00:00",
         "1999-12-31T00:00:00", "2023-03-31T08:00:00", "1900-02-28T00:00:00",
         "1600-02-29T06:00:00", "2024-11-30T23:00:00"],
        dtype="datetime64[us]").astype(np.int64)
    micros[:len(special_ts)] = special_ts
    micros2[:len(special_ts)] = special_ts[::-1]
    ts = pd.Series(micros.astype("datetime64[us]"))
    ts[rng.random(n) < 0.1] = pd.NaT
    ts2 = pd.Series(micros2.astype("datetime64[us]"))
    ts2[rng.random(n) < 0.1] = pd.NaT
    pool = _DATES_OK + _TIMES_OK + _BAD
    picks = rng.integers(0, len(pool), n)
    days = rng.integers(-200000, 2900000, n)
    made = np.datetime_as_string(days.astype("datetime64[D]"), unit="D")
    secs = rng.integers(0, 86400, n)
    timed = [f"{d} {s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}"
             for d, s in zip(made, secs)]
    strs = np.where(rng.random(n) < 0.5, np.asarray(pool, object)[picks],
                    np.where(rng.random(n) < 0.5, made.astype(object),
                             np.asarray(timed, object)))
    pad = rng.random(n)
    strs = np.where(pad < 0.1, np.char.add(" ", strs.astype(str)).astype(
        object), strs)
    strs = np.where((pad > 0.1) & (pad < 0.15),
                    np.char.add(strs.astype(str), "\t").astype(object), strs)
    sd = strs.copy()
    sd[rng.random(n) < 0.1] = None
    sdd = np.asarray(pool, object)[rng.integers(0, len(pool), n)]
    sdd[rng.random(n) < 0.1] = None
    sdp = strs.copy()
    long = rng.random(n) < 0.2
    sdp[long] = [" " * 60 + str(v) + " " * 8 for v in sdp[long]]
    sdp[rng.random(n) < 0.1] = None
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "i32": _nullable(i32.astype(np.int32), null, "Int32"),
        "i64": _nullable(i64, null, "Int64"),
        "b": rng.integers(-5, 70, n).astype(np.int32),
        "n": _nullable(rng.integers(-400, 400, n).astype(np.int32),
                       rng.random(n) < 0.1, "Int32"),
        "secs": rng.integers(-2 * 10**9, 4 * 10**9, n).astype(np.int64),
        "f": f, "g": g,
        "fn": pd.Series(pd.arrays.FloatingArray(fn, fnull)),
        "ts": ts, "ts2": ts2,
        "sd": pd.Series(sd, dtype=object),
        "sdd": pd.Series(sdd, dtype=object),
        "sdp": pd.Series(sdp, dtype=object),
    })


def _math() -> Dict[str, Callable]:
    out = {}
    for fn in ("sqrt", "exp", "expm1", "log", "log2", "log10", "log1p",
               "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
               "tanh", "cbrt", "rint", "signum", "degrees", "radians"):
        out[f"{fn}_f"] = (lambda name: lambda M: getattr(M, name)(
            M.col("f")))(fn)
    for fn in ("exp", "log", "sin", "cbrt", "signum", "sqrt"):
        out[f"{fn}_fn"] = (lambda name: lambda M: getattr(M, name)(
            M.col("fn")))(fn)
        out[f"{fn}_i64"] = (lambda name: lambda M: getattr(M, name)(
            M.col("i64")))(fn)
    out.update({
        "pow_fg": lambda M: M.pow(M.col("f"), M.col("g")),
        "pow_lit": lambda M: M.pow(M.col("g"), 3.0),
        "pow_fn": lambda M: M.pow(M.col("fn"), M.col("f")),
        "atan2_fg": lambda M: M.atan2(M.col("f"), M.col("g")),
        "atan2_gi": lambda M: M.atan2(M.col("g"), M.col("i32")),
        "hypot_fg": lambda M: M.hypot(M.col("f"), M.col("g")),
        "hypot_fn": lambda M: M.hypot(M.col("fn"), M.col("g")),
    })
    return out


CASES: Dict[str, Callable] = {
    # arithmetic
    "abs_i64": lambda M: M.abs(M.col("i64")),
    "abs_i32": lambda M: M.abs(M.col("i32")),
    "abs_f": lambda M: M.abs(M.col("f")),
    "neg_i64": lambda M: -M.col("i64"),
    "neg_i32": lambda M: -M.col("i32"),
    "neg_fn": lambda M: -M.col("fn"),
    "div_i64": lambda M: M.expr_col(_exprs(M, "arithmetic").IntegralDivide(
        M.col("i64").expr, M.col("i32").expr)),
    "div_lit": lambda M: M.expr_col(_exprs(M, "arithmetic").IntegralDivide(
        M.col("i64").expr, M.lit(-7).expr)),
    # bitwise
    "and_i64": lambda M: M.col("i64").bitwiseAND(M.col("i32")),
    "or_i64": lambda M: M.col("i64").bitwiseOR(M.col("i32")),
    "xor_i32": lambda M: M.col("i32").bitwiseXOR(M.col("b")),
    "xor_lit": lambda M: M.col("i64").bitwiseXOR(-1),
    "not_i64": lambda M: M.bitwise_not(M.col("i64")),
    "not_i32": lambda M: M.bitwiseNOT(M.col("i32")),
    "shl_i64": lambda M: M.shiftleft(M.col("i64"), M.col("b")),
    "shl_i32": lambda M: M.shiftleft(M.col("i32"), M.col("b")),
    "shr_i64": lambda M: M.shiftright(M.col("i64"), M.col("b")),
    "shr_i32": lambda M: M.shiftright(M.col("i32"), M.col("b")),
    "shru_i64": lambda M: M.shiftrightunsigned(M.col("i64"), M.col("b")),
    "shru_i32": lambda M: M.shiftrightunsigned(M.col("i32"), M.col("b")),
    "shru_lit": lambda M: M.shiftrightunsigned(M.col("i64"), 1),
    # null-safe, null and NaN
    "eqns_int": lambda M: M.col("i64").eqNullSafe(M.col("i32")),
    "eqns_lit": lambda M: M.col("i32").eqNullSafe(M.lit(1)),
    "eqns_null": lambda M: M.col("n").eqNullSafe(M.col("i32")),
    "eqns_str": lambda M: M.col("sd").eqNullSafe(M.col("sdd")),
    "eqns_strlit": lambda M: M.col("sdd").eqNullSafe(M.lit("abc")),
    "isnan_f": lambda M: M.isnan(M.col("f")),
    "isnan_fn": lambda M: M.isnan(M.col("fn")),
    "isnull_fn": lambda M: M.isnull(M.col("fn")),
    "isnull_sd": lambda M: M.isnull(M.col("sd")),
    "nanvl_fg": lambda M: M.nanvl(M.col("f"), M.col("g")),
    "nanvl_fn": lambda M: M.nanvl(M.col("fn"), M.col("fn") + 1.0),
    "nvl_int": lambda M: M.nvl(M.col("n"), M.col("i32")),
    "ifnull_str": lambda M: M.ifnull(M.col("sd"), M.col("sdd")),
    "nvl2_int": lambda M: M.nvl2(M.col("n"), M.col("i32"), M.lit(-1)),
    "atleast2": lambda M: M.expr_col(_exprs(M, "nullexprs").AtLeastNNonNulls(
        2, [M.col("fn").expr, M.col("n").expr, M.col("i64").expr])),
    "normalize_f": lambda M: M.expr_col(
        _exprs(M, "nullexprs").NormalizeNaNAndZero(M.col("f").expr)),
    # dates and unix time
    "date_add": lambda M: M.date_add(M.to_date(M.col("ts")), M.col("n")),
    "date_add_lit": lambda M: M.date_add(M.to_date(M.col("ts")), 365),
    "date_sub": lambda M: M.date_sub(M.to_date(M.col("ts")), M.col("n")),
    "datediff_ts": lambda M: M.datediff(M.col("ts"), M.col("ts2")),
    "datediff_date": lambda M: M.datediff(M.to_date(M.col("ts")),
                                          M.to_date(M.col("ts2"))),
    "last_day_ts": lambda M: M.last_day(M.col("ts")),
    "last_day_date": lambda M: M.last_day(M.to_date(M.col("ts"))),
    "add_months": lambda M: M.add_months(M.to_date(M.col("ts")), M.col("n")),
    "add_months_ts": lambda M: M.add_months(M.col("ts"), 13),
    "months_between": lambda M: M.months_between(M.col("ts"), M.col("ts2")),
    "months_between_date": lambda M: M.months_between(
        M.to_date(M.col("ts")), M.to_date(M.col("ts2"))),
    "trunc_year": lambda M: M.trunc(M.col("ts"), "year"),
    "trunc_mm": lambda M: M.trunc(M.col("ts"), "mm"),
    "trunc_quarter": lambda M: M.trunc(M.to_date(M.col("ts")), "quarter"),
    "trunc_week": lambda M: M.trunc(M.col("ts"), "week"),
    "next_day_mon": lambda M: M.next_day(M.col("ts"), "mon"),
    "next_day_sunday": lambda M: M.next_day(M.to_date(M.col("ts")),
                                            "Sunday"),
    "unix_ts": lambda M: M.unix_timestamp(M.col("ts")),
    "unix_date": lambda M: M.unix_timestamp(M.to_date(M.col("ts")),
                                            "yyyy-MM-dd"),
    "from_unixtime": lambda M: M.from_unixtime(M.col("secs")),
    # nondeterministic
    "rand0": lambda M: M.rand(),
    "rand42": lambda M: M.rand(42),
    "mono_id": lambda M: M.monotonically_increasing_id(),
    "part_id": lambda M: M.spark_partition_id(),
    "input_file": lambda M: M.input_file_name(),
}
for _col in ("sd", "sdd", "sdp"):
    CASES[f"unix_{_col}"] = (lambda c: lambda M: M.unix_timestamp(
        M.col(c), "yyyy-MM-dd"))(_col)
    CASES[f"unix_time_{_col}"] = (lambda c: lambda M: M.unix_timestamp(
        M.col(c), "yyyy-MM-dd HH:mm:ss"))(_col)
CASES.update(_math())

APPROX = {name for name in CASES
          if name.split("_")[0] in ("sqrt", "exp", "expm1", "log", "log2",
                                    "log10",
                                    "log1p", "sin", "cos", "tan", "asin",
                                    "acos", "atan", "sinh", "cosh", "tanh",
                                    "cbrt", "pow", "atan2", "hypot")}
NUMPY_HELD = set(_math()) | {"normalize_f", "months_between",
                             "months_between_date"}
NONDET = {"rand0", "rand42", "mono_id", "part_id", "input_file"}


def projection(M, session, df: pd.DataFrame, names=None,
               num_partitions: int = 1):
    """``df`` as a DataFrame of ``session`` with ``id`` and one column per
    case of ``names`` (default: all)."""
    names = list(CASES) if names is None else names
    return session.create_dataframe(df, num_partitions).select(
        M.col("id"), *[CASES[n](M).alias(n) for n in names])


def same_values(got: pd.Series, want: pd.Series, approx: bool) -> str:
    """'' where ``got`` equals ``want`` (NULLs in the same rows; exact,
    or within RTOL with NaN, the infinities and the sign of zero in the
    same places where ``approx``), else what differs."""
    gn, wn = got.isna().to_numpy(), want.isna().to_numpy()
    if not np.array_equal(gn, wn):
        return f"NULLs differ in {int((gn != wn).sum())} rows"
    g, w = got[~gn].to_numpy(), want[~wn].to_numpy()
    if g.dtype.kind == "f" or w.dtype.kind == "f":
        g, w = g.astype(np.float64), w.astype(np.float64)
        same_nan = np.isnan(g) == np.isnan(w)
        fin = np.isfinite(g) & np.isfinite(w)
        with np.errstate(invalid="ignore"):
            close = (np.abs(g - w) <= RTOL * np.maximum(np.abs(w), TINY)
                     if approx else g == w)
        ok = same_nan & (np.isnan(g) | (fin & close) | (~fin & (g == w)))
        ok &= np.isnan(g) | (np.signbit(g) == np.signbit(w)) | (g != 0)
        if not ok.all():
            i = int(np.argmin(ok))
            return (f"{int((~ok).sum())} values differ, first {g[i]!r} "
                    f"against {w[i]!r}")
        return ""
    if g.dtype.kind == "M" or w.dtype.kind == "M":
        g, w = g.astype("datetime64[us]"), w.astype("datetime64[us]")
    if not np.array_equal(np.asarray(g, dtype=object),
                          np.asarray(w, dtype=object)):
        bad = int(sum(1 for x, y in zip(g, w) if x != y))
        return f"{bad} values differ"
    return ""
