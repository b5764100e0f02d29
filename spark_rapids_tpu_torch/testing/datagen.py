"""Composable random data generators for differential testing.

The reference's integration harness builds random DataFrames from typed
generator objects with weighted NULL / NaN / extreme special cases
(integration_tests/.../data_gen.py:26-477: ByteGen..TimestampGen, StringGen
via regex, RepeatSeqGen, StructGen, gen_df) and its Scala fuzzer does the
same batch-side (tests/.../FuzzerUtils.scala:316). This is the same design
over numpy: every generator owns a dtype, a nullability weight, and a
special-value distribution, and ``gen_df`` assembles a pandas frame that
``session.create_dataframe`` turns into partitioned columnar batches.

A copy of the JAX package's ``testing/datagen.py`` (numpy and pandas
only), so that the port's tests draw the same frames from the same seeds
without importing that package.
"""

from __future__ import annotations

import datetime
import string as _string
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd


class DataGen:
    """Base: a typed column generator with null weighting."""

    pandas_dtype: Optional[str] = None

    def __init__(self, nullable: bool = True, null_prob: float = 0.08,
                 special_cases: Sequence = (), special_prob: float = 0.05):
        self.nullable = nullable
        self.null_prob = null_prob if nullable else 0.0
        self.special_cases = list(special_cases)
        self.special_prob = special_prob if self.special_cases else 0.0

    # subclasses produce the bulk values
    def _values(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError

    def generate(self, rng: np.random.Generator, n: int) -> pd.Series:
        vals = self._values(rng, n)
        out = pd.Series(vals)
        if self.special_cases:
            take = rng.random(n) < self.special_prob
            picks = rng.integers(0, len(self.special_cases), n)
            for i in np.nonzero(take)[0]:
                out.iloc[int(i)] = self.special_cases[picks[i]]
        if self.pandas_dtype:
            out = out.astype(self.pandas_dtype)
        if self.null_prob > 0:
            mask = rng.random(n) < self.null_prob
            out = out.mask(pd.Series(mask))
        return out


class ByteGen(DataGen):
    pandas_dtype = "Int8"

    def _values(self, rng, n):
        return rng.integers(-128, 128, n, dtype=np.int64)

    def __init__(self, **kw):
        kw.setdefault("special_cases", [-128, 127, 0])
        super().__init__(**kw)


class ShortGen(DataGen):
    pandas_dtype = "Int16"

    def _values(self, rng, n):
        return rng.integers(-(1 << 15), 1 << 15, n, dtype=np.int64)

    def __init__(self, **kw):
        kw.setdefault("special_cases", [-(1 << 15), (1 << 15) - 1, 0])
        super().__init__(**kw)


class IntegerGen(DataGen):
    pandas_dtype = "Int32"

    def _values(self, rng, n):
        return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)

    def __init__(self, **kw):
        kw.setdefault("special_cases", [-(1 << 31), (1 << 31) - 1, 0, 1, -1])
        super().__init__(**kw)


class LongGen(DataGen):
    pandas_dtype = "Int64"

    def _values(self, rng, n):
        return rng.integers(-(1 << 63), 1 << 63, n, dtype=np.int64)

    def __init__(self, **kw):
        kw.setdefault("special_cases",
                      [-(1 << 63), (1 << 63) - 1, 0, 1, -1])
        super().__init__(**kw)


class FloatGen(DataGen):
    pandas_dtype = "Float32"

    def __init__(self, no_nans: bool = False, **kw):
        specials = [0.0, -0.0, 1.0, -1.0,
                    float(np.finfo(np.float32).max),
                    float(np.finfo(np.float32).min)]
        if not no_nans:
            specials += [float("nan"), float("inf"), float("-inf")]
        kw.setdefault("special_cases", specials)
        super().__init__(**kw)

    def _values(self, rng, n):
        return (rng.normal(0, 1e6, n)).astype(np.float32)


class DoubleGen(DataGen):
    pandas_dtype = "Float64"

    def __init__(self, no_nans: bool = False, **kw):
        specials = [0.0, -0.0, 1.0, -1.0, 1e300, -1e300, 5e-324]
        if not no_nans:
            specials += [float("nan"), float("inf"), float("-inf")]
        kw.setdefault("special_cases", specials)
        super().__init__(**kw)

    def _values(self, rng, n):
        return rng.normal(0, 1e12, n)


class BooleanGen(DataGen):
    pandas_dtype = "boolean"

    def _values(self, rng, n):
        return rng.integers(0, 2, n).astype(bool)


class StringGen(DataGen):
    """Random ASCII strings; ``charset``/length bounds instead of the
    reference's sre_yield regex enumeration (zero-dependency)."""

    def __init__(self, charset: str = _string.ascii_letters + _string.digits
                 + " _-", min_len: int = 0, max_len: int = 12, **kw):
        self.charset = np.asarray(list(charset), dtype=object)
        self.min_len = min_len
        self.max_len = max_len
        kw.setdefault("special_cases", ["", " ", "NULL", "\t", "0", "a" * 30])
        super().__init__(**kw)

    def _values(self, rng, n):
        lens = rng.integers(self.min_len, self.max_len + 1, n)
        out = np.empty(n, dtype=object)
        for i in range(n):
            idx = rng.integers(0, len(self.charset), lens[i])
            out[i] = "".join(self.charset[idx])
        return out


class DateGen(DataGen):
    def __init__(self, start: datetime.date = datetime.date(1990, 1, 1),
                 end: datetime.date = datetime.date(2030, 12, 31), **kw):
        self.lo = np.datetime64(start, "D").astype(int)
        self.hi = np.datetime64(end, "D").astype(int)
        super().__init__(**kw)

    def _values(self, rng, n):
        days = rng.integers(self.lo, self.hi + 1, n)
        return days.astype("datetime64[D]").astype("datetime64[s]")

    def generate(self, rng, n):
        out = pd.Series(self._values(rng, n))
        if self.null_prob > 0:
            out = out.mask(pd.Series(rng.random(n) < self.null_prob))
        return out


class TimestampGen(DataGen):
    def __init__(self, **kw):
        super().__init__(**kw)

    def _values(self, rng, n):
        us = rng.integers(631152000_000_000, 1893456000_000_000, n)  # 1990..2030
        return us.astype("datetime64[us]")

    def generate(self, rng, n):
        out = pd.Series(self._values(rng, n))
        if self.null_prob > 0:
            out = out.mask(pd.Series(rng.random(n) < self.null_prob))
        return out


class SkewedKeyGen(DataGen):
    """Integer join/group key with a hot-key mass: fraction ``hot_prob``
    of rows carry ``hot_key``, the rest spread uniformly over
    ``[1, num_keys]`` — the shape that lands one reduce partition far
    over the skew factor (the AQE skew-join test distribution;
    sql/adaptive/rules.py splits it by map ranges)."""

    pandas_dtype = "Int64"

    def __init__(self, hot_key: int = 0, hot_prob: float = 0.75,
                 num_keys: int = 1000, **kw):
        assert 0.0 <= hot_prob <= 1.0, hot_prob
        self.hot_key = hot_key
        self.hot_prob = hot_prob
        self.num_keys = max(1, int(num_keys))
        kw.setdefault("nullable", False)
        super().__init__(**kw)

    def _values(self, rng, n):
        hot = rng.random(n) < self.hot_prob
        cold = rng.integers(1, self.num_keys + 1, n, dtype=np.int64)
        return np.where(hot, np.int64(self.hot_key), cold)


def gen_skewed_join_frames(rng: np.random.Generator, n_fact: int = 20000,
                           n_dim: int = 200, hot_prob: float = 0.75,
                           ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """(fact, dim) pair for skew-join tests: ``fact.k`` is hot-key
    skewed, ``dim.k`` covers every key once."""
    # no extreme specials on the value column: ±1e300 makes per-key sums
    # ill-conditioned under the re-grouped summation order skew splits
    # introduce, and the differential harness compares sums
    fact = gen_df(rng, [
        ("k", SkewedKeyGen(hot_key=0, hot_prob=hot_prob,
                           num_keys=n_dim - 1)),
        ("v", DoubleGen(nullable=False, no_nans=True,
                        special_cases=())),
    ], n=n_fact)
    dim = pd.DataFrame({
        "k": np.arange(n_dim, dtype=np.int64),
        "w": rng.normal(size=n_dim),
    })
    return fact, dim


class RepeatSeqGen(DataGen):
    """Cycles a small value set — the reference's low-cardinality group-key
    generator (data_gen.py RepeatSeqGen)."""

    def __init__(self, values: Sequence, pandas_dtype: Optional[str] = None,
                 **kw):
        self.values = list(values)
        self.pandas_dtype = pandas_dtype
        kw.setdefault("nullable", any(v is None for v in values))
        super().__init__(**kw)
        self.null_prob = 0.0  # nulls come from the value list itself

    def _values(self, rng, n):
        reps = -(-n // len(self.values))
        return np.asarray((self.values * reps)[:n], dtype=object)


class StructGen:
    """[(name, gen)] bundle for gen_df."""

    def __init__(self, fields: List[Tuple[str, DataGen]]):
        self.fields = fields


def gen_df(rng: np.random.Generator, gens, n: int = 256) -> pd.DataFrame:
    """Build a pandas frame from [(name, gen)] / StructGen."""
    fields = gens.fields if isinstance(gens, StructGen) else list(gens)
    return pd.DataFrame({name: g.generate(rng, n) for name, g in fields})
