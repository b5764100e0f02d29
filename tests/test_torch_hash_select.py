"""``hash()``, the string-valued ``if``/CASE WHEN/``coalesce``
(``ops/strings.select_strings``) and the USING joins through the port's
``TpuSparkSession`` on the CPU, against the JAX package's session on the
same seeded frame.

``hash()`` must give the JAX package's int32 bit for bit: every
fixed-width type (bool, int8/16/32/64, float32/64 with -0.0 and NaN, date,
timestamp), NULLs, several columns at once, and strings both as a
dictionary (its values hashed once on the host, gathered by code) and as
a char slab (its words hashed on the device). The string selections run
over two different dictionaries (merged into their union), a slab
against a dictionary, slabs of different strides (8 and 64 bytes),
literals and NULLs. Each runs in test mode through the port's device
operators and through its CPU operators; all exact.

The USING joins (``on=[...]``): inner, left, right and full, over an
integer key and a string key with NULLs; the full join coalesces the two
sides' keys, now on the device.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.ops import hashing, strings
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.exprs.core import DevCol
from spark_rapids_tpu_torch.sql.exprs.evalbridge import make_context
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 300


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(23)

    def nulls(values, rate):
        out = np.asarray(values, dtype=object)
        out[rng.random(N) < rate] = None
        return out
    f64 = rng.normal(0, 3, N).round(2)
    f64[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324]
    return pd.DataFrame({
        "id": np.arange(N),
        "t": rng.random(N) < 0.5,
        "i8": rng.integers(-100, 100, N).astype(np.int8),
        "i16": rng.integers(-3000, 3000, N).astype(np.int16),
        "i32": rng.integers(-10**9, 10**9, N).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, N),
        "f32": f64.astype(np.float32),
        "f64": f64,
        "n": pd.Series(rng.integers(-5, 5, N)).astype("Int64").mask(
            pd.Series(rng.random(N) < 0.2)),
        "ts": pd.Series(rng.integers(-10**15, 10**15, N)
                        .astype("datetime64[us]")).mask(
            pd.Series(rng.random(N) < 0.1)),
        "x": rng.integers(-3, 5, N),
        # dictionaries of different value sets, with NULLs
        "d1": nulls(np.asarray(["a", "b", "cc", ""])[
            rng.integers(0, 4, N)], 0.15),
        "d2": nulls(np.asarray(["x", "yy", "b"])[rng.integers(0, 3, N)],
                    0.15),
        # slabs: 8- and 64-byte strides, too many values for a dictionary
        "s1": nulls([f"s{i:05d}" for i in rng.integers(0, 10**5, N)], 0.1),
        "s2": nulls([f"long-value-{i}-" + "z" * (i % 40)
                     for i in rng.integers(0, 10**5, N)], 0.1),
    })


FRAME = _frame()


def test_columns_take_the_forms_under_test():
    b = DeviceBatch.from_pandas(FRAME[["d1", "d2", "s1", "s2"]],
                                slab_stride=1 << 10, device="cpu")
    assert [c.has_slab for c in b.columns] == [False, False, True, True]
    assert b.columns[0].dict_values != b.columns[1].dict_values
    assert [c.char_stride for c in b.columns[2:]] == [8, 64]


HASH_CASES = {c: (lambda c: lambda M: M.hash(c))(c)
              for c in ["t", "i8", "i16", "i32", "i64", "f32", "f64", "n",
                        "ts", "d1", "s1", "s2"]}
HASH_CASES.update({
    "date": lambda M: M.hash(M.to_date(M.col("ts"))),
    "multi": lambda M: M.hash("i64", "d1", "f64", "n", "s2"),
    "multi_nullable": lambda M: M.hash("n", "ts", "s1"),
})

SELECT_CASES = {
    "if_two_dicts": lambda M, C: C.If((M.col("x") > 0).expr,
                                      M.col("d1").expr, M.col("d2").expr),
    "if_slab_dict": lambda M, C: C.If((M.col("x") > 0).expr,
                                      M.col("s1").expr, M.col("d1").expr),
    "if_two_strides": lambda M, C: C.If((M.col("x") > 1).expr,
                                        M.col("s2").expr, M.col("s1").expr),
    "case_dict_slab_lit": lambda M, C: M.when(M.col("x") > 2, M.col("d1"))
    .when(M.col("x") > 0, M.col("s2")).otherwise(M.lit("none")).expr,
    "case_no_else": lambda M, C: M.when(M.col("x") > 2, M.col("s1")).expr,
    "case_null_pred": lambda M, C: M.when(M.col("n") > 0, M.col("d2"))
    .otherwise(M.col("d1")).expr,
    "coalesce_two_dicts": lambda M, C: M.coalesce("d1", "d2").expr,
    "coalesce_slab_dict_lit": lambda M, C: M.coalesce(
        "s1", "d1", M.lit("z")).expr,
    "coalesce_two_strides": lambda M, C: M.coalesce("s2", "s1").expr,
}


def _conditional(M):
    if M is F:
        from spark_rapids_tpu_torch.sql.exprs import conditional
    else:
        from spark_rapids_tpu.sql.exprs import conditional
    return conditional


def _query(M, s):
    from importlib import import_module
    col_cls = import_module(M.__name__).Column
    cols = [M.col("id")]
    cols += [fn(M).alias("h_" + n) for n, fn in HASH_CASES.items()]
    cols += [col_cls(fn(M, _conditional(M))).alias(n)
             for n, fn in SELECT_CASES.items()]
    return s.create_dataframe(FRAME, 2).select(*cols)


@pytest.fixture(scope="module")
def results():
    out = {"jax": with_tpu_session(lambda rs: _query(RF, rs))}
    for key, conf in (("device", {"spark.rapids.sql.test.enabled": True}),
                      ("cpu", {"spark.rapids.sql.enabled": False})):
        b = TpuSparkSession.builder().device("cpu")
        for k, v in conf.items():
            b.config(k, v)
        out[key] = _query(F, b.get_or_create()).collect()
    return {k: v.sort_values("id").reset_index(drop=True)
            for k, v in out.items()}


@pytest.mark.parametrize("name", list(HASH_CASES))
def test_hash_matches_reference_bit_for_bit(name, results):
    want = results["jax"]["h_" + name].to_numpy()
    assert want.dtype == np.int32 and len(set(want)) > 1
    for key in ("device", "cpu"):
        got = results[key]["h_" + name]
        assert got.dtype == np.int32
        assert (got.to_numpy() == want).all(), key


def _values(s: pd.Series) -> list:
    return [None if pd.isna(v) else str(v) for v in s]


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_string_select_matches_reference(name, results):
    want = _values(results["jax"][name])
    assert sum(v is None for v in want) < N
    for key in ("device", "cpu"):
        assert _values(results[key][name]) == want, key


def test_select_strings_forms():
    """Two dictionaries give a dictionary over their union; a slab and a
    dictionary, or two strides, give a slab of the wider stride."""
    b = DeviceBatch.from_pandas(FRAME[["d1", "d2", "s1", "s2"]],
                                slab_stride=1 << 10, device="cpu")
    ctx = make_context(b)
    d1, d2, s1, s2 = ctx.cols
    cond = torch.arange(b.capacity) % 2 == 0
    out = strings.select_strings(cond, d1, d2, cond)
    assert out.dict_values == tuple(sorted(set(d1.dict_values)
                                           | set(d2.dict_values)))
    for a, c, stride in ((s1, d1, 8), (d2, s1, 8), (s1, s2, 64)):
        out = strings.select_strings(cond, a, c, cond)
        assert out.slab64 is not None and out.dict_values is None
        assert out.slab64.shape[1] * 8 == stride


def test_hash_string_col_dictionary_equals_slab():
    """A value hashes alike as a dictionary code and as slab words."""
    from spark_rapids_tpu_torch.ops.rowops import dict_to_slab
    b = DeviceBatch.from_pandas(FRAME[["d1"]], device="cpu")
    col = b.columns[0]
    slab = dict_to_slab(col, 16)
    got_d = hashing.hash_string_col(col)
    got_s = hashing.hash_string_col(DevCol(col.dtype, None, slab.validity,
                                           slab64=slab.slab64,
                                           lens=slab.lens))
    assert torch.equal(got_d, got_s)
    vals = FRAME["d1"].to_numpy(object)
    want = hashing.np_string_hashes(list(vals), pd.notna(vals)).view(
        np.int64)
    assert (got_d[:N].numpy() == want).all()


def _using_sides():
    rng = np.random.default_rng(5)

    def side(p, n):
        return pd.DataFrame({
            "k": pd.Series(rng.integers(0, 8, n)).astype("Int64").mask(
                pd.Series(rng.random(n) < 0.15)),
            "sk": np.asarray(["a", "bb", "c", None], dtype=object)[
                rng.integers(0, 4, n)],
            f"{p}v": rng.integers(-9, 9, n),
        })
    return side("l", 30), side("r", 25)


def _rows(df):
    return sorted(tuple("NULL" if pd.isna(x) else str(x) for x in row)
                  for row in df.astype(object).itertuples(index=False))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("key", ["k", "sk"])
def test_using_join_matches_reference(session, how, key):
    l_df, r_df = _using_sides()
    other = "sk" if key == "k" else "k"
    l_df = l_df.drop(columns=[other])
    r_df = r_df.drop(columns=[other])
    want = with_tpu_session(lambda rs: rs.create_dataframe(l_df).join(
        rs.create_dataframe(r_df), on=key, how=how))
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        b = TpuSparkSession.builder().device("cpu")
        for k, v in conf.items():
            b.config(k, v)
        s = b.get_or_create()
        got = s.create_dataframe(l_df).join(s.create_dataframe(r_df),
                                            on=key, how=how).collect()
        assert list(got.columns) == list(want.columns)
        assert _rows(got) == _rows(want)
    assert len(want) > 0
