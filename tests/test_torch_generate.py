"""explode/posexplode of split through the port's ``TpuSparkSession`` on
the CPU, against the JAX package's session on the same seeded frame.

The source column takes each string form: a dictionary (few distinct
lists), a char slab (many, up to 64 bytes) and plain offsets+chars (some
past 64 bytes). Its rows hold NULLs (no row), empty strings (one empty
token), leading, trailing and doubled delimiters (empty tokens) and
multi-byte UTF-8. Every child column is copied per token, the source and
a plain payload included. Each query runs in test mode through the
port's device operators (``exec/generate.TpuGenerateExec``, one counted
``generate.totals`` sync a batch) and through its CPU operators.

Also: a computed source (projected first), a group-by count over the
tokens, the JAX package's fallback reasons for a regex metacharacter and
a multi-byte delimiter (then on the CPU, with its answers), the two
shadowing errors, and that a batch whose copied chars would pass what
int32 offsets address raises instead of wrapping.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.ops import generate as gen_ops
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import assert_frames_equal, with_tpu_session
from tests.test_torch_exprs_tail import assert_same_reasons, port_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 300
WORDS = ["a", "bb", "ccc", "dé", "e", "", "ff", "ggg", "h" * 9]


def _lists(rng, n, k_max, sep, pool):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, k_max + 1))
        out.append(sep.join(rng.choice(pool, k)) if k else "")
    return out


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(15)
    few = ["a,b", "c", "", ",x,", "dé,,e", "q,r,s,t"]
    dict_col = np.asarray(few, dtype=object)[rng.integers(0, len(few), N)]
    slab = np.asarray(_lists(rng, N, 6, ",", WORDS), dtype=object)
    plain = np.asarray(_lists(rng, N, 14, ",", WORDS + ["w" * 30]),
                       dtype=object)
    plain[:3] = ["z" * 70 + ",y", ",,", "é" * 40]
    for col in (dict_col, slab, plain):
        col[rng.random(N) < 0.1] = None
    return pd.DataFrame({
        "id": np.arange(N, dtype=np.int64),
        "dct": dict_col, "slb": slab, "pln": plain,
        "v": pd.Series(rng.integers(-9, 9, N)).astype("Int64").mask(
            pd.Series(rng.random(N) < 0.1)),
    })


FRAME = _frame()


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    keys = ["id", "pos"] if "pos" in df.columns else ["id", "w"]
    return df.sort_values(keys, kind="stable").reset_index(drop=True)


def _explode(M, s, src: str, with_pos: bool, delim: str = ","):
    fn = M.posexplode if with_pos else M.explode
    return s.create_dataframe(FRAME, 2).with_column(
        "w", fn(M.split(M.col(src), delim)))


def test_source_forms():
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    b = DeviceBatch.from_pandas(FRAME[["dct", "slb", "pln"]], {},
                                device="cpu", slab_stride=64)
    dct, slb, pln = b.columns
    assert dct.dict_values is not None and slb.has_slab and pln.is_plain


@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("src", ["dct", "slb", "pln"])
def test_explode_matches_reference_session(src, with_pos):
    want = _sorted(with_tpu_session(
        lambda s: _explode(RF, s, src, with_pos)))
    assert len(want) > N
    before = SYNCS.syncs.get("generate.totals", 0)
    dev = _explode(F, port_session(**{"spark.rapids.sql.test.enabled":
                                      True}), src, with_pos).collect()
    assert SYNCS.syncs.get("generate.totals", 0) - before == 2  # 2 batches
    cpu = _explode(F, port_session(**{"spark.rapids.sql.enabled": False}),
                   src, with_pos).collect()
    for got in (dev, cpu):
        assert_frames_equal(_sorted(got), want)


@pytest.mark.parametrize("src", ["dct", "pln"])
def test_computed_source(src):
    def q(M, s):
        return s.create_dataframe(FRAME, 2).with_column(
            "w", M.explode(M.split(M.upper(M.col(src)), ",")))
    want = _sorted(with_tpu_session(lambda s: q(RF, s)))
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        assert_frames_equal(_sorted(q(F, port_session(**conf)).collect()),
                            want)


@pytest.mark.parametrize("src", ["dct", "slb", "pln"])
def test_token_counts(src):
    def q(M, s):
        return (s.create_dataframe(FRAME, 2)
                .with_column("w", M.explode(M.split(M.col(src), ",")))
                .group_by("w").agg(M.count("*").alias("n"),
                                   M.sum("v").alias("sv")))
    want = with_tpu_session(lambda s: q(RF, s))
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        got = q(F, port_session(**conf)).collect()
        assert_frames_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("delim", ["|", ".", ",,", "é"])
def test_delimiters_the_device_refuses(delim, session):
    """A regex metacharacter or a delimiter that is not one byte stays on
    the CPU with the JAX package's reason, and gives its answers there."""
    def q(M, s):
        df = pd.DataFrame({"id": np.arange(4), "t": [
            "a|b.c", "x,,y,,z", "aébé", None]})
        return s.create_dataframe(df).with_column(
            "w", M.posexplode(M.split(M.col("t"), delim)))
    session.set_conf("spark.rapids.sql.enabled", True)
    want = q(RF, session)
    got = q(F, port_session())
    assert_same_reasons(got.explain(), want.explain())
    assert_frames_equal(_sorted(got.collect()), _sorted(want.collect()))


def test_shadowing_errors():
    df = port_session().create_dataframe(pd.DataFrame({"t": ["a"],
                                                       "pos": [1]}))
    with pytest.raises(ValueError, match="would shadow"):
        df.with_column("t", F.explode(F.split(F.col("t"), ",")))
    with pytest.raises(ValueError, match="'pos' column would shadow"):
        df.with_column("w", F.posexplode(F.split(F.col("t"), ",")))


def test_copy_past_int32_offsets_raises(monkeypatch):
    """The copy's char totals are read before the expansion: past the
    offsets' range (a small limit stands in for 2^31 here) the query
    raises, naming the column; it never wraps."""
    monkeypatch.setattr(gen_ops, "MAX_PLAIN_CHARS", 1000)
    q = _explode(F, port_session(**{"spark.rapids.sql.test.enabled": True}),
                 "pln", False)
    with pytest.raises(ValueError, match="'pln' would need"):
        q.collect()
