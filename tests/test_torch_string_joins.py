"""String join keys and wide char slabs through the port's
``TpuSparkSession`` on the CPU, against the JAX package's session.

String join keys take the union-lexsort probe (``ops/joins.join_probe``):
every join type over a dictionary pair with equal dictionaries, with
differing ones, two char slabs, a slab against a dictionary, and slabs
wider than 64 bytes whose values tie on their first 64 bytes and their
length (the JAX package uploads those as offsets and chars and repairs
the tie by full-length compares; the port images every slab word).

Wide strings (the repaired upload): a column of 600 distinct 75-byte
values uploads as a 128-byte slab, and every consumer keeps values that
tie on 64 bytes and the length apart: a filter and projection, sort,
distinct, group-by, min/max, comparisons and join keys; nulls, and a
later batch wider than the first. Keys, counts and strings exact.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.exec import tpujoin
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from tests.test_torch_session_joins import _rows
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

JOIN_TYPES = ["inner", "left", "right", "full", "leftsemi", "leftanti"]
KINDS = ["dict_same", "dict_differ", "slab", "slab_dict", "wide"]
WIDE = "y" * 64  # the shared 64-byte prefix of the wide values


def _port(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _values(kind: str, side: str):
    """The key values a side draws from."""
    if kind == "dict_same":
        return [f"v{i}" for i in range(20)]
    if kind == "dict_differ":
        return [f"v{i}" for i in (range(20) if side == "l"
                                  else range(10, 30))]
    if kind == "slab" or (kind == "slab_dict" and side == "l"):
        return [f"key{i:05d}" for i in range(600)]
    if kind == "slab_dict":
        return [f"key{i:05d}" for i in range(0, 600, 30)]
    return [WIDE + f"{i:011d}" for i in range(600)]  # wide


def _side(kind: str, side: str, n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    vals = _values(kind, side)
    # every value at least once (equal value sets give equal
    # dictionaries), in an order that interleaves tied prefixes
    idx = np.concatenate([rng.permutation(len(vals)),
                          rng.integers(0, len(vals), max(n - len(vals),
                                                         0))])[:n]
    keys = np.asarray(vals, dtype=object)[idx]
    keys[rng.random(n) < 0.1] = None
    return pd.DataFrame({f"{side}s": keys,
                         f"{side}v": rng.integers(0, 1000, n)})


def _frames(kind: str):
    n = 600 if kind in ("slab", "wide") or kind == "slab_dict" else 120
    return _side(kind, "l", n, 3), _side(kind, "r", n // 2 + 40, 5)


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_string_key_join_matches_reference_session(session, kind, how):
    """Each join type over each string-key layout: the port's device
    operators (test mode: the union probe runs on the device) equal the
    JAX session and the port's CPU operators."""
    l_df, r_df = _frames(kind)

    def query(s):
        return s.create_dataframe(l_df).join(
            s.create_dataframe(r_df), left_on=["ls"], right_on=["rs"],
            how=how)
    want = with_tpu_session(query)
    df = query(_port())
    tpujoin.reset_routes()
    got = df.collect()
    assert tpujoin.ROUTES["union"] > 0
    assert tpujoin.ROUTES["hash"] == tpujoin.ROUTES["dense"] == 0
    cpu = query(_port(**{"spark.rapids.sql.enabled": False})).collect()
    assert _rows(got) == _rows(want) == _rows(cpu)
    if how in ("inner", "leftsemi"):
        assert len(got) > 0


def test_mixed_string_and_integer_keys(session):
    """A two-key join, a wide slab and an integer: the union probe images
    both, exactly."""
    l_df, r_df = _frames("wide")
    l_df = l_df.assign(lk=np.arange(len(l_df)) % 3)
    r_df = r_df.assign(rk=np.arange(len(r_df)) % 3)

    def query(s):
        return s.create_dataframe(l_df).join(
            s.create_dataframe(r_df), left_on=["ls", "lk"],
            right_on=["rs", "rk"])
    got = query(_port()).collect()
    assert _rows(got) == _rows(with_tpu_session(query))
    assert len(got) > 0


# ---------------------------------------------------------------------------
# The repaired upload: wide, high-cardinality strings
# ---------------------------------------------------------------------------

def _wide_frame(n: int = 600, width: int = 75, seed: int = 11,
                nulls: bool = True) -> pd.DataFrame:
    """``n`` distinct ``width``-byte values that share their first 64
    bytes (and their length), shuffled, beside an int64 key."""
    rng = np.random.default_rng(seed)
    tail = width - len(WIDE)
    vals = np.asarray([WIDE + f"{i:0{tail}d}" for i in range(n)],
                      dtype=object)[rng.permutation(n)]
    if nulls:
        vals[rng.random(n) < 0.05] = None
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64), "s": vals})


def _both(query, **conf):
    """(port answer, JAX session answer) of ``query(session, functions)``."""
    got = query(_port(**conf), F).collect()
    want = with_tpu_session(lambda rs: query(rs, RF), conf=conf)
    return got, want


def test_wide_string_upload_filter(session):
    """The probe of the fault: 600 distinct 75-byte values beside an int64
    key, ``filter(k < 10).select(k, s)``, returns the JAX session's 10
    rows, in test mode."""
    df = _wide_frame(nulls=False)
    got, want = _both(lambda s, fn: s.create_dataframe(df)
                      .filter(fn.col("k") < 10).select("k", "s"))
    assert len(got) == 10
    assert _rows(got) == _rows(want)


def test_wide_string_later_batch_wider(session):
    """Two batches of one scan: 600 values of 70 bytes (a 128-byte slab),
    then 600 of 150 bytes (a 256-byte slab). Concatenated for a sort, the
    narrower slab widens with zero words."""
    df = pd.concat([_wide_frame(600, 70, seed=1).assign(k=np.arange(600)),
                    _wide_frame(600, 150, seed=2).assign(
                        k=np.arange(600, 1200))], ignore_index=True)
    conf = {"spark.rapids.sql.batchSizeRows": 600}
    got, want = _both(lambda s, fn: s.create_dataframe(df)
                      .filter(fn.col("k") % 7 != 3)
                      .order_by(fn.col("s").desc(), "k"), **conf)
    assert len(got) > 1000
    assert [str(x) for x in got.s] == [str(x) for x in want.s]
    assert list(got.k) == list(want.k)


@pytest.mark.parametrize("consumer", ["sort", "distinct", "group_by",
                                      "min_max", "compare", "join"])
def test_wide_string_consumers(session, consumer):
    """Each consumer of a 128-byte slab keeps values that tie on 64 bytes
    and the length apart, as the JAX session does."""
    df = _wide_frame()
    probe = df.s.dropna().iloc[17]

    def query(s, fn):
        t = s.create_dataframe(df)
        if consumer == "sort":
            return t.order_by("s", "k")
        if consumer == "distinct":
            return t.select("s").distinct()
        if consumer == "group_by":
            return (t.union(t).group_by("s")
                    .agg(fn.count("*").alias("n"), fn.sum("k").alias("sk")))
        if consumer == "min_max":
            return t.agg(fn.min("s").alias("lo"), fn.max("s").alias("hi"))
        if consumer == "compare":
            return t.filter((fn.col("s") < probe) | (fn.col("s") == probe))
        other = s.create_dataframe(df.rename(columns={"k": "k2",
                                                      "s": "s2"}))
        return t.join(other, left_on=["s"], right_on=["s2"])
    got, want = _both(query)
    if consumer == "sort":
        assert ([str(x) for x in got.s] == [str(x) for x in want.s]
                and list(got.k) == list(want.k))
    else:
        assert _rows(got) == _rows(want)
    if consumer in ("distinct", "join"):
        assert len(got) == df.s.nunique() + (consumer == "distinct")
