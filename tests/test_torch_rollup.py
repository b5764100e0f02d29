"""rollup and cube through the port's ``TpuSparkSession`` on the CPU,
against the JAX package's session (its CPU operators, and its device
operators for two of the cases) and pandas on the same seeded frame.

The grouping sets run as an Expand (one projection a set: the rolled-up
keys typed NULL literals, plus a ``_gid`` literal) under the aggregate,
as in the JAX package. The string keys take each form, a dictionary, a
char slab and plain offsets+chars, and hold NULLs of their own; so one
aggregate stream mixes the real column's form with the NULL literal's
dictionary, batch by batch. Each runs at the JAX package's default
confs and under ``HASH_AGG_CONFS`` (the hash branch, kernel B2's plain
version here, for dictionary and integer keys), in test mode through the
port's device operators, and through its CPU operators.
"""

import itertools

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.models.tpch import HASH_AGG_CONFS
from spark_rapids_tpu_torch.ops import aggregate as agg_ops
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import (
    assert_frames_equal, with_cpu_session, with_tpu_session,
)
from tests.test_torch_exprs_tail import port_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 400


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(16)

    def nulls(values):
        out = np.asarray(values, dtype=object)
        out[rng.random(N) < 0.08] = None
        return out
    regions = np.array(["east", "west", "north", "south"], dtype=object)
    return pd.DataFrame({
        "dct": nulls(regions[rng.integers(0, 4, N)]),
        "slb": nulls([f"store-{i:03d}" for i in rng.integers(0, 300, N)]),
        "pln": nulls([("p" * 66 + str(i)) for i in rng.integers(0, 280, N)]),
        "k": rng.integers(0, 3, N).astype(np.int32),
        "qty": pd.Series(rng.integers(1, 50, N)).astype("Int64").mask(
            pd.Series(rng.random(N) < 0.1)),
        "price": rng.integers(100, 10000, N) / 100.0,
    })


FRAME = _frame()
KEYS = {"dct": ["dct", "k"], "slb": ["slb", "dct"], "pln": ["pln", "k"]}


def _query(M, s, kind: str, form: str):
    df = s.create_dataframe(FRAME, 3)
    grouped = getattr(df, kind)(*KEYS[form])
    return grouped.agg(M.sum("qty").alias("total"),
                       M.count("*").alias("n"),
                       M.max("price").alias("top"),
                       M.min(M.col("k")).alias("low"))


def _pandas(kind: str, form: str) -> pd.DataFrame:
    """The grouping sets' groups, by pandas: a rolled-up key is NULL."""
    keys = KEYS[form]
    sets = ([keys[:i] for i in range(len(keys), -1, -1)] if kind == "rollup"
            else [list(c) for r in range(len(keys), -1, -1)
                  for c in itertools.combinations(keys, r)])
    parts = []
    for kept in sets:
        f = FRAME.copy()
        for k in keys:
            if k not in kept:
                f[k] = None
        g = f.groupby(keys, dropna=False, sort=False).agg(
            total=("qty", "sum"), n=("price", "size"),
            top=("price", "max"), low=("k", "min")).reset_index()
        parts.append(g)
    out = pd.concat(parts, ignore_index=True)
    return out[keys + ["total", "n", "top", "low"]]


def _key_tuples(df: pd.DataFrame, keys) -> list:
    def text(v):
        if pd.isna(v):
            return "<null>"
        return str(int(v)) if isinstance(v, (float, np.floating)) else str(v)
    return sorted(tuple(text(v) for v in row) + (int(n),) for row, n in
                  zip(df[keys].itertuples(index=False), df["n"]))


@pytest.mark.parametrize("confs", ["default", "hash"])
@pytest.mark.parametrize("form", ["dct", "slb", "pln"])
@pytest.mark.parametrize("kind", ["rollup", "cube"])
def test_grouping_sets_match_reference(kind, form, confs):
    conf = HASH_AGG_CONFS if confs == "hash" else {}
    want = with_cpu_session(lambda s: _query(RF, s, kind, form))
    sets = 3 if kind == "rollup" else 4
    assert len(want) > sets
    agg_ops.BRANCHES.clear()
    dev = _query(F, port_session(**dict(
        conf, **{"spark.rapids.sql.test.enabled": True})), kind,
        form).collect()
    got_all = [dev]
    if confs == "hash":
        # dictionary and integer keys take B2; a slab or plain key has no
        # one-word image, so its batches take the sorted branches
        if form == "dct":
            assert agg_ops.BRANCHES["hash"] > 0, dict(agg_ops.BRANCHES)
    else:
        # the CPU operators read no aggregation conf: once is enough
        got_all.append(_query(F, port_session(**{
            "spark.rapids.sql.enabled": False}), kind, form).collect())
    for got in got_all:
        assert_frames_equal(got, want, ignore_order=True, approx=True)
    # and pandas: every (keys, count) group of every grouping set
    keys = KEYS[form]
    assert _key_tuples(dev, keys) == _key_tuples(_pandas(kind, form), keys)


@pytest.mark.parametrize("kind,form", [("rollup", "dct"), ("cube", "pln")])
def test_reference_device_path_agrees(kind, form):
    """The JAX package's device operators give the same groups (the
    cases above hold the port to its CPU operators, which compile
    nothing)."""
    want = with_tpu_session(lambda s: _query(RF, s, kind, form))
    got = _query(F, port_session(**{"spark.rapids.sql.test.enabled": True}),
                 kind, form).collect()
    assert_frames_equal(got, want, ignore_order=True, approx=True)


def test_rollup_totals():
    """The grand total row counts every row; each first-key subtotal sums
    to it."""
    out = _query(F, port_session(**{"spark.rapids.sql.test.enabled": True}),
                 "rollup", "pln").collect()
    grand = out[out.pln.isna() & out.k.isna()]
    # the data's own NULL keys make a second all-NULL group at level 2
    assert int(grand.n.max()) == N
    sub = out[out.k.isna()]
    assert int(sub.n.sum()) == 2 * N
