"""Out-of-core execution (``exec/outofcore.py``) through the port's session
against the JAX package's, on the CPU (the contracts of the JAX package's
``tests/test_outofcore.py``).

At the JAX package's tiny working-set budget (``OOC_CONF``: 32 KiB,
shuffled joins) a join, an aggregate and a sort whose measured working
set passes the budget must complete by grace partitioning and spilling:
``ooc.operators`` and the spill counters advance in both packages, the
fan-out is the JAX package's where the column forms (and so the measured
sizes) match, and the answers equal the JAX session's and pandas (keys,
counts and order exact, float sums at rtol 1e-9; the external sort's rows
in exactly the single-batch sort's order, ties included). Every join type
runs bucket by bucket, a build fragment over budget recurses one level,
and the hash aggregation splits a batch past ``agg.hash.maxTableSlots``
(``hashAggSplit``) in both packages. With out-of-core off nothing
engages. ``choose_fanout``, ``_level_hash``, the range partition ids and
``pick_bounds_from_samples`` give the JAX package's values.
"""

from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.obs.metrics import REGISTRY as REF_REGISTRY
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.exec import outofcore as ooc
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

F64_RTOL = 1e-9
OOC_CONF = {
    "spark.rapids.tpu.outOfCore.enabled": True,
    "spark.rapids.tpu.outOfCore.partitionBytes": 32 * 1024,
    "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
}
HASH_CONFS = {"spark.rapids.sql.agg.hashAggEnabled": True}


def _spills(reg):
    return (reg.value("spill.events", direction="device_to_host")
            + reg.value("spill.events", direction="host_to_disk"))


def _ops(reg, op):
    return reg.value("ooc.operators", op=op)


def _fanout(reg, op):
    return reg.value("ooc.fanout", op=op)


def _session(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _port(q, **conf):
    s = _session(**conf)
    out = q(s, F).collect()
    s.stop()
    return out


def _ref(q, conf=None):
    return with_tpu_session(lambda s: q(s, RF), conf=conf)


def _left(n=2500, seed=42):
    # sized to pass the 32 KiB budget several times over (the budget, not
    # the data, forces the spilling)
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 150, n).astype(np.int64),
        "v": rng.random(n),
        "s": np.array(["s%02d" % i for i in rng.integers(0, 40, n)]),
    })


def _same(got, want, keys=None):
    """Equal frames: by ``keys`` (sorted first) or in order; floats at
    rtol 1e-9, the rest exact."""
    if keys:
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        if pd.api.types.is_float_dtype(w):
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64),
                                       rtol=F64_RTOL, equal_nan=True)
        else:
            assert list(g.astype(object).where(g.notna(), None)) == list(
                w.astype(object).where(w.notna(), None)), c


# --- grace hash join ------------------------------------------------------

def _join_query(how):
    right = pd.DataFrame({"k": np.arange(0, 150, 2, dtype=np.int64)})
    right["tag"] = ["t%d" % i for i in range(len(right))]
    left = _left()

    def q(s, fn):
        j = s.create_dataframe(left, 3).join(s.create_dataframe(right, 2),
                                             on="k", how=how)
        if how in ("leftsemi", "leftanti"):
            return j.group_by("s").agg(fn.count("*").alias("n"),
                                       fn.sum("v").alias("sv"))
        return j.group_by("k").agg(fn.count("*").alias("n"),
                                   fn.sum("v").alias("sv"))
    return q


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "leftsemi", "leftanti"])
def test_grace_join_matches_reference_with_spill(how):
    q = _join_query(how)
    s0, j0 = _spills(REGISTRY), _ops(REGISTRY, "join")
    r0 = len(ooc.RECORDS)
    f0 = _fanout(REGISTRY, "join")
    got = _port(q, **OOC_CONF)
    fanout = _fanout(REGISTRY, "join") - f0
    assert _ops(REGISTRY, "join") > j0, "grace join did not engage"
    assert _spills(REGISTRY) > s0, "no spill at a 32 KiB budget"
    assert all(r["fanout"] >= 2 for r in list(ooc.RECORDS)[r0:])
    key = "s" if how in ("leftsemi", "leftanti") else "k"
    _same(got, _port(q), [key])  # the in-memory join
    if how in ("inner", "left"):
        rs0, rj0 = _spills(REF_REGISTRY), _ops(REF_REGISTRY, "join")
        rf0 = _fanout(REF_REGISTRY, "join")
        want = _ref(q, OOC_CONF)
        assert _ops(REF_REGISTRY, "join") > rj0
        assert fanout == _fanout(REF_REGISTRY, "join") - rf0
        assert _spills(REF_REGISTRY) > rs0
        _same(got, want, [key])


def test_grace_join_recurses_on_an_oversized_fragment():
    """Every build row shares one key: the build fragment cannot split, so
    its bucket recurses with the next level's hash (maxRecursion 2)."""
    n = 3000
    rng = np.random.default_rng(5)
    left = pd.DataFrame({"k": np.zeros(40, np.int64), "v": rng.random(40)})
    right = pd.DataFrame({"k": np.zeros(n, np.int64),
                          "w": np.arange(n, dtype=np.int64)})

    def q(s, fn):
        return (s.create_dataframe(left, 1)
                .join(s.create_dataframe(right, 2), on="k")
                .agg(fn.count("*").alias("n"), fn.sum("w").alias("sw")))
    r0 = len(ooc.RECORDS)
    got = _port(q, **dict(OOC_CONF, **{
        "spark.rapids.tpu.outOfCore.maxRecursion": 2,
        "spark.rapids.tpu.outOfCore.partitionBytes": 4096}))
    levels = [r["level"] for r in list(ooc.RECORDS)[r0:]
              if r["op"] == "join"]
    assert 0 in levels and 1 in levels, levels
    assert int(got.n[0]) == n * 40 and int(got.sw[0]) == 40 * sum(range(n))


# --- external sort --------------------------------------------------------

def _sort_frame(n=2500, seed=7):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 30, n).astype(np.int64),
        "v": np.round(rng.random(n), 2),  # ties
        "s": np.array(["s%02d" % i for i in rng.integers(0, 40, n)]),
        "n": pd.array(np.where(rng.random(n) < 0.2, None,
                               rng.integers(0, 9, n)), dtype="Int64"),
        "i": np.arange(n, dtype=np.int64),
    })


@pytest.mark.parametrize("orders", ["v", "k desc, v", "s, n desc",
                                    "n, v desc"])
def test_external_sort_equals_the_single_batch_sort(orders):
    df = _sort_frame()

    def q(s, fn):
        cols = []
        for o in orders.split(", "):
            name, *desc = o.split()
            cols.append(fn.col(name).desc() if desc else fn.col(name))
        return s.create_dataframe(df, 3).order_by(*cols)
    s0, o0 = _spills(REGISTRY), _ops(REGISTRY, "sort")
    f0 = _fanout(REGISTRY, "sort")
    got = _port(q, **OOC_CONF)
    fanout = _fanout(REGISTRY, "sort") - f0
    assert _ops(REGISTRY, "sort") > o0, "external sort did not engage"
    assert _spills(REGISTRY) > s0
    # the exact sequence, ties in the stable order (the row id column)
    _same(got, _port(q))
    if orders == "v":
        rs0, ro0 = _spills(REF_REGISTRY), _ops(REF_REGISTRY, "sort")
        rf0 = _fanout(REF_REGISTRY, "sort")
        want = _ref(q, OOC_CONF)
        assert _ops(REF_REGISTRY, "sort") > ro0
        assert _spills(REF_REGISTRY) > rs0
        _same(got, want)
        # the same column forms, so the same measured sizes and fan-out
        assert fanout == _fanout(REF_REGISTRY, "sort") - rf0


# --- spillable aggregation and the hash split -------------------------------

def _agg_frame(n=3000, seed=42):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 1500, n).astype(np.int64),
        "v": rng.random(n),
        "w": rng.integers(-50, 50, n),
    })


def _agg_query(df):
    def q(s, fn):
        return (s.create_dataframe(df, 3).group_by("k")
                .agg(fn.sum("v").alias("sv"), fn.count("*").alias("n"),
                     fn.max("w").alias("mw")))
    return q


def test_spillable_aggregate_matches_reference_with_spill():
    df = _agg_frame()
    q = _agg_query(df)
    s0, a0 = _spills(REGISTRY), _ops(REGISTRY, "aggregate")
    f0 = _fanout(REGISTRY, "aggregate")
    got = _port(q, **OOC_CONF)
    assert _ops(REGISTRY, "aggregate") > a0, "spillable agg did not engage"
    assert _spills(REGISTRY) > s0
    rs0, ra0 = _spills(REF_REGISTRY), _ops(REF_REGISTRY, "aggregate")
    rf0 = _fanout(REF_REGISTRY, "aggregate")
    want = _ref(q, OOC_CONF)
    assert _ops(REF_REGISTRY, "aggregate") > ra0
    assert _spills(REF_REGISTRY) > rs0
    _same(got, want, ["k"])
    # int64 and float64 columns in both: the same measured sizes, so the
    # same engagements and fan-outs
    assert (_fanout(REGISTRY, "aggregate") - f0
            == _fanout(REF_REGISTRY, "aggregate") - rf0)
    want_pd = df.groupby("k", as_index=False).agg(
        sv=("v", "sum"), n=("v", "size"), mw=("w", "max"))
    _same(got, want_pd.astype({"mw": got.mw.dtype}), ["k"])


def test_hash_split_past_max_table_slots():
    """A partial batch whose B2 table would pass agg.hash.maxTableSlots
    splits by key hash into slices that fit, in both packages."""
    df = _agg_frame(4000)
    q = _agg_query(df)
    conf = dict(HASH_CONFS, **{"spark.rapids.sql.agg.hash.maxTableSlots":
                               256})
    h0 = _ops(REGISTRY, "hashAggSplit")
    got = _port(q, **conf)
    assert _ops(REGISTRY, "hashAggSplit") > h0
    rh0 = _ops(REF_REGISTRY, "hashAggSplit")
    want = _ref(q, conf)
    assert _ops(REF_REGISTRY, "hashAggSplit") > rh0
    _same(got, want, ["k"])
    _same(got, _port(q), ["k"])


def test_out_of_core_default_off_leaves_plans_alone():
    df = _left(2000)

    def q(s, fn):
        return (s.create_dataframe(df, 2).group_by("s")
                .agg(fn.sum("v").alias("sv")).order_by("s"))
    ops = ("join", "sort", "aggregate")
    before = [_ops(REGISTRY, op) for op in ops]
    s0 = _spills(REGISTRY)
    s = _session()
    got = q(s, F).collect()
    assert [_ops(REGISTRY, op) for op in ops] == before
    assert _spills(REGISTRY) == s0
    assert s.last_query_metrics["memory"]["spillEvents.device_to_host"] == 0
    _same(got, _ref(q))


# --- the drivers' pieces against the JAX package's ----------------------------

@pytest.mark.parametrize("total,budget,fanout", [
    (10 << 20, 1 << 20, 0), (3 << 20, 1 << 20, 0), (100, 1 << 20, 0),
    (1 << 40, 1, 0), (10 << 20, 1 << 20, 8), (10 << 20, 1 << 20, 100)])
def test_choose_fanout_as_the_jax_package(total, budget, fanout):
    from spark_rapids_tpu.config.conf import TpuConf as RefConf
    from spark_rapids_tpu.exec import outofcore as ref_ooc
    from spark_rapids_tpu_torch.config.conf import TpuConf
    settings = {"spark.rapids.tpu.outOfCore.fanout": fanout}
    ctx = SimpleNamespace(conf=TpuConf(settings), session=None)
    rctx = SimpleNamespace(conf=RefConf(settings), session=None)
    got = ooc.choose_fanout(ctx, total, budget)
    assert got == ref_ooc.choose_fanout(rctx, total, budget)
    assert got == {(10 << 20, 0): 16, (3 << 20, 0): 4, (100, 0): 2,
                   (1 << 40, 0): 64, (10 << 20, 8): 8,
                   (10 << 20, 100): 64}[(total, fanout)]


def _key_frame(n=512, seed=1):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 1000, n).astype(np.int64),
        "v": rng.random(n),
        "s": np.array(["a%03d" % i for i in rng.integers(0, 300, n)]),
    })


def test_level_hash_matches_the_jax_package_and_moves_between_levels():
    from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
    from spark_rapids_tpu.exec import outofcore as ref_ooc
    df = _key_frame()
    batch = DeviceBatch.from_pandas(df, {}, device="cpu", slab_stride=64)
    ref = RefBatch.from_pandas(df)
    n = len(df)
    counts = []
    for keys in ([0], [0, 2]):
        for level in range(3):
            got = ooc._level_hash(batch, keys, level)[:n].numpy()
            want = np.asarray(ref_ooc._level_hash(ref, keys, level))[:n]
            assert np.array_equal(got, want.view(np.int64)), (keys, level)
            pid = ooc.partition_ids_by_hash(batch, keys, 4, level)
            c = np.bincount(pid[:n].numpy(), minlength=4)
            assert c.sum() == n
            counts.append(tuple(c))
    assert len(set(counts[:3])) > 1, "levels gave identical partitions"


def test_range_partition_ids_and_bounds_match_the_jax_package():
    import jax.numpy as jnp

    from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
    from spark_rapids_tpu.ops import sortops as ref_sortops
    from spark_rapids_tpu.parallel import distributed as ref_dist
    from spark_rapids_tpu_torch.ops import sortops
    from spark_rapids_tpu_torch.parallel import distributed
    df = _key_frame(700, seed=3)
    df.loc[::9, "v"] = np.nan
    batch = DeviceBatch.from_pandas(df, {}, device="cpu", slab_stride=64)
    ref = RefBatch.from_pandas(df)
    keys, asc, nf = [2, 1, 0], [True, False, True], [True, False, False]
    ops = sortops.sort_key_operands(batch, keys, asc, nf)
    m = np.stack([o.numpy() for o in ops]).view(np.uint64)
    samples = [m[:, :300], m[:, 300:700]]
    for n in (2, 5, 16):
        bounds = distributed.pick_bounds_from_samples(samples, len(ops), n)
        want_b = ref_dist.pick_bounds_from_samples(samples, len(ops), n)
        assert all(np.array_equal(a, b) for a, b in zip(bounds, want_b))
        got = sortops.range_partition_ids(
            batch, keys, asc, nf,
            [torch.from_numpy(b.view(np.int64)) for b in bounds])
        want = ref_sortops.range_partition_ids(
            ref, keys, asc, nf, [jnp.asarray(b) for b in bounds])
        assert np.array_equal(got[:len(df)].numpy(),
                              np.asarray(want)[:len(df)])
        # the ids are monotone along the sorted order
        perm = sortops.sort_permutation(batch, keys, asc, nf)[:len(df)]
        assert (np.diff(got[perm.long()].numpy()) >= 0).all()


def test_split_by_pid_is_stable_with_dead_rows_last():
    from spark_rapids_tpu_torch.exec.tpu import split_by_pid
    df = pd.DataFrame({"x": np.arange(20, dtype=np.int64)})
    batch = DeviceBatch.from_pandas(df, device="cpu")  # capacity 32
    pid = torch.tensor([3, 1, 0, 1] * 8, dtype=torch.int64)
    sorted_b, counts = split_by_pid(batch, pid, 4)
    live = pid[:20].numpy()
    assert counts.tolist() == [int((live == p).sum()) for p in range(4)]
    got = sorted_b.columns[0].data[:20].numpy()
    want = np.concatenate([np.flatnonzero(live == p) for p in range(4)])
    assert np.array_equal(got, want)
    assert int(sorted_b.num_rows) == 20
    assert not sorted_b.columns[0].validity[20:].any()
