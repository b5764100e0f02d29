"""Capacity speculation and dense grouping keys of the port's session
(``spark.rapids.sql.adaptiveCapacity.enabled``, ``agg.denseKeys``) on the
CPU, against the JAX package.

The JAX package's ``tests/test_capacity_spec.py`` (5 cases) and
``tests/test_dense_group.py`` (4 cases) run here against the port's
session (``device="cpu"``): each query runs through the port's device
operators, its CPU operators (``spark.rapids.sql.enabled=false``) and the
JAX package's session on the same seeded frames, every run equal to both
(keys and counts exact, float64 at rtol 1e-9). Then the port's own
contract: a warm run makes one counted ``speculation.verify`` and no
``join.expandTotals``; an undersized entry re-runs once; a write turns
speculation off; the exchange's shrink verifies its counts exactly; and
``ops/aggregate.dense_composite`` is bit-equal to the JAX package's
composite and ok flag.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import assert_frames_equal, with_tpu_session


def _session(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _on(s, q, conf=None):
    """``q(s)`` collected on the port's device path under ``conf``."""
    saved = dict(s.conf._settings)
    try:
        for k, v in (conf or {}).items():
            s.set_conf(k, v)
        return q(s).collect()
    finally:
        s.conf._settings = saved


def _cpu(s, q):
    return _on(s, q, {"spark.rapids.sql.enabled": False,
                      "spark.rapids.sql.test.enabled": False})


def _syncs(fn):
    """(fn's result, its counted syncs by site)."""
    before = dict(SYNCS.syncs)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                 if v - before.get(k, 0)}


def _same(got, want):
    assert_frames_equal(got, want, ignore_order=True, approx=True)


# ---------------------------------------------------------------------------
# the JAX package's tests/test_capacity_spec.py
# ---------------------------------------------------------------------------

def _frames(rng, n_orders=4000, n_cust=300):
    orders = pd.DataFrame({
        "o_id": np.arange(n_orders, dtype=np.int64),
        "cust": pd.Series(rng.integers(0, n_cust, n_orders)).astype("Int64")
                  .mask(pd.Series(rng.random(n_orders) < 0.05)),
        "amount": rng.uniform(1.0, 900.0, n_orders),
    })
    cust = pd.DataFrame({
        "cust": pd.Series(np.arange(n_cust, dtype=np.int64)).astype("Int64"),
        "name": pd.Series([f"cust_{i}" for i in range(n_cust)]),
        "tier": rng.integers(0, 3, n_cust),
    })
    return orders, cust


def _join_query(fns, o, c, how="inner"):
    j = o.join(c, on="cust", how=how).filter(fns.col("amount") > 100.0)
    # semi/anti joins keep only the left side's columns
    key = "tier" if how in ("inner", "left", "right", "full") else "cust"
    return j.group_by(key).agg(fns.sum("amount").alias("rev"))


def _reference(orders, cust, how="inner"):
    """The JAX package's session on the same frames."""
    return with_tpu_session(lambda rs: _join_query(
        RF, rs.create_dataframe(orders, 2), rs.create_dataframe(cust, 2),
        how))


@pytest.mark.parametrize("how", ["inner", "left", "leftsemi"])
def test_spec_repeated_runs_match_oracle(rng, how):
    """The first run learns capacities, later runs speculate; every run
    equals the CPU operators and the JAX session, and no verification
    miss fires (identical data: covered buckets)."""
    s = _session()
    orders, cust = _frames(rng)
    o, c = s.create_dataframe(orders, 2), s.create_dataframe(cust, 2)
    want = _reference(orders, cust, how)
    cpu = _cpu(s, lambda _s: _join_query(F, o, c, how))
    _same(cpu, want)
    outs = [_on(s, lambda _s: _join_query(F, o, c, how)) for _ in range(3)]
    for t in outs:
        _same(t, want)
    assert s.capacity_cache, "join never registered a capacity entry"
    assert s.capacity_spec_hits >= 2, \
        "2nd and 3rd runs must speculate (fingerprint failed to match?)"
    assert s.capacity_spec_reruns == 0


def test_spec_undersized_entry_detected_and_rerun(rng):
    """Every cached sizes entry corrupted to 1 row / 1 char: the
    speculative expand truncates, the deferred check catches it, and the
    re-execution still answers right; the entry is dropped and the next
    run re-learns and speculates cleanly."""
    s = _session()
    orders, cust = _frames(rng)
    o, c = s.create_dataframe(orders, 2), s.create_dataframe(cust, 2)
    want = _reference(orders, cust)
    _same(_on(s, lambda _s: _join_query(F, o, c)), want)
    corrupted = []
    for key, ent in s.capacity_cache.items():
        if ent.get("sizes"):
            ent["sizes"] = [[1 for _ in sz] for sz in ent["sizes"]]
            corrupted.append(key)
    assert corrupted, "expected at least one sizes-carrying entry"
    _same(_on(s, lambda _s: _join_query(F, o, c)), want)
    assert s.capacity_spec_reruns == 1
    for key in corrupted:
        assert key not in s.capacity_cache
    _same(_on(s, lambda _s: _join_query(F, o, c)), want)
    assert s.capacity_spec_reruns == 1


def test_spec_conf_disables(rng):
    s = _session(**{"spark.rapids.sql.adaptiveCapacity.enabled": "false"})
    orders, cust = _frames(rng, n_orders=500, n_cust=40)
    o, c = s.create_dataframe(orders, 2), s.create_dataframe(cust, 2)
    want = _reference(orders, cust)
    for _ in range(2):
        _same(_on(s, lambda _s: _join_query(F, o, c)), want)
    assert not s.capacity_cache
    assert s.capacity_spec_hits == 0


def test_spec_join_over_filtered_file_scan(rng, tmp_path):
    """Pushed file-scan filters are part of the plan fingerprint; a join
    above a filtered Parquet scan speculates without a miss."""
    n = 1000
    pd.DataFrame({
        "k": np.arange(n, dtype=np.int64),
        "v": rng.uniform(0, 1, n),
    }).to_parquet(str(tmp_path / "t.parquet"))
    dims = pd.DataFrame({"k": np.arange(0, n, 7, dtype=np.int64),
                         "w": np.arange(0, n, 7, dtype=np.int64) * 2})
    s = _session()
    d = s.create_dataframe(dims, 1)

    def q(fns, sess, dd):
        return (sess.read.parquet(str(tmp_path / "t.parquet"))
                .filter(fns.col("k") > 100).join(dd, on="k"))
    want = with_tpu_session(lambda rs: q(RF, rs, rs.create_dataframe(
        dims, 1)))
    for _ in range(3):
        _same(_on(s, lambda _s: q(F, s, d)), want)
    assert s.capacity_spec_reruns == 0


def test_spec_distinguishes_different_data(rng):
    """Two structurally identical queries over DIFFERENT data must not
    share capacity entries (the fingerprint carries the source's data
    identity): both stay right with zero misses."""
    s = _session()
    orders, cust = _frames(rng)
    o1, c = s.create_dataframe(orders, 2), s.create_dataframe(cust, 2)
    o2 = o1.filter(F.col("o_id") < 700)
    for o in (o1, o2, o1, o2):
        _same(_on(s, lambda _s: _join_query(F, o, c)),
              _cpu(s, lambda _s: _join_query(F, o, c)))
    assert s.capacity_spec_reruns == 0


# ---------------------------------------------------------------------------
# the JAX package's tests/test_dense_group.py
# ---------------------------------------------------------------------------

def _orders(rng, n=6000):
    return pd.DataFrame({
        "okey": pd.Series(rng.integers(1000, 9000, n)).astype("Int64")
                  .mask(pd.Series(rng.random(n) < 0.03)),
        "skey": pd.Series(rng.integers(0, 40, n)).astype("Int64"),
        "qty": rng.uniform(1.0, 50.0, n),
    })


def _dense_q(fns, o):
    return o.group_by("okey").agg(
        fns.sum("qty").alias("sq"), fns.count("*").alias("n"),
        fns.max("qty").alias("mx"))


def test_dense_single_key_matches_oracle(rng):
    """Dense grouping engages from the SECOND execution of a plan: the
    first run and the dense later runs all equal the JAX session, and
    healthy stats never re-execute."""
    from spark_rapids_tpu_torch.ops import aggregate
    s = _session()
    frame = _orders(rng)
    o = s.create_dataframe(frame, 2)
    want = with_tpu_session(lambda rs: _dense_q(
        RF, rs.create_dataframe(frame, 2)))
    aggregate.reset_branches()
    for _ in range(3):
        _same(_on(s, lambda _s: _dense_q(F, o)), want)
    assert s.capacity_spec_reruns == 0
    assert aggregate.BRANCHES["dense"] > 0


def test_dense_multi_key_with_nulls(rng):
    s = _session()
    frame = _orders(rng)
    o = s.create_dataframe(frame, 2)

    def q(fns, d):
        return (d.group_by("okey", "skey")
                .agg(fns.sum("qty").alias("sq"), fns.count("*").alias("n")))
    want = with_tpu_session(lambda rs: q(RF, rs.create_dataframe(frame, 2)))
    for _ in range(3):
        _same(_on(s, lambda _s: q(F, o)), want)
    assert s.capacity_spec_reruns == 0


def test_dense_stale_stats_fall_back_exactly(rng):
    """Advisory bounds shifted so every live key falls outside them: the
    deferred check catches the dense miss, the query re-executes without
    dense grouping (still right) and the plan is blocklisted, so the next
    run does not re-pay the re-execution."""
    s = _session()
    frame = _orders(rng)
    o = s.create_dataframe(frame, 2)
    want = _cpu(s, lambda _s: _dense_q(F, o))
    _same(_on(s, lambda _s: _dense_q(F, o)), want)
    lo, hi = s.column_stats["okey"]
    s.column_stats["okey"] = (hi + 10000, hi + 40000)
    _same(_on(s, lambda _s: _dense_q(F, o)), want)
    assert s.capacity_spec_reruns == 1
    assert len(s.capacity_spec_blocklist) > 0
    _same(_on(s, lambda _s: _dense_q(F, o)), want)
    assert s.capacity_spec_reruns == 1, \
        "a blocklisted plan must not re-execute again"


def test_dense_conf_gate(rng):
    from spark_rapids_tpu_torch.ops import aggregate
    s = _session(**{"spark.rapids.sql.agg.denseKeys": "false"})
    frame = _orders(rng)
    o = s.create_dataframe(frame, 2)
    want = _cpu(s, lambda _s: _dense_q(F, o))
    aggregate.reset_branches()
    for _ in range(2):
        _same(_on(s, lambda _s: _dense_q(F, o)), want)
    assert aggregate.BRANCHES["dense"] == 0


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------

def _q3_tables(s):
    from spark_rapids_tpu_torch.models import tpch_data as G
    return {"lineitem": s.create_dataframe(G.gen_lineitem(0.002)),
            "orders": s.create_dataframe(G.gen_orders(0.002)),
            "customer": s.create_dataframe(G.gen_customer(0.002))}


def test_warm_q3_makes_one_verify_and_no_expand_totals():
    """Session Q3 (two broadcast joins): the cold run pays one
    ``join.expandTotals`` a join; warm runs expand into the cached sizes
    and make exactly one ``speculation.verify`` and no
    ``join.expandTotals``, with the same answer."""
    from spark_rapids_tpu_torch.models import tpch
    s = _session()
    t = _q3_tables(s)
    cold, cold_syncs = _syncs(lambda: tpch.q3(s, t).collect())
    assert cold_syncs.get("join.expandTotals") == 2
    assert "speculation.verify" not in cold_syncs
    for _ in range(3):
        warm, warm_syncs = _syncs(lambda: tpch.q3(s, t).collect())
        assert warm_syncs.get("speculation.verify") == 1
        assert "join.expandTotals" not in warm_syncs
        _same(warm, cold)
    assert s.capacity_spec_reruns == 0


def test_q3_undersized_entry_reruns_once_and_relearns():
    from spark_rapids_tpu_torch.models import tpch
    s = _session()
    t = _q3_tables(s)
    want = tpch.q3(s, t).collect()
    tpch.q3(s, t).collect()
    key = next(k for k, e in s.capacity_cache.items() if e.get("sizes")
               and any(sz[0] > 1 for sz in e["sizes"]))
    s.capacity_cache[key]["sizes"] = [[max(sz[0] // 4, 1)] + sz[1:]
                                      for sz in s.capacity_cache[key]
                                      ["sizes"]]
    got, syncs = _syncs(lambda: tpch.q3(s, t).collect())
    _same(got, want)
    assert s.capacity_spec_reruns == 1
    assert syncs.get("speculation.verify") == 1
    # the re-run pays the exact syncs; the missed entry is dropped, the
    # next run relearns it and the one after speculates again
    assert syncs.get("join.expandTotals") == 2
    assert key not in s.capacity_cache
    got, syncs = _syncs(lambda: tpch.q3(s, t).collect())
    _same(got, want)
    assert syncs.get("join.expandTotals") == 1
    assert s.capacity_cache[key]["sizes"][0][0] > 1
    got, syncs = _syncs(lambda: tpch.q3(s, t).collect())
    _same(got, want)
    assert s.capacity_spec_reruns == 1
    assert "join.expandTotals" not in syncs


def test_speculation_keys_carry_the_exchange_route():
    """Sizes learned on one exchange route are not speculated on another
    (the plans, at one partition count, are the same): after warm Q3 runs
    with shuffled joins on the collapse route, the first run on the
    buckets route, and then the first over the shuffle manager, reads its
    join totals exactly, one a join a partition, and re-executes nothing;
    the next run on each speculates them into one
    ``speculation.verify``."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    s = _session(**{"spark.rapids.sql.autoBroadcastJoinThreshold": -1,
                    "spark.rapids.sql.shuffle.partitions": 4})
    t = {"lineitem": s.create_dataframe(G.gen_lineitem(0.002), 2),
         "orders": s.create_dataframe(G.gen_orders(0.002), 2),
         "customer": s.create_dataframe(G.gen_customer(0.002), 2)}
    try:
        want = tpch.q3(s, t).collect()
        _out, syncs = _syncs(lambda: tpch.q3(s, t).collect())
        assert syncs.get("speculation.verify") == 1
        routes = {"spark.rapids.sql.shuffle.localCollapse": False}
        for extra in ({}, {"spark.rapids.shuffle.transport.enabled": True,
                           "spark.rapids.shuffle.executors": 2}):
            routes.update(extra)
            got, syncs = _syncs(
                lambda: _on(s, lambda s_: tpch.q3(s_, t), routes))
            _same(got, want)
            assert syncs.get("join.expandTotals") == 2 * 4
            got, syncs = _syncs(
                lambda: _on(s, lambda s_: tpch.q3(s_, t), routes))
            _same(got, want)
            assert "join.expandTotals" not in syncs
            assert syncs.get("speculation.verify") == 1
        assert s.capacity_spec_reruns == 0
    finally:
        s.stop()


def test_write_turns_speculation_off(rng, tmp_path):
    """A plan with a write keeps its capacity syncs exact: no
    speculation, so no deferred check and no re-execution."""
    s = _session(**{"spark.rapids.sql.test.enabled": False})
    orders, cust = _frames(rng, n_orders=600, n_cust=50)
    o, c = s.create_dataframe(orders, 2), s.create_dataframe(cust, 2)
    for i in range(3):
        _j, syncs = _syncs(lambda: o.join(c, on="cust").write.mode(
            "overwrite").parquet(str(tmp_path / "out")))
        assert "speculation.verify" not in syncs
    assert s.capacity_spec_hits == 0
    back = pd.read_parquet(str(tmp_path / "out"))
    assert len(back) == len(_cpu(s, lambda _s: o.join(c, on="cust")))


def test_shrink_speculation_verifies_exact_counts():
    """Q1's exchanges shrink their padded partials: two cold runs learn
    stable counts, the third speculates them; a cached count that drifts
    by one row fails the EXACT check and re-executes once."""
    from spark_rapids_tpu_torch.models import tpch
    s = _session()
    t = _q3_tables(s)
    runs = [_syncs(lambda: tpch.q1(s, t).collect()) for _ in range(3)]
    assert runs[0][1].get("exchange.shrink") == 2
    assert runs[2][1].get("speculation.verify") == 1
    assert "exchange.shrink" not in runs[2][1]
    for out, _syncs_ in runs[1:]:
        _same(out, runs[0][0])
    key = next(k for k in s.capacity_cache if k.endswith("|shrink"))
    s.capacity_cache[key]["counts"] = [
        c + 1 for c in s.capacity_cache[key]["counts"]]
    got, _s = _syncs(lambda: tpch.q1(s, t).collect())
    _same(got, runs[0][0])
    assert s.capacity_spec_reruns == 1


def test_dense_composite_matches_reference(rng):
    """The composite and the ok flag equal the JAX package's (its uint64
    composite read as int64: every composite is below 2^62), in range
    and out of it, with nulls and dead rows."""
    import jax.numpy as jnp
    import torch

    from spark_rapids_tpu.ops import aggregate as ref_agg
    from spark_rapids_tpu_torch.ops import aggregate
    from spark_rapids_tpu_torch.testing.reference import (
        batch_from_reference,
    )
    from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
    n = 3000
    frame = pd.DataFrame({
        "a": pd.Series(rng.integers(-50, 200, n)).astype("Int64")
               .mask(pd.Series(rng.random(n) < 0.1)),
        "b": pd.Series(rng.integers(0, 9000, n)).astype("Int64"),
        "c": rng.integers(0, 1 << 20, n).astype(np.int32),
    })
    ref = RefBatch.from_pandas(frame)
    port = batch_from_reference(ref)
    live_np = rng.random(ref.capacity) < 0.9
    live_np[n:] = False
    for los, sizes in (([-50, 0, 0], (256, 16384, 1 << 20)),
                       ([0, 100, 0], (128, 4096, 1 << 16))):
        rc, rok = ref_agg.dense_composite(
            ref, [0, 1, 2], jnp.asarray(los, jnp.int64), sizes,
            jnp.asarray(live_np))
        pc, pok = aggregate.dense_composite(
            port, [0, 1, 2], torch.tensor(los, dtype=torch.int64), sizes,
            torch.from_numpy(live_np))
        np.testing.assert_array_equal(
            np.asarray(rc).view(np.int64), pc.numpy())
        assert bool(rok) == bool(pok)
