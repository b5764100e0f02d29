"""The dense-key join probe, ``hash_group_ids`` and ``count_distinct_reduce``
of the port against the JAX package's functions on the CPU, and the dense
route's verification through the session.

  * ``ops/joins.join_probe_dense`` against the JAX package's
    ``join_probe_dense``: the same (counts, bstart, bperm, ok), exactly,
    with nulls, dead rows, stream keys outside the table, and a build key
    outside the advisory bounds (``ok`` False on both).
  * ``ops/kernels.hash_group_ids`` against the JAX package's jnp spelling
    (``mode="off"``; several of its interpret tests are red, ROADMAP
    queue C): the same group ids and representative rows. It reads used
    slots as ``counts > 0``, so it gives the same answer over the card's
    table fill (unused key words -1), simulated here over the plain build.
  * ``ops/aggregate.count_distinct_reduce`` against the JAX package's, by
    group key (the two sort char-slab keys by other images).
  * Through the session: stale scan statistics (a build key outside them)
    send the join to the hash route after one failed verification, with
    the exact answer.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.ops import joins as ref_joins
from spark_rapids_tpu.ops import pallas_kernels as pk
from spark_rapids_tpu.ops.aggregate import (
    count_distinct_reduce as ref_count_distinct,
)
from spark_rapids_tpu_torch.exec import tpujoin
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.ops import joins as join_ops
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops.aggregate import count_distinct_reduce
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.testing.reference import batch_from_reference
from tests.test_torch_session_joins import _rows


def _keyed(n: int, lo: int, hi: int, seed: int, nulls: float = 0.1,
           live: int = None) -> RefBatch:
    rng = np.random.default_rng(seed)
    k = pd.Series(rng.integers(lo, hi, n)).astype("Int64")
    k[rng.random(n) < nulls] = pd.NA
    ref = RefBatch.from_pandas(pd.DataFrame({"k": k,
                                             "v": rng.integers(0, 9, n)}))
    if live is not None:
        import jax.numpy as jnp
        ref = RefBatch(ref.schema, ref.columns, jnp.asarray(live,
                                                            jnp.int32))
    return ref


@pytest.mark.parametrize("case", ["in_bounds", "stream_outside",
                                  "build_outside", "dead_rows"])
def test_join_probe_dense_matches_reference(case):
    import jax.numpy as jnp
    lo, size = 100, 1024
    b_hi = 100 + 1100 if case == "build_outside" else 100 + 900
    s_lo, s_hi = (0, 2000) if case == "stream_outside" else (100, 1000)
    live = 700 if case == "dead_rows" else None
    rb = _keyed(1000, 100, b_hi, 1, live=live)
    rs = _keyed(3000, s_lo, s_hi, 2, live=2500 if live else None)
    want = ref_joins.join_probe_dense(rb, rs, 0, 0, jnp.asarray(lo), size)
    got = join_ops.join_probe_dense(batch_from_reference(rb),
                                    batch_from_reference(rs), 0, 0, lo,
                                    size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == (case != "build_outside")


def _images(rng, n: int, k: int):
    pool = rng.integers(-5, 40, (k, 60))
    pick = rng.integers(0, 60, n)
    return [pool[j][pick] for j in range(k)]


@pytest.mark.parametrize("fill", ["plain", "card"])
@pytest.mark.parametrize("k", [1, 3])
def test_hash_group_ids_matches_reference(monkeypatch, k, fill):
    """Group ids, group count and representative rows equal the JAX
    package's jnp spelling (the same hash and the same slot chain), over
    the plain build's table and over one with the card's -1 fill."""
    import jax.numpy as jnp
    rng = np.random.default_rng(k)
    n = 4000
    imgs = _images(rng, n, k)
    valid = rng.random(n) < 0.9
    T = K.hash_table_size(n)
    if fill == "card":
        real = K.hash_table_build

        def card_fill(images, v, table_size):
            slot, rank, table, counts = real(images, v, table_size)
            table = torch.where(counts[None, :] > 0, table,
                                torch.full_like(table, -1))
            return slot, rank, table, counts
        monkeypatch.setattr(K, "hash_table_build", card_fill)
    gid, ng, rep = K.hash_group_ids(
        [torch.from_numpy(im) for im in imgs], torch.from_numpy(valid), T)
    wg, wn, wr = pk.hash_group_ids(
        [jnp.asarray(im.astype(np.uint64)) for im in imgs],
        jnp.asarray(valid), T, mode="off")
    np.testing.assert_array_equal(gid.numpy(), np.asarray(wg))
    assert int(ng) == int(wn) == len({tuple(im[i] for im in imgs)
                                      for i in np.nonzero(valid)[0]})
    m = int(ng)
    np.testing.assert_array_equal(rep.numpy()[:m], np.asarray(wr)[:m])


@pytest.mark.parametrize("layout", ["fixed", "dictionary", "slab",
                                    "plain"])
def test_count_distinct_reduce_matches_reference(layout):
    rng = np.random.default_rng(5)
    n = 3000
    g = pd.Series(rng.integers(0, 40, n)).astype("Int64")
    g[rng.random(n) < 0.05] = pd.NA
    if layout == "fixed":
        d = pd.Series(rng.integers(0, 25, n)).astype("Int64")
        d[rng.random(n) < 0.05] = pd.NA
    else:
        # a slab up to the 64-byte stride limit; past it, plain chars
        card = 30 if layout == "dictionary" else 900
        pad = {"slab": "z" * 50, "plain": "z" * 70}.get(layout, "")
        d = np.asarray([f"{pad}v{i:03d}"
                        for i in rng.integers(0, card, n)], dtype=object)
        d[rng.random(n) < 0.05] = None
    df = pd.DataFrame({"g": g, "d": d})
    ref = RefBatch.from_pandas(df)
    port = batch_from_reference(ref)
    assert (layout == "slab") == port.columns[1].has_slab
    assert (layout == "plain") == port.columns[1].is_plain

    def by_key(batch_np, rep, counts, ng):
        out = {}
        for i in range(int(ng)):
            key = batch_np[int(rep[i])]
            out[key] = int(counts[i])
        return out
    g_host = [None if pd.isna(x) else int(x) for x in df.g]
    got = count_distinct_reduce(port, [0], [1])
    want = ref_count_distinct(ref, [0], [1])
    gotd = by_key(g_host, got[0].numpy(), got[1].numpy(), got[2])
    wantd = by_key(g_host, np.asarray(want[0]), np.asarray(want[1]),
                   want[2])
    assert gotd == wantd
    exp = df.groupby("g", dropna=False).d.apply(
        lambda s: s.nunique() + int(s.isna().any()))
    assert gotd == {(None if pd.isna(k) else int(k)): int(v)
                    for k, v in exp.items()}


def test_dense_route_falls_back_on_stale_bounds():
    """Statistics that no longer bound the build key (set by hand here, as
    a stale registry would be): the build verifies them, finds a key
    outside, and the join takes the hash route; the answer is exact. The
    expanding join makes two counted syncs (the failed verification with
    its totals, then the totals again), the semi join one. Capacity
    speculation is off here: this is the in-query fallback of a run that
    reads its sizes exactly (``test_dense_route_stale_bounds_under_
    speculation`` holds the default)."""
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"lk": rng.integers(0, 5000, 800)})
    right = pd.DataFrame({"rk": rng.integers(0, 5000, 300),
                          "rv": rng.integers(0, 9, 300)})
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .config("spark.rapids.sql.adaptiveCapacity.enabled", False)
         .get_or_create())
    want = {}
    for how, syncs in (("inner", 2), ("leftsemi", 1)):
        df = s.create_dataframe(left).join(s.create_dataframe(right),
                                           left_on="lk", right_on="rk",
                                           how=how)
        df.collect()  # uploads; the scan records the true bounds
        s.column_stats["rk"] = (0, 2000)
        tpujoin.reset_routes()
        before = SYNCS.total()
        got = df.collect_batches()
        assert SYNCS.total() - before == syncs
        assert tpujoin.ROUTES["dense"] == tpujoin.ROUTES["hash"] == 1
        cpu = (TpuSparkSession.builder().device("cpu")
               .config("spark.rapids.sql.enabled", False).get_or_create())
        want[how] = cpu.create_dataframe(left).join(
            cpu.create_dataframe(right), left_on="lk", right_on="rk",
            how=how).collect()
        got = pd.concat([b.to_pandas() for b in got], ignore_index=True)
        assert _rows(got) == _rows(want[how])


def test_dense_route_stale_bounds_under_speculation():
    """The same stale bounds at the default confs: the warm run speculates
    the dense route's flag with the cached sizes, the one
    ``speculation.verify`` fetch finds it false, and the query re-executes
    once without speculation (the failed verification with its totals,
    then the totals again for the expanding join; the verification alone
    for the semi join); the answer is exact."""
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"lk": rng.integers(0, 5000, 800)})
    right = pd.DataFrame({"rk": rng.integers(0, 5000, 300),
                          "rv": rng.integers(0, 9, 300)})
    s = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .get_or_create())
    cpu = (TpuSparkSession.builder().device("cpu")
           .config("spark.rapids.sql.enabled", False).get_or_create())
    for how, rerun in (("inner", {"join.expandTotals": 2}),
                       ("leftsemi", {"join.denseVerify": 1})):
        df = s.create_dataframe(left).join(s.create_dataframe(right),
                                           left_on="lk", right_on="rk",
                                           how=how)
        df.collect()  # uploads; the scan records the true bounds
        s.column_stats["rk"] = (0, 2000)
        reruns = s.capacity_spec_reruns
        before = dict(SYNCS.syncs)
        got = df.collect_batches()
        grew = {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                if v != before.get(k, 0)}
        assert grew == dict(rerun, **{"speculation.verify": 1}), how
        assert s.capacity_spec_reruns == reruns + 1
        want = cpu.create_dataframe(left).join(
            cpu.create_dataframe(right), left_on="lk", right_on="rk",
            how=how).collect()
        got = pd.concat([b.to_pandas() for b in got], ignore_index=True)
        assert _rows(got) == _rows(want)
