"""The exchange's one-device routes (``exec/tpu.TpuShuffleExchangeExec``)
against the JAX package's, on the CPU.

The split: each batch, built in the JAX package from a seeded frame and
carried into the port in the same forms (``testing/reference
.batch_same_forms``), is split by the JAX package's partition kernel
(``_split_by_pid`` over its hash, round-robin or range ids) and by the
port's (``_split_to_slices``): the same rows land in the same partitions,
in the same order, for hash partitioning over integer keys and over
string keys as a dictionary, a char slab and plain chars, and for
round-robin; range partitioning over fixed-width keys gives the same
bounds (the JAX package's sampling, np.linspace rows of each batch) and
the same rows in each partition.

The session: a group-by, a join with a group-by, a global sort (in
order) and ``repartition(3)`` at a few thousand rows through the port's
session in test mode (no operator on the CPU) under the LOCAL buckets
route (``localCollapse=false``) and under the shuffle manager with two
executors over ``inprocess`` and ``socket``, each against the JAX
session; no transient buffer, registered shuffle or block survives a
query. ``repartition(4).write.parquet`` writes 4 files; under a 64 KiB
budget the buckets spill at ``OUTPUT_FOR_READ`` and fault back; a
consumed partition raises on a second read; TPC-H Q2, Q11, Q15 and Q17,
whose shared subtrees replay (``exec/reuse.py``), read each bucket once
and equal their references.
"""

import glob

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.columnar.batch import DeviceBatch as JBatch
from spark_rapids_tpu.exec.tpu import TpuShuffleExchangeExec as JExchange
from spark_rapids_tpu.parallel.distributed import (
    pick_bounds_from_samples as jax_pick_bounds,
)
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.exec.tpu import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.reference import batch_same_forms
from tests.querytest import assert_frames_equal, with_tpu_session
from tests.test_torch_shuffle_wire import with_slab
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N_PARTS = 5


def frame(n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    names = np.array(["grp%d" % g for g in rng.integers(0, 12, n)],
                     dtype=object)
    names[rng.random(n) < 0.1] = None
    long = np.array(["w%d-%s" % (i % 97, "y" * int(i % 80))
                     for i in range(n)], dtype=object)
    return pd.DataFrame({
        "k": pd.Series(rng.integers(0, 40, n)).astype("Int64")
        .mask(pd.Series(rng.random(n) < 0.05)),
        "name": pd.Series(names),
        "p": pd.Series(long),
        "v": rng.random(n) * 100.0,
    })


def same_rows(got: pd.DataFrame, want: pd.DataFrame, what: str) -> None:
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), (what, len(got), len(want))
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.isna().tolist() == w.isna().tolist(), (what, c)
        assert ([v for v in g if not pd.isna(v)]
                == [v for v in w if not pd.isna(v)]), (what, c)


def jax_slices(jbatch, jex, bounds=None):
    """{pid: rows} of the JAX package's split, in its order."""
    sorted_b, counts = (jex._pkernel(jbatch) if bounds is None
                        else jex._pkernel(jbatch, bounds))
    rows = sorted_b.to_pandas()
    counts = np.asarray(counts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return {pid: rows.iloc[starts[pid]:starts[pid + 1]]
            .reset_index(drop=True)
            for pid in range(len(counts)) if counts[pid]}


def port_slices(batch, ex, bounds=None):
    return {pid: piece.to_pandas()
            for _bi, pid, piece in ex._split_to_slices([batch], bounds, 2.0)}


def split_cases():
    base = JBatch.from_pandas(frame(700, 1))
    slab = with_slab(JBatch.from_pandas(frame(700, 1).assign(
        p=lambda f: f.p.str[:20])), "p")
    assert base.columns[1].dict_values is not None
    assert base.columns[2].dict_values is None and not base.columns[2].has_slab
    assert slab.columns[2].has_slab
    return {"hash_int": (base, ("hash", [0], N_PARTS)),
            "hash_int_and_dict": (base, ("hash", [0, 1], N_PARTS)),
            "hash_dict": (base, ("hash", [1], N_PARTS)),
            "hash_plain": (base, ("hash", [2], N_PARTS)),
            "hash_slab": (slab, ("hash", [2], N_PARTS)),
            "roundrobin": (base, ("roundrobin", N_PARTS))}


SPLIT_CASES = split_cases()


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_matches_the_jax_package(name):
    jbatch, partitioning = SPLIT_CASES[name]
    want = jax_slices(jbatch, JExchange(None, partitioning))
    got = port_slices(batch_same_forms(jbatch),
                      TpuShuffleExchangeExec(None, partitioning))
    assert sorted(got) == sorted(want)
    for pid in want:
        same_rows(got[pid], want[pid], f"{name} partition {pid}")


def jax_range_bounds(jex, batches, n):
    """The JAX package's range bounds: each batch's sampled operands
    (``np.linspace`` rows), then ``pick_bounds_from_samples``."""
    samples, k = [], None
    for b in batches:
        rows = int(np.asarray(b.num_rows))
        ops = np.asarray(jex._sample_kernel(b))
        k = ops.shape[0]
        if rows == 0:
            continue
        take = min(rows, 128)
        samples.append(ops[:, np.linspace(0, rows - 1, take)
                           .astype(np.int64)])
    return jax_pick_bounds(samples, k, n)


def test_range_split_matches_the_jax_package():
    """Bounds over three batches (one of 40 rows, below the 128 samples)
    of a nullable integer key descending and a float ascending; every
    batch's partitions hold the same rows as the JAX package's."""
    partitioning = ("range", [0, 3], [False, True], [False, True], N_PARTS)
    jex = JExchange(None, partitioning)
    ex = TpuShuffleExchangeExec(None, partitioning)
    jbatches = [JBatch.from_pandas(frame(n, s))
                for n, s in ((900, 3), (40, 4), (1500, 5))]
    pbatches = [batch_same_forms(b) for b in jbatches]
    want = jax_range_bounds(jex, jbatches, N_PARTS)
    got = ex._range_bounds(pbatches, pbatches[0].schema, "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint64), w)
    jbounds = tuple(jnp.asarray(w) for w in want)
    for jb, pb in zip(jbatches, pbatches):
        w = jax_slices(jb, jex, jbounds)
        g = port_slices(pb, ex, got)
        assert sorted(g) == sorted(w)
        for pid in w:
            same_rows(g[pid], w[pid], f"range partition {pid}")


ROUTES = {
    "buckets": {"spark.rapids.sql.shuffle.localCollapse": False},
    "inprocess": {"spark.rapids.shuffle.transport.enabled": True,
                  "spark.rapids.shuffle.executors": 2},
    "socket": {"spark.rapids.shuffle.transport.enabled": True,
               "spark.rapids.shuffle.executors": 2,
               "spark.rapids.shuffle.transport.class": "socket",
               "spark.rapids.shuffle.bounceBuffers.size": 16384},
}
NO_BROADCAST = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1}


def left_right():
    left = frame(4000, 7)
    right = pd.DataFrame({"k": np.arange(40, dtype=np.int64),
                          "tag": ["t%d" % i for i in range(40)]})
    return left, right


def session_queries(F_):
    """name -> (query over (session, left, right), ordered)."""
    return {
        "groupby": (lambda s, l, r: s.create_dataframe(l, 4).group_by("name")
                    .agg(F_.sum("v").alias("sv"), F_.count("*").alias("n")),
                    False),
        "join_groupby": (lambda s, l, r: s.create_dataframe(l, 3).join(
            s.create_dataframe(r, 2), on="k").group_by("tag").agg(
            F_.sum("v").alias("sv"), F_.count("*").alias("n")), False),
        "global_sort": (lambda s, l, r: s.create_dataframe(l, 3)
                        .select("k", "v", "name").order_by("v", "k"), True),
        "repartition": (lambda s, l, r: s.create_dataframe(l, 2)
                        .repartition(3), False),
    }


_JAX_ANSWERS: dict = {}


def jax_answer(qname: str) -> pd.DataFrame:
    if qname not in _JAX_ANSWERS:
        left, right = left_right()
        query, _ordered = session_queries(RF)[qname]
        _JAX_ANSWERS[qname] = with_tpu_session(
            lambda s: query(s, left, right),
            conf=dict(NO_BROADCAST, **{
                "spark.rapids.sql.shuffle.localCollapse": False}))
    return _JAX_ANSWERS[qname]


def port_session(**conf) -> TpuSparkSession:
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in dict(NO_BROADCAST, **conf).items():
        b.config(k, v)
    return b.get_or_create()


def left_over(s) -> dict:
    envs = s._shuffle_env or []
    return {"transients": len(s._transient_bids),
            "shuffles": len(s._active_shuffles),
            "blocks": sum(len(e.shuffle_catalog._blocks) for e in envs),
            "received": sum(len(e.received_catalog._received)
                            for e in envs),
            "catalog": len(s.buffer_catalog._buffers)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("qname", list(session_queries(F)))
def test_session_route_matches_the_jax_session(qname, route):
    left, right = left_right()
    query, ordered = session_queries(F)[qname]
    s = port_session(**ROUTES[route])
    try:
        df = query(s, left, right)
        assert not [n.name for n in s.physical_plan(df._plan).walk()
                    if n.name.startswith("Cpu")]
        got = df.collect()
        assert not any(left_over(s).values()), left_over(s)
        if route != "buckets":
            assert s._shuffle_id_counter > 0  # the manager ran
    finally:
        s.stop()
    assert_frames_equal(got, jax_answer(qname), ignore_order=not ordered,
                        approx=True)


def test_socket_route_moves_rows_over_the_wire():
    left, right = left_right()
    s = port_session(**ROUTES["socket"])
    try:
        session_queries(F)["join_groupby"][0](s, left, right).collect()
        stats = s.shuffle_envs[1].transport.stats
        assert stats["tagged_frames"] > 0 and stats["requests"] > 0, stats
    finally:
        s.stop()


def test_repartition_write_gives_one_file_a_partition(tmp_path):
    left, _ = left_right()
    s = port_session()
    try:
        s.create_dataframe(left, 2).repartition(4).write.parquet(
            str(tmp_path / "out"))
    finally:
        s.stop()
    files = sorted(glob.glob(str(tmp_path / "out" / "*.parquet")))
    counts = [pq.ParquetFile(f).metadata.num_rows for f in files]
    assert len(files) == 4 and sum(counts) == len(left)
    back = pq.read_table(str(tmp_path / "out")).to_pandas()
    assert_frames_equal(back[list(left.columns)], left, ignore_order=True)


def test_buckets_spill_and_fault_back(monkeypatch):
    """Under a 64 KiB budget the exchange's buckets (the OUTPUT_FOR_READ
    band, spilled first) leave the device and fault back, and the answer
    still equals the CPU operators'."""
    from spark_rapids_tpu_torch.memory import spill as spill_mod
    spilled = []
    real = spill_mod.DeviceStore.spill_one

    def record(store, buf):
        spilled.append(buf.priority)
        return real(store, buf)
    monkeypatch.setattr(spill_mod.DeviceStore, "spill_one", record)
    rng = np.random.default_rng(11)
    pdf = pd.DataFrame({"k": rng.integers(0, 50, 20000),
                        "v": rng.random(20000)})

    def q(s):
        return (s.create_dataframe(pdf, 4).repartition(6).group_by("k")
                .agg(F.sum("v").alias("sv"), F.count("*").alias("n")))
    cpu = port_session(**{"spark.rapids.sql.enabled": False})
    want = q(cpu).collect()
    cpu.stop()
    s = port_session(**{"spark.rapids.sql.cacheDeviceScans": False})
    try:
        s.device_manager.hbm_budget = 64 << 10
        got = q(s).collect()
        assert spill_mod.SpillPriorities.OUTPUT_FOR_READ in spilled, spilled
        assert not s._transient_bids
    finally:
        s.stop()
    assert_frames_equal(got, want, ignore_order=True, approx=True)


def test_a_consumed_partition_raises_on_a_second_read():
    from spark_rapids_tpu_torch.exec.base import ExecContext, PhysicalPlan
    left, _ = left_right()
    s = port_session()
    batch = s.create_dataframe(left).collect_batches()[0]

    class Source(PhysicalPlan):
        columnar_output = True

        def __init__(self):
            super().__init__([])

        def output_schema(self):
            return batch.schema

        def partitions(self, ctx):
            return [lambda: iter([batch])]
    ex = TpuShuffleExchangeExec(Source(), ("roundrobin", 3))
    ctx = ExecContext(s.conf, s, "cpu")
    s._exec_scope.ctx = ctx
    try:
        parts = ex.partitions(ctx)
        rows = [b.to_pandas() for p in parts for b in p()]
        assert sum(len(r) for r in rows) == len(left)
        with pytest.raises(RuntimeError, match="already consumed"):
            list(parts[0]())
    finally:
        s._exec_scope.ctx = None
        s.release_transient_buffers(ctx)
        s.stop()


@pytest.mark.parametrize("qname", ["q2", "q11", "q15", "q17"])
def test_shared_subtrees_read_each_bucket_once(qname):
    """The queries whose shared subtrees replay: under the buckets route
    each answer equals the collapse route's (and the pandas reference,
    where ``testing/tpchcases.py`` has one)."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.testing import tpchcases
    sf = 0.01
    fr = tpchcases.query_frames(qname, {n: f(sf) for n, f in
                                        G.ALL_TABLES.items()})
    answers = []
    for conf in ({}, ROUTES["buckets"]):
        s = port_session(**conf)
        try:
            got = tpch.QUERIES[qname](s, {n: s.create_dataframe(f)
                                          for n, f in fr.items()}).collect()
            assert not any(left_over(s).values())
        finally:
            s.stop()
        answers.append(got)
    order = tpchcases.ORDERS.get(qname)
    if order is not None:
        answers = [tpchcases.in_query_order(a, order) for a in answers]
    tpchcases.same_rows(answers[1], answers[0])
    if qname in tpchcases.ORDERS:
        want = tpchcases.pandas_reference(qname, fr)
        if order is not None:
            want = tpchcases.in_query_order(want, order)
        tpchcases.same_rows(answers[1], want)
    assert len(answers[1]) > 0
