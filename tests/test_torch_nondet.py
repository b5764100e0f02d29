"""rand, monotonically_increasing_id, spark_partition_id and
input_file_name through the port's ``TpuSparkSession`` on the CPU,
against the JAX package's session.

``rand(seed)`` is the JAX package's splitmix64 stream of (seed, partition,
row): bit-equal to it for the same partitions, whatever the batch split,
and the ids are Spark's layout. They run over four partitions of small
batches, directly over the scan and after a filter (whose batches the
device path counts in one ``nondet.rowBase`` sync each), in test mode
through the device operators and through the CPU operators.
``input_file_name()`` runs over a directory of three Parquet files of two
row groups each, with the scan's prefetch on, cold and replayed from the
device scan cache: every row carries the file it was read from.
A subtree holding rand() is never shared by the within-query reuse.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from tests.test_torch_exprs_tail import port_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 3000
BATCH = 256
FRAME = pd.DataFrame({
    "id": np.arange(N, dtype=np.int64),
    "k": np.random.default_rng(5).integers(0, 7, N).astype(np.int64),
})


def _ids(M, s, filtered: bool):
    df = s.create_dataframe(FRAME, 4)
    if filtered:
        df = df.filter(M.col("k") != 3)
    return df.select(M.col("id"),
                     M.monotonically_increasing_id().alias("mid"),
                     M.spark_partition_id().alias("pid"),
                     M.rand(42).alias("r42"), M.rand().alias("r0"))


def _bits(df: pd.DataFrame) -> pd.DataFrame:
    out = df.sort_values("id").reset_index(drop=True)
    for c in ("r42", "r0"):
        out[c] = out[c].to_numpy(np.float64).view(np.int64)
    return out


@pytest.mark.parametrize("filtered", [False, True])
def test_ids_and_rand_bit_equal_to_reference(filtered):
    conf = {"spark.rapids.sql.batchSizeRows": BATCH}
    want = _bits(with_tpu_session(lambda s: _ids(RF, s, filtered), conf))
    before = SYNCS.syncs.get("nondet.rowBase", 0)
    dev = _ids(F, port_session(**dict(conf, **{
        "spark.rapids.sql.test.enabled": True})), filtered).collect()
    synced = SYNCS.syncs.get("nondet.rowBase", 0) - before
    # an upload knows its rows on the host; a filter's batch does not
    assert (synced > 0) == filtered
    cpu = _ids(F, port_session(**dict(conf, **{
        "spark.rapids.sql.enabled": False})), filtered).collect()
    for got in (dev, cpu):
        pd.testing.assert_frame_equal(_bits(got), want, check_dtype=False)
    assert sorted(set(want.pid)) == [0, 1, 2, 3]
    assert (want.mid.to_numpy() >> 33).tolist() == want.pid.tolist()


def test_rand_does_not_depend_on_batch_size():
    outs = [_bits(_ids(F, port_session(**{
        "spark.rapids.sql.test.enabled": True,
        "spark.rapids.sql.batchSizeRows": b}), False).collect())
        for b in (64, 1 << 20)]
    pd.testing.assert_frame_equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("three_files")
    paths = []
    for i in range(3):
        ids = np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64)
        t = pa.table({"id": ids, "v": (ids * 7 % 13).astype(np.int32)})
        p = str(d / f"part-{i}.parquet")
        pq.write_table(t, p, row_group_size=500)
        paths.append(p)
    return paths


@pytest.mark.parametrize("mode", ["device", "cpu", "cached"])
def test_input_file_name_labels_each_row(mode, parquet_dir):
    conf = {"spark.rapids.sql.test.enabled": True}
    if mode == "cpu":
        conf = {"spark.rapids.sql.enabled": False}
    if mode == "cached":
        conf["spark.rapids.sql.cacheDeviceScans"] = True
    s = port_session(**conf)
    q = s.read.parquet(*parquet_dir).filter(F.col("v") != 5).select(
        F.col("id"), F.input_file_name().alias("f"))
    for _run in range(2 if mode == "cached" else 1):
        out = q.collect()
        assert len(out) > 2000
        want = [parquet_dir[i // 1000] for i in out.id]
        assert list(out.f) == want


def test_input_file_name_matches_reference(parquet_dir, session):
    session.set_conf("spark.rapids.sql.enabled", True)
    want = session.read.parquet(*parquet_dir).select(
        RF.col("id"), RF.input_file_name().alias("f")).collect()
    got = port_session(**{"spark.rapids.sql.test.enabled": True}).read \
        .parquet(*parquet_dir).select(
            F.col("id"), F.input_file_name().alias("f")).collect()
    pd.testing.assert_frame_equal(
        got.sort_values("id").reset_index(drop=True),
        want.sort_values("id").reset_index(drop=True), check_dtype=False)


def test_reuse_never_shares_a_nondeterministic_subtree():
    from spark_rapids_tpu_torch.exec.reuse import TpuReuseSubtreeExec
    s = port_session(**{"spark.rapids.sql.test.enabled": True})
    base = s.create_dataframe(FRAME, 2)

    def shared(col):
        agg = base.select(F.col("k"), col.alias("x")).group_by("k").agg(
            F.sum("x").alias("sx"))
        plan = s.physical_plan(agg.union(agg)._plan)
        return any(isinstance(n, TpuReuseSubtreeExec) for n in plan.walk())
    assert shared(F.col("id"))
    assert not shared(F.rand(1))
