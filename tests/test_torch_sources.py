"""The port's file sources (``sql/sources.py``) against the JAX package's,
on the CPU: hive key discovery and type inference, the CSV and ORC
readers (through both sessions, equal column for column), ORC stripe
pruning, a scan whose format is off by conf (on the CPU with the JAX
package's reason), and the session's small methods ``count_rows``,
``active``, ``get_conf`` and ``reset_conf``.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu.sql import sources as RS
from spark_rapids_tpu_torch.columnar import dtype as dtmod
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import sources as S
from tests.querytest import assert_frames_equal

HIVE = "__HIVE_DEFAULT_PARTITION__"


def _port(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _frame(n: int = 400, seed: int = 21) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "q": rng.integers(0, 50, n).astype(np.int64),
        "price": np.round(rng.random(n) * 1000, 2),
        "flag": rng.random(n) < 0.3,
        "name": [f"Customer#{i:09d}" for i in range(n)],
        "seg": rng.choice(["BUILDING", "MACHINERY", "HOUSEHOLD"], n),
    })


@pytest.mark.parametrize("texts", [
    ["1", "2", "30"], ["1", "2.5"], ["a", "1"], [HIVE, "4"], [HIVE],
    ["0.5", HIVE, "-3"], ["1e3", "2"], ["x=y", "z"]])
def test_partition_inference_matches_reference(texts):
    assert (S._partition_key_dtype(texts).name
            == RS._partition_key_dtype(texts).name)
    for t in texts:
        assert S._infer_partition_value(t) == RS._infer_partition_value(t)


def test_hive_discovery_matches_reference(tmp_path):
    for k, c in (("1", "a"), ("2", HIVE), (HIVE, "b")):
        d = tmp_path / f"k={k}" / f"c={c}"
        os.makedirs(d)
        pq.write_table(pa.table({"x": [1, 2]}), str(d / "p.parquet"))
        (d / "_SUCCESS").write_text("")
        (d / ".hidden.parquet").write_text("")
    (tmp_path / "notes.txt").write_text("")
    got = S._expand_paths([str(tmp_path)], ".parquet")
    assert got == RS._expand_paths([str(tmp_path)], ".parquet")
    assert len(got) == 3
    src, ref = S.ParquetSource([str(tmp_path)]), RS.ParquetSource(
        [str(tmp_path)])
    assert list(src.schema.names) == list(ref.schema.names)
    assert ([d.name for d in src.schema.dtypes]
            == [d.name for d in ref.schema.dtypes])
    assert src.splits == ref.splits
    assert src.split_rows() == [2, 2, 2]


@pytest.fixture
def csv_path(tmp_path):
    df = _frame()
    path = str(tmp_path / "c.csv")
    df.to_csv(path, index=False)
    return path, df


def test_csv_reader_matches_reference(session, csv_path):
    path, df = csv_path
    got = _port().read.csv(path).collect()
    session.set_conf("spark.rapids.sql.enabled", True)
    want = session.read.csv(path).collect()
    assert_frames_equal(got, want)
    assert_frames_equal(got, df)


def test_csv_reader_with_schema(session, csv_path):
    """An explicit schema names and types the columns (the first line the
    header, skipped)."""
    path, df = csv_path
    schema = Schema(list(df.columns),
                    [dtmod.INT64, dtmod.INT32, dtmod.FLOAT64, dtmod.BOOL,
                     dtmod.STRING, dtmod.STRING])
    s = _port()
    sdf = s.read.schema(schema).option("header", "true").csv(path)
    got = sdf.collect()
    assert sdf.schema == schema
    (batch,) = sdf.collect_batches()
    assert batch.columns[1].data.dtype.itemsize == 4
    assert_frames_equal(got, df)
    session.set_conf("spark.rapids.sql.enabled", True)
    from spark_rapids_tpu.columnar import dtypes as rdt
    from spark_rapids_tpu.columnar.batch import Schema as RSchema
    rschema = RSchema(list(df.columns),
                      [rdt.INT64, rdt.INT64, rdt.FLOAT64, rdt.BOOL,
                       rdt.STRING, rdt.STRING])
    want = session.read.schema(rschema).csv(path).collect()
    assert_frames_equal(got, want)
    headless = str(path) + ".nohead.csv"
    df.to_csv(headless, index=False, header=False)
    got2 = s.read.schema(schema).option("header", False).csv(
        headless).collect()
    assert_frames_equal(got2, df)


@pytest.fixture
def orc_path(tmp_path):
    n = 200_000
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"id": np.arange(n, dtype=np.int64),
                       "v": rng.random(n),
                       "s": rng.choice(["a", "b", "c"], n)})
    path = str(tmp_path / "t.orc")
    paorc.write_table(pa.Table.from_pandas(df), path,
                      stripe_size=256 * 1024)
    return str(tmp_path), path, df


def test_orc_reader_and_stripe_pruning_match_reference(session, orc_path):
    root, path, df = orc_path
    nstripes = paorc.ORCFile(path).nstripes
    assert nstripes > 2
    filters = [("id", "<", 1000)]
    src, ref = S.OrcSource([root]), RS.OrcSource([root])
    assert src.prune_splits(filters) == ref.prune_splits(filters)
    s = _port()
    got = s.read.orc(root).filter(F.col("id") < 1000).collect()
    ms = s.last_query_metrics[src.describe()]
    session.set_conf("spark.rapids.sql.enabled", True)
    want = session.read.orc(root).filter(RF.col("id") < 1000).collect()
    rms = session.last_query_metrics[ref.describe()]
    assert ms["numStripesPruned"] == rms["numStripesPruned"] >= nstripes - 2
    assert_frames_equal(got, want)
    assert_frames_equal(got, df[df.id < 1000].reset_index(drop=True))
    whole = s.read.orc(root).collect()
    assert_frames_equal(whole, df)


@pytest.mark.parametrize("fmt,key,reason", [
    ("parquet", "spark.rapids.sql.format.parquet.read.enabled",
     "Parquet scan disabled by conf"),
    ("csv", "spark.rapids.sql.format.csv.enabled",
     "CSV scan disabled by conf"),
    ("orc", "spark.rapids.sql.format.orc.read.enabled",
     "ORC scan disabled by conf")])
def test_scan_disabled_by_conf_stays_on_cpu(tmp_path, fmt, key, reason):
    df = _frame()
    s = _port(**{key: False, "spark.rapids.sql.test.enabled": False})
    getattr(_port().create_dataframe(df).write, fmt)(str(tmp_path / "f"))
    sdf = getattr(s.read, fmt)(str(tmp_path / "f"))
    assert reason in sdf.filter(F.col("q") < 10).explain()
    got = sdf.filter(F.col("q") < 10).collect()
    assert_frames_equal(got, df[df.q < 10].reset_index(drop=True))


def test_count_rows_active_and_confs(tmp_path):
    s = _port(**{"spark.rapids.sql.batchSizeRows": 1 << 12})
    assert TpuSparkSession.active() is s
    assert s.create_dataframe(_frame()).filter(
        F.col("q") < 10).count_rows() == int((_frame().q < 10).sum())
    assert s.get_conf("spark.rapids.sql.batchSizeRows") == 1 << 12
    assert s.get_conf("spark.rapids.sql.cacheDeviceScans") is False
    assert s.get_conf("no.such.key", 7) == 7
    s.set_conf("spark.rapids.sql.batchSizeRows", "128")
    assert s.get_conf("spark.rapids.sql.batchSizeRows") == 128
    s.reset_conf()
    assert s.get_conf("spark.rapids.sql.batchSizeRows") == 1 << 12
    s.stop()
    fresh = TpuSparkSession.active()
    assert fresh is not s and fresh.device == "cuda"
    t = _port()
    assert TpuSparkSession.active() is t
