"""The ColumnarRdd export (``ml/columnar_rdd.py``) against the JAX
package's (``spark_rapids_tpu/ml/columnar_rdd.py``), on the CPU.

The three cases of ``tests/test_ml_export.py`` run through both packages:
the conf gate, the device batches of a filtered frame and their feature
matrices (equal: the same float64 values cast to float32), and the
refusal of a plan that ends on the CPU. The Mortgage ETL at SF 0.02 (480
rows) goes through both packages' export: live rows by key, integer
columns exact, floats at rtol 1e-6 (``testing/exportcheck.py``), and
against the port's own collect. A generator dropped half-read leaves the
task semaphore free; a string column is no feature.
"""

import gc

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.ml import ColumnarRdd as RefColumnarRdd
from spark_rapids_tpu.ml.columnar_rdd import (
    to_feature_matrix as ref_to_feature_matrix,
)
from spark_rapids_tpu.models import mortgage as ref_mortgage
from spark_rapids_tpu.session import TpuSparkSession as RefSession
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.ml import ColumnarRdd
from spark_rapids_tpu_torch.ml.columnar_rdd import to_feature_matrix
from spark_rapids_tpu_torch.models import mortgage
from spark_rapids_tpu_torch.models import mortgage_data as D
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing import exportcheck as X
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

EXPORT = {"spark.rapids.sql.exportColumnarRdd": True}
ETL_SF = 0.02


def _frame():
    return pd.DataFrame({
        "f1": np.linspace(0, 1, 64),
        "f2": np.linspace(2, 3, 64),
        "label": (np.arange(64) % 2).astype(np.float64),
    })


def _port(**conf):
    b = TpuSparkSession.builder().device("cpu")
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


@pytest.fixture
def ref():
    """The JAX package's session with the given confs, restored after."""
    s = RefSession.active()
    saved = dict(s.conf._settings)

    def with_conf(**conf):
        for k, v in conf.items():
            s.set_conf(k, v)
        return s
    yield with_conf
    s.conf._settings = saved
    # the JAX package's export leaves the spillables it registered outside
    # a query (a broadcast join's build side) in the session: free them
    s.release_transient_buffers()


def test_export_requires_conf(ref):
    s = _port(**{"spark.rapids.sql.exportColumnarRdd": False})
    with pytest.raises(RuntimeError, match="exportColumnarRdd"):
        ColumnarRdd.convert(s.create_dataframe(_frame(), 2))
    rs = ref(**{"spark.rapids.sql.enabled": True,
                "spark.rapids.sql.exportColumnarRdd": False})
    with pytest.raises(RuntimeError, match="exportColumnarRdd"):
        RefColumnarRdd.convert(rs.create_dataframe(_frame(), 2))
    s = _port(**EXPORT, **{"spark.rapids.sql.enabled": False})
    with pytest.raises(RuntimeError, match="spark.rapids.sql.enabled"):
        ColumnarRdd.convert(s.create_dataframe(_frame(), 2))


def _matrices(parts, to_matrix):
    out = []
    for p in parts:
        for batch in p():
            x, y, mask = to_matrix(batch, ["f1", "f2"], "label")
            m = np.asarray(mask)
            out.append((np.asarray(x)[m], np.asarray(y)[m]))
    return out


def test_export_yields_device_batches(ref):
    import torch
    s = _port(**EXPORT)
    parts = ColumnarRdd.convert(s.create_dataframe(_frame(), 2).filter(
        F.col("f1") > 0.25))
    assert len(parts) == 2
    total = 0
    for p in parts:
        for batch in p():
            # tensors on the session's device, no pandas anywhere
            assert isinstance(batch.columns[0].data, torch.Tensor)
            x, y, mask = to_feature_matrix(batch, ["f1", "f2"], "label")
            assert x.dtype == torch.float32 and x.shape[1] == 2
            assert x.device == batch.device == mask.device == y.device
            total += int(mask.sum())
    expected = int((np.linspace(0, 1, 64) > 0.25).sum())
    assert total == expected
    got = _matrices(ColumnarRdd.convert(s.create_dataframe(
        _frame(), 2).filter(F.col("f1") > 0.25)), to_feature_matrix)
    rs = ref(**EXPORT, **{"spark.rapids.sql.enabled": True})
    want = _matrices(RefColumnarRdd.convert(rs.create_dataframe(
        _frame(), 2).filter(RF.col("f1") > 0.25)), ref_to_feature_matrix)
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_export_rejects_cpu_tail(ref):
    pdf = pd.DataFrame({"s": ["ab", "cd"], "v": [1.0, 2.0]})
    s = _port(**EXPORT)
    df = s.create_dataframe(pdf, 1).select(
        F.regexp_replace("s", "[ab]+", "_").alias("r"))
    with pytest.raises(RuntimeError, match="device->host"):
        ColumnarRdd.convert(df)
    rs = ref(**EXPORT, **{"spark.rapids.sql.enabled": True})
    rdf = rs.create_dataframe(pdf, 1).select(
        RF.regexp_replace("s", "[ab]+", "_").alias("r"))
    with pytest.raises(RuntimeError, match="device->host"):
        RefColumnarRdd.convert(rdf)


def _ref_live_rows(parts):
    """The JAX export's live rows as ``exportcheck.live_rows`` gives the
    port's."""
    rows = {n: [] for n in ("x", "y", "keys", "valid", "y_valid")}
    for p in parts:
        for batch in p():
            x, y, mask = ref_to_feature_matrix(batch, X.ETL_FEATURES,
                                               X.ETL_LABEL)
            m = np.asarray(mask)
            rows["x"].append(np.asarray(x)[m])
            rows["y"].append(np.asarray(y)[m])
            rows["keys"].append(np.stack(
                [np.asarray(batch.column(k).data).astype(np.int64)[m]
                 for k in X.ETL_KEYS], axis=1))
            rows["valid"].append(np.stack(
                [np.asarray(batch.column(n).validity)[m]
                 for n in X.ETL_FEATURES], axis=1))
            rows["y_valid"].append(
                np.asarray(batch.column(X.ETL_LABEL).validity)[m])
    return {n: np.concatenate(v) for n, v in rows.items()}


def _same_live_rows(got, want):
    """Two exports' live rows, by key: keys, validity and integer columns
    exact, floats at rtol 1e-6 where valid."""
    go = np.lexsort(got["keys"].T[::-1])
    wo = np.lexsort(want["keys"].T[::-1])
    np.testing.assert_array_equal(got["keys"][go], want["keys"][wo])
    np.testing.assert_array_equal(got["valid"][go], want["valid"][wo])
    np.testing.assert_array_equal(got["y_valid"][go], want["y_valid"][wo])
    valid = got["valid"][go]
    np.testing.assert_allclose(np.where(valid, got["x"][go], 0),
                               np.where(valid, want["x"][wo], 0),
                               rtol=X.F32_RTOL)
    np.testing.assert_array_equal(got["y"][go], want["y"][wo])


def test_mortgage_etl_export_matches_jax_package_and_collect(ref):
    perf, acq = D.gen_performance(ETL_SF), D.gen_acquisition(ETL_SF)
    s = _port(**EXPORT, **mortgage.ETL_CONFS,
              **{"spark.rapids.sql.test.enabled": True})
    df = mortgage.run_etl(s, s.create_dataframe(perf, 3),
                          s.create_dataframe(acq, 2))
    got = X.live_rows(X.drain(ColumnarRdd.convert(df)))
    assert len(got["keys"]) == 480
    X.same_rows(got, df.collect())
    rs = ref(**EXPORT, **mortgage.ETL_CONFS,
             **{"spark.rapids.sql.enabled": True,
                "spark.rapids.sql.test.enabled": True})
    rdf = ref_mortgage.run_etl(rs, rs.create_dataframe(perf, 3),
                               rs.create_dataframe(acq, 2))
    _same_live_rows(got, _ref_live_rows(RefColumnarRdd.convert(rdf)))


def test_dropped_generator_frees_the_semaphore():
    s = _port(**EXPORT, **{"spark.rapids.sql.batchSizeRows": 8})
    parts = ColumnarRdd.convert(s.create_dataframe(_frame(), 2).filter(
        F.col("f1") > 0.25))
    assert s.semaphore.available_permits() == s.semaphore.permits
    it = parts[0]()
    next(it)  # the upload acquired the semaphore
    assert s.semaphore.available_permits() == s.semaphore.permits - 1
    it.close()  # dropped half-read
    assert s.semaphore.available_permits() == s.semaphore.permits
    it = parts[1]()
    next(it)
    del it
    gc.collect()
    assert s.semaphore.available_permits() == s.semaphore.permits


def test_transients_are_released_once_every_partition_ended():
    """A broadcast join's build side is a per-query transient in the
    session's spill catalog: the export frees it once both partitions
    ended, and no cancellation scope applies outside a served job."""
    s = _port(**EXPORT)
    small = pd.DataFrame({"k": np.arange(8), "w": np.arange(8) * 2.0})
    big = pd.DataFrame({"k": np.arange(64) % 8, "v": np.linspace(0, 1, 64)})
    df = s.create_dataframe(big, 2).join(s.create_dataframe(small, 1),
                                         on="k")
    def held():
        return len(s.buffer_catalog._buffers)
    before = held()
    parts = ColumnarRdd.convert(df)
    assert len(parts) == 2
    rows = sum(int(b.row_mask().sum()) for b in parts[0]())
    assert held() > before  # the build side, while a partition is open
    rows += sum(int(b.row_mask().sum()) for b in parts[1]())
    assert rows == 64
    assert held() == before


def test_string_column_is_no_feature():
    s = _port(**EXPORT)
    pdf = pd.DataFrame({"s": ["a", "b"], "v": [1.0, 2.0]})
    (part,) = ColumnarRdd.convert(s.create_dataframe(pdf, 1))
    for batch in part():
        with pytest.raises(TypeError, match="not a feature"):
            to_feature_matrix(batch, ["s"], "v")
