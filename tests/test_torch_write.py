"""``DataFrame.write`` of the port (``exec/write.py``) against the JAX
package's, on the CPU.

One seeded frame holds every dtype the port uploads from pandas, with
NULLs, and a string column in each device form (a dictionary, a char slab,
plain chars and offsets past the 64-byte slab limit); a Parquet file adds
date32. Both sessions write it as Parquet, ORC and CSV, and pyarrow reads
both packages' files back as equal tables, schema included; each package
reads the other's files; the modes ``error`` and ``overwrite``, a
partitioned write with NULL keys (the same directories and metrics as the
JAX package's), a task that fails (abort: the target keeps only its
earlier files), the host route and a format turned off by conf. Files and
every column exact.
"""

import glob
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu_torch.exec import write as W
from spark_rapids_tpu_torch.session import TpuSparkSession
from tests.querytest import assert_frames_equal
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

ROWS = 300
FORMATS = ["parquet", "orc", "csv"]
READERS = {"parquet": pq.read_table, "orc": paorc.read_table,
           "csv": pacsv.read_csv}
METRICS = ("numFiles", "numOutputRows", "numOutputBytes", "numParts")


def _frame(n: int = ROWS, seed: int = 16) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "b": pd.array(rng.random(n) < 0.5, dtype="boolean"),
        "i8": pd.array(rng.integers(-100, 100, n), dtype="Int8"),
        "i16": pd.array(rng.integers(-1000, 1000, n), dtype="Int16"),
        "i32": pd.array(rng.integers(-10**6, 10**6, n), dtype="Int32"),
        "i64": pd.array(rng.integers(-10**12, 10**12, n), dtype="Int64"),
        "f32": pd.array(rng.random(n).astype(np.float32), dtype="Float32"),
        "f64": pd.array(rng.standard_normal(n), dtype="Float64"),
        "ts": pd.Series(pd.Timestamp("1995-01-01") + pd.to_timedelta(
            rng.integers(0, 10**9, n), unit="s")),
        "sd": pd.Series([None if i % 11 == 0 else f"k{i % 5}"
                         for i in range(n)], dtype=object),
        "ss": pd.Series([None if i % 13 == 0 else f"v{i:05d}-{rng.integers(9)}"
                         for i in range(n)], dtype=object),
        "sp": pd.Series([None if i % 17 == 0 else "p" * (i % 90) + str(i)
                         for i in range(n)], dtype=object),
    })
    for c in ("b", "i8", "i16", "i32", "i64", "f32", "f64"):
        df.loc[rng.random(n) < 0.1, c] = pd.NA
    df.loc[rng.random(n) < 0.1, "ts"] = pd.NaT
    return df


def _port(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


@pytest.fixture
def ref(session):
    session.set_conf("spark.rapids.sql.test.enabled", True)
    return session


def _files(path: str, fmt: str):
    return sorted(glob.glob(os.path.join(path, "**", f"*.{fmt}"),
                            recursive=True))


def _read_all(path: str, fmt: str) -> pa.Table:
    return pa.concat_tables([READERS[fmt](f) for f in _files(path, fmt)])


def _tree(path: str):
    return sorted(os.path.relpath(os.path.join(r, f), path)
                  for r, _d, fs in os.walk(path) for f in fs)


def _write_metrics(session, op_prefix: str) -> dict:
    for op, ms in session.last_query_metrics.items():
        if op.startswith(op_prefix):
            return {k: ms.get(k) for k in METRICS}
    raise AssertionError(f"no {op_prefix} metrics: "
                         f"{list(session.last_query_metrics)}")


def test_frame_uploads_each_string_form():
    """The frame's three string columns reach the write as a dictionary,
    a char slab and plain chars, so the writes below take each form."""
    (batch,) = _port().create_dataframe(_frame()).collect_batches()
    forms = {n: ("dict" if c.dict_values is not None else
                 "slab" if c.has_slab else "plain" if c.is_plain else "-")
             for n, c in zip(batch.schema.names, batch.columns)}
    assert (forms["sd"], forms["ss"], forms["sp"]) == ("dict", "slab",
                                                       "plain")


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_matches_reference(ref, tmp_path, fmt):
    df = _frame()
    s = _port()
    getattr(s.create_dataframe(df, 2).write, fmt)(str(tmp_path / "port"))
    getattr(ref.create_dataframe(df, 2).write, fmt)(str(tmp_path / "jax"))
    got, want = (_read_all(str(tmp_path / "port"), fmt),
                 _read_all(str(tmp_path / "jax"), fmt))
    assert got.schema == want.schema
    assert got.equals(want, check_metadata=True)
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    assert (_write_metrics(s, "TpuWriteExec")
            == _write_metrics(ref, "TpuWriteExec"))


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_each_package_reads_the_others_files(ref, tmp_path, fmt):
    df = _frame()
    s = _port()
    getattr(s.create_dataframe(df, 2).write, fmt)(str(tmp_path / "port"))
    getattr(ref.create_dataframe(df, 2).write, fmt)(str(tmp_path / "jax"))
    port_of_jax = getattr(s.read, fmt)(str(tmp_path / "jax")).collect()
    jax_of_port = getattr(ref.read, fmt)(str(tmp_path / "port")).collect()
    jax_of_jax = getattr(ref.read, fmt)(str(tmp_path / "jax")).collect()
    assert_frames_equal(port_of_jax, jax_of_jax)
    assert_frames_equal(jax_of_port, jax_of_jax)
    assert_frames_equal(port_of_jax, df)


def test_csv_files_read_the_same_by_both_packages(ref, tmp_path):
    df = _frame()
    _port().create_dataframe(df, 2).write.csv(str(tmp_path / "port"))
    got = _port().read.csv(str(tmp_path / "port")).collect()
    want = ref.read.csv(str(tmp_path / "port")).collect()
    assert_frames_equal(got, want)
    assert len(got) == len(df)


def test_date_column_round_trip_matches_reference(ref, tmp_path):
    """date32 comes in only from a file: a pyarrow-written file with a
    date32 and a timestamp column, read by each session and written
    again, gives equal tables."""
    rng = np.random.default_rng(3)
    days = rng.integers(8000, 11000, ROWS).astype("datetime64[D]")
    mask = rng.random(ROWS) < 0.1
    src = pa.table({"d": pa.array(days, type=pa.date32(), mask=mask),
                    "k": pa.array(np.arange(ROWS, dtype=np.int64))})
    pq.write_table(src, str(tmp_path / "src.parquet"), row_group_size=128)
    for fmt in ("parquet", "orc"):
        out_p, out_j = tmp_path / f"p_{fmt}", tmp_path / f"j_{fmt}"
        getattr(_port().read.parquet(str(tmp_path / "src.parquet")).write,
                fmt)(str(out_p))
        getattr(ref.read.parquet(str(tmp_path / "src.parquet")).write,
                fmt)(str(out_j))
        got, want = _read_all(str(out_p), fmt), _read_all(str(out_j), fmt)
        assert got.equals(want, check_metadata=True), fmt
        assert got.column("d").type == pa.date32()
        assert got.sort_by("k").column("d").equals(src.column("d"))


def test_modes_error_and_overwrite(ref, tmp_path):
    df = _frame()
    s = _port()
    for session, name in ((s, "port"), (ref, "jax")):
        target = str(tmp_path / name)
        session.create_dataframe(df, 2).write.parquet(target)
        with pytest.raises(FileExistsError):
            session.create_dataframe(df, 2).write.parquet(target)
        with pytest.raises(FileExistsError):
            session.create_dataframe(df, 2).write.mode(
                "errorifexists").parquet(target)
        head = df.head(50)
        session.create_dataframe(head).write.mode("overwrite").parquet(
            target)
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    got = _read_all(str(tmp_path / "port"), "parquet")
    assert got.equals(_read_all(str(tmp_path / "jax"), "parquet"))
    assert got.num_rows == 50
    with pytest.raises(ValueError):
        s.create_dataframe(df).write.mode("append")


def test_partitioned_write_matches_reference(ref, tmp_path):
    """partition_by two keys, one with NULLs: the same key=value
    directories (__HIVE_DEFAULT_PARTITION__ for NULL) and the same files,
    rows and partition count as the JAX package's; each package reads the
    layout back with the keys as columns."""
    df = _frame()
    s = _port()
    s.create_dataframe(df, 2).write.partition_by("sd", "b").parquet(
        str(tmp_path / "port"))
    ref.create_dataframe(df, 2).write.partitionBy("sd", "b").parquet(
        str(tmp_path / "jax"))
    tree = _tree(str(tmp_path / "port"))
    assert tree == _tree(str(tmp_path / "jax"))
    assert any("sd=__HIVE_DEFAULT_PARTITION__" in t for t in tree)
    pm = _write_metrics(s, "TpuWriteExec")
    assert pm == _write_metrics(ref, "TpuWriteExec")
    assert pm["numParts"] == 18 and pm["numOutputRows"] == ROWS
    for f in _files(str(tmp_path / "port"), "parquet"):
        rel = os.path.relpath(f, str(tmp_path / "port"))
        assert pq.read_table(f).equals(pq.read_table(
            os.path.join(str(tmp_path / "jax"), rel)))
    got = s.read.parquet(str(tmp_path / "port")).collect()
    want = ref.read.parquet(str(tmp_path / "jax")).collect()
    assert list(got.columns) == list(want.columns)
    assert_frames_equal(got, want, ignore_order=True)


def test_failing_task_aborts_and_keeps_earlier_files(tmp_path, monkeypatch):
    """The second task fails: the write raises after its abort, the
    staging tree is gone, and the target holds only its earlier files
    (an overwrite removes them only at its commit)."""
    df = _frame()
    s = _port()
    target = str(tmp_path / "t")
    s.create_dataframe(df.head(10)).write.parquet(target)
    before = {p: open(os.path.join(target, p), "rb").read()
              for p in _tree(target)}
    calls = {"n": 0}
    encode = W._encode_table

    def failing(table, f, fmt):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        encode(table, f, fmt)
    monkeypatch.setattr(W, "_encode_table", failing)
    with pytest.raises(OSError, match="disk full"):
        s.create_dataframe(df, 2).write.mode("overwrite").parquet(target)
    assert calls["n"] == 2
    assert {p: open(os.path.join(target, p), "rb").read()
            for p in _tree(target)} == before
    assert not os.path.exists(os.path.join(target, "_temporary"))
    fresh = str(tmp_path / "fresh")
    calls["n"] = 0
    with pytest.raises(OSError):
        s.create_dataframe(df, 2).write.parquet(fresh)
    assert _tree(fresh) == []


def test_host_route_writes_the_device_routes_tables(tmp_path):
    df = _frame()
    _port().create_dataframe(df, 2).write.parquet(str(tmp_path / "dev"))
    host = _port(**{"spark.rapids.sql.enabled": False,
                    "spark.rapids.sql.test.enabled": False})
    host.create_dataframe(df, 2).write.parquet(str(tmp_path / "host"))
    assert "CpuWriteExec" in str(host.last_query_metrics)
    assert _read_all(str(tmp_path / "host"), "parquet").equals(
        _read_all(str(tmp_path / "dev"), "parquet"))


def test_nan_is_written_as_nan(tmp_path):
    """A float NaN is a value, not NULL (the JAX package's write turns it
    into NULL)."""
    df = pd.DataFrame({"x": np.array([1.0, np.nan, 3.0])})
    _port().create_dataframe(df).write.parquet(str(tmp_path / "n"))
    col = _read_all(str(tmp_path / "n"), "parquet").column("x")
    assert col.null_count == 0 and np.isnan(col.to_numpy()[1])


@pytest.mark.parametrize("fmt,key", [
    ("parquet", "spark.rapids.sql.format.parquet.write.enabled"),
    ("orc", "spark.rapids.sql.format.orc.enabled"),
    ("csv", "spark.rapids.sql.format.csv.enabled")])
def test_write_disabled_by_conf_stays_on_cpu(tmp_path, fmt, key):
    """A write whose format is off stays on the CPU with the JAX
    package's reason, and writes the same files."""
    from spark_rapids_tpu_torch.sql import plan as lp
    from spark_rapids_tpu_torch.sql.overrides import TpuOverrides
    from spark_rapids_tpu_torch.sql.planner import Planner
    df = _frame()
    s = _port(**{key: False, "spark.rapids.sql.test.enabled": False})
    sdf = s.create_dataframe(df, 2)
    overrides = TpuOverrides(s.conf)
    overrides.apply(Planner(s.conf).plan(lp.LogicalWrite(
        sdf._plan, str(tmp_path / "x"), fmt, "error")))
    reason = {"parquet": "Parquet", "orc": "ORC", "csv": "CSV"}[fmt]
    assert (f"CpuWriteExec({fmt}, {tmp_path / 'x'})  <-- {reason} write "
            "disabled by conf") in overrides.explain_text()
    getattr(sdf.write, fmt)(str(tmp_path / "cpu"))
    assert "CpuWriteExec" in str(s.last_query_metrics)
    getattr(_port().create_dataframe(df, 2).write, fmt)(str(tmp_path / "d"))
    assert _read_all(str(tmp_path / "cpu"), fmt).equals(
        _read_all(str(tmp_path / "d"), fmt))


def test_parquet_dictionary_columns_never_overflow(tmp_path):
    """A column whose distinct values pass half of pyarrow's dictionary
    page limit is written PLAIN, so no chunk mixes dictionary and PLAIN
    pages and the device scan decodes every column of the file."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    n = 1 << 17
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"wide": rng.integers(0, 1 << 40, n),
                       "narrow": rng.integers(0, 7, n),
                       "text": [f"row {i}" for i in range(n)]})
    s = _port()
    s.create_dataframe(df).write.parquet(str(tmp_path / "w"))
    (f,) = _files(str(tmp_path / "w"), "parquet")
    encs = {pq.ParquetFile(f).metadata.row_group(0).column(i)
            .path_in_schema: pq.ParquetFile(f).metadata.row_group(0)
            .column(i).encodings for i in range(3)}
    assert "RLE_DICTIONARY" in encs["narrow"]
    assert "RLE_DICTIONARY" not in encs["wide"]
    assert "RLE_DICTIONARY" not in encs["text"]
    before = REGISTRY.value("scan.device.fallbackColumns")
    got = s.read.parquet(str(tmp_path / "w")).collect()
    assert REGISTRY.value("scan.device.fallbackColumns") == before
    assert_frames_equal(got, df)
