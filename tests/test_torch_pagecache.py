"""The encoded-page cache of the port's device Parquet scan
(``memory/spill.EncodedPageCache``, wired in ``ops/parquet_decode.py``)
on the CPU: the JAX package's three page-cache tests run on the port (a
warm scan reads no file, a rewritten file is read anew, the host tier
evicts LRU-first and the device tier demotes), the device tier metered by
the session's budget and dropped, not spilled, under it, a warm scan that
uploads nothing, and an overwrite with values of the same length, without
a change of mtime, read back new.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.memory.spill import EncodedPageCache
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import assert_frames_equal
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401


def _metric(name):
    return REGISTRY.value(name)


def _port(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _read(s, path):
    return s.read.parquet(str(path)).collect()


def test_page_cache_warm_scan_no_file_reads(tmp_path, rng):
    """The warm scan reads no file byte: every column chunk's plan comes
    from the cache."""
    rows = 400
    df = pd.DataFrame({"i": np.arange(rows, dtype=np.int64),
                       "f": rng.random(rows)})
    p = tmp_path / "warm.parquet"
    df.to_parquet(str(p), row_group_size=100, index=False)
    s = _port(**{"spark.rapids.sql.cacheDeviceScans": False})
    first = _read(s, p)
    fr0 = _metric("scan.device.fileReads")
    frb0 = _metric("scan.device.fileReadBytes")
    hits0 = _metric("pagecache.hits")
    second = _read(s, p)
    assert _metric("scan.device.fileReads") == fr0
    assert _metric("scan.device.fileReadBytes") == frb0
    assert _metric("pagecache.hits") - hits0 == 8  # 4 row groups x 2
    assert_frames_equal(first, second)
    assert_frames_equal(second, df)


def test_page_cache_mtime_invalidation(tmp_path):
    """A rewritten file's cached pages are not served (its stamp rides
    the cache key): the next scan sees the new data."""
    p = tmp_path / "inv.parquet"
    pd.DataFrame({"i": np.arange(100, dtype=np.int64)}).to_parquet(
        str(p), row_group_size=50, index=False)
    s = _port()
    assert _read(s, p)["i"].tolist() == list(range(100))
    pd.DataFrame({"i": np.arange(100, 200, dtype=np.int64)}).to_parquet(
        str(p), row_group_size=50, index=False)
    os.utime(str(p), (1, 2_000_000_000))  # force a distinct mtime
    assert _read(s, p)["i"].tolist() == list(range(100, 200))


def test_page_cache_eviction_under_pressure():
    """The host tier's byte budget evicts LRU-first, the device tier
    demotes instead of evicting, and counters track both."""
    ev0 = _metric("pagecache.evictions")
    dm0 = _metric("pagecache.demotions")
    c = EncodedPageCache(max_bytes=1000, device_max_bytes=500)
    for k in range(10):
        c.put(("f", 0, 0, k), {"col": k}, 300)
    st = c.stats
    assert st["bytes"] <= 1000
    assert st["entries"] <= 3
    assert _metric("pagecache.evictions") > ev0
    assert c.get(("f", 0, 0, 0)) is None
    assert c.get(("f", 0, 0, 9)) is not None
    live = [k for k in range(10) if c.get(("f", 0, 0, k)) is not None]
    for k in live:
        c.promote(("f", 0, 0, k), {"dev": k}, 300)
    assert c.stats["deviceBytes"] <= 500
    assert _metric("pagecache.demotions") > dm0
    assert c.get_device(("f", 0, 0, live[-1])) is not None
    c.clear()
    assert c.stats["entries"] == 0


def _lineitem_like(tmp_path, rows=4000, rg=1000):
    rng = np.random.default_rng(8)
    df = pd.DataFrame({"k": np.arange(rows, dtype=np.int64),
                       "v": rng.random(rows),
                       "s": rng.choice(["AIR", "RAIL", "SHIP"], rows)})
    p = tmp_path / "t.parquet"
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), str(p),
                   row_group_size=rg)
    return p, df


def test_warm_scan_uploads_nothing(tmp_path):
    """A second execution whose row groups the device tier holds makes no
    upload and so no counted sync; a session with the cache off makes one
    a row group."""
    p, df = _lineitem_like(tmp_path)
    for enabled, want in ((True, 0), (False, 4)):
        s = _port(**{"spark.rapids.sql.scan.pageCache.enabled": enabled})
        q = s.read.parquet(str(p)).filter(F.col("v") < 2.0)
        first = q.collect()
        before = SYNCS.syncs.get("scan.upload", 0)
        second = q.collect()
        assert SYNCS.syncs.get("scan.upload", 0) - before == want
        assert_frames_equal(second, first)
        assert_frames_equal(second, df)
        assert (s.page_cache is not None) == enabled


def test_device_tier_metered_and_dropped_under_budget(tmp_path):
    """The device tier's bytes count against the session's budget; past
    the budget they are dropped (pagecache.drops), never spilled, the host
    tier keeps the plans, and the next scan reads no file and answers the
    same."""
    p, df = _lineitem_like(tmp_path)
    s = _port()
    dm = s.device_manager
    base = dm.allocated
    first = _read(s, p)
    dev = s.page_cache.stats["deviceBytes"]
    assert dev > 0 and dm.allocated - base >= dev
    drops0 = _metric("pagecache.drops")
    spills0 = _metric("spill.events")
    dm.hbm_budget = dm.allocated - dev // 2
    dm.track_alloc(1)
    dm.track_free(1)
    assert s.page_cache.stats["deviceBytes"] <= dev // 2
    assert _metric("pagecache.drops") > drops0
    assert _metric("spill.events") == spills0
    assert s.page_cache.stats["entries"] == 12  # 4 row groups x 3
    dm.hbm_budget = 1 << 40
    reads0 = _metric("scan.device.fileReads")
    assert_frames_equal(_read(s, p), first)
    assert _metric("scan.device.fileReads") == reads0
    s.stop()
    assert dm.allocated == base


def test_overwrite_of_equal_length_reads_new_values(tmp_path):
    """A file overwritten within one tick of the file system's clock, with
    values of the same length and no os.utime: the footer, statistics and
    page caches key on the inode too, so the new values are read, through
    the port's own overwrite and through a rename onto the path."""
    s = _port()
    target = tmp_path / "w"
    old = pd.DataFrame({"i": np.arange(64, dtype=np.int64)})
    new = pd.DataFrame({"i": np.arange(64, dtype=np.int64) + 1})
    s.create_dataframe(old).write.parquet(str(target))
    assert _read(s, target)["i"].tolist() == old.i.tolist()
    assert s.read.parquet(str(target)).filter(
        F.col("i") > 100).count_rows() == 0
    s.create_dataframe(new).write.mode("overwrite").parquet(str(target))
    assert _read(s, target)["i"].tolist() == new.i.tolist()
    f = tmp_path / "r.parquet"
    plain = {"compression": "NONE", "use_dictionary": False}
    pq.write_table(pa.table({"i": old.i.to_numpy()}), str(f), **plain)
    assert _read(s, f)["i"].tolist() == old.i.tolist()
    tmp = tmp_path / "r.tmp"
    pq.write_table(pa.table({"i": new.i.to_numpy()}), str(tmp), **plain)
    assert os.path.getsize(tmp) == os.path.getsize(f)
    os.replace(str(tmp), str(f))
    assert _read(s, f)["i"].tolist() == new.i.tolist()
    # a clock whose tick spans both writes: the replacement keeps the old
    # file's mtime to the nanosecond, and only its inode tells it apart
    stamp = os.stat(str(f)).st_mtime_ns
    pq.write_table(pa.table({"i": old.i.to_numpy()}), str(tmp), **plain)
    os.utime(str(tmp), ns=(stamp, stamp))
    os.replace(str(tmp), str(f))
    assert os.stat(str(f)).st_mtime_ns == stamp
    assert _read(s, f)["i"].tolist() == old.i.tolist()
