"""Parquet files through the port's ``TpuSparkSession`` against the JAX
package's session and pandas, on the CPU.

``tpch_data.write_parquet`` at SF 0.005 writes lineitem, orders and
customer (multi-page column chunks, one row group a file), and once more
in row groups of 4096 rows, read with 2^13-row batches: the scan packs
two row groups a partition and the coalesce above it concatenates them,
merging their dictionaries. Q1, Q3, Q4, Q6, the Q18 group-by (with and
without its filter) and the customer collect run through
``s.read.parquet`` on the device scan (the kernels' plain versions of
B5-B8, no column decoded on the host) and on the host route
(``spark.rapids.sql.enabled=false``: ``CpuScanExec`` reads each row group
with pyarrow), against the JAX package's session with
``spark.rapids.sql.scan.deviceDecode=false`` (its device decode is wrong
in two places, ROADMAP C) and against pandas. Keys, counts, dates and
strings exact, float64 at rtol 1e-9, group-bys by key.
"""

import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import parquet_raw as praw
from tests.querytest import with_tpu_session
from tests.test_torch_joins import _assert_ordered, _pandas_q3, _pandas_q4
from tests.test_torch_session import _assert_same, _pandas

SF = 0.005
SMALL_RG = 4096
LAYOUTS = {"row_group_per_file": {},
           "small_row_groups": {"spark.rapids.sql.batchSizeRows": 1 << 13}}
QUERIES = ["q1", "q3", "q4", "q6", "q18_groupby", "q18_groupby_all",
           "customer"]
FALLBACK = "scan.device.fallbackColumns"


@pytest.fixture(scope="module")
def frames():
    return {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
            "customer": G.gen_customer(SF)}


@pytest.fixture(scope="module")
def files(tmp_path_factory, frames):
    out = {"row_group_per_file": G.write_parquet(
        str(tmp_path_factory.mktemp("pq")), SF, frames=frames)}
    saved = G.ROW_GROUP_ROWS
    G.ROW_GROUP_ROWS = SMALL_RG
    try:
        out["small_row_groups"] = G.write_parquet(
            str(tmp_path_factory.mktemp("pq_small")), SF, frames=frames)
    finally:
        G.ROW_GROUP_ROWS = saved
    return out


def test_files_have_multi_page_chunks_and_row_groups(files):
    path = files["row_group_per_file"]["lineitem"]
    md = praw.file_metadata(path)
    assert md.num_row_groups == 1
    ci = md.schema.names.index("l_orderkey")
    assert len(praw.read_column_chunk(path, 0, ci).pages) > 1
    small = praw.file_metadata(files["small_row_groups"]["lineitem"])
    assert small.num_row_groups == -(-len(G.gen_lineitem(SF)) // SMALL_RG)


def _port_query(qname):
    if qname == "q18_groupby_all":
        return lambda s, t: (t["lineitem"].group_by("l_orderkey")
                             .agg(F.sum("l_quantity").alias("sum_qty")))
    if qname == "customer":
        return tpch.customer_segment
    return tpch.QUERIES[qname]


def _ref_query(qname):
    if qname.startswith("q18_groupby"):
        def q(s, t):
            g = (t["lineitem"].group_by("l_orderkey")
                 .agg(RF.sum("l_quantity").alias("sum_qty")))
            return g if qname.endswith("_all") else g.filter(
                RF.col("sum_qty") > 300)
        return q
    if qname == "customer":
        return lambda s, t: t["customer"].filter(
            RF.col("c_mktsegment") == "BUILDING")
    return ref_tpch.QUERIES[qname]


def _pandas_query(qname, fr):
    if qname == "q3":
        return _pandas_q3(fr).head(10)
    if qname == "q4":
        return _pandas_q4(fr)
    if qname == "customer":
        c = fr["customer"]
        return c[c.c_mktsegment == "BUILDING"].reset_index(drop=True)
    return _pandas(qname, fr["lineitem"])


def _check(qname, got, want):
    if qname == "q3":
        _assert_ordered(got, want[list(got.columns)],
                        ["revenue", "o_orderdate"])
        return
    keys = {"q1": ["l_returnflag", "l_linestatus"], "q4": ["o_orderpriority"],
            "q6": [], "q18_groupby": ["l_orderkey"],
            "q18_groupby_all": ["l_orderkey"],
            "customer": ["c_custkey"]}[qname]
    _assert_same(got, want.reset_index(drop=True), keys)


def _port_session(**conf):
    b = TpuSparkSession.builder().device("cpu")
    for k, v in dict(tpch.HASH_AGG_CONFS, **conf).items():
        b.config(k, v)
    return b.get_or_create()


def _read(s, paths):
    return {n: s.read.parquet(p) for n, p in paths.items()}


_REF_CACHE: dict = {}


def _ref(layout, qname, paths):
    key = (layout, qname)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = with_tpu_session(
            lambda rs: _ref_query(qname)(rs, _read(rs, paths)),
            conf=dict(tpch.HASH_AGG_CONFS, **{
                "spark.rapids.sql.scan.deviceDecode": False}))
    return _REF_CACHE[key]


ROUTES = {"device": {"spark.rapids.sql.test.enabled": True},
          "host": {"spark.rapids.sql.enabled": False}}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("qname", QUERIES)
def test_parquet_query_matches_reference_and_pandas(session, frames, files,
                                                    qname, layout, route):
    paths = files[layout]
    s = _port_session(**dict(LAYOUTS[layout], **ROUTES[route]))
    before = REGISTRY.values().get(FALLBACK, 0)
    got = _port_query(qname)(s, _read(s, paths)).collect()
    assert REGISTRY.values().get(FALLBACK, 0) == before
    want = _pandas_query(qname, frames)
    if qname != "q18_groupby":  # no order sums past 300 units at SF 0.005
        assert len(want) > 0
    _check(qname, got, want)
    _check(qname, got, _ref(layout, qname, paths))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_parquet_scan_packs_row_groups_and_coalesces(files, layout):
    """The scan packs row groups into partitions of at most batchSizeRows
    rows, and the coalesce above it makes one batch of each."""
    s = _port_session(**LAYOUTS[layout])
    li = s.read.parquet(files[layout]["lineitem"])
    batches = li.filter(F.col("l_quantity") < 1000.0).collect_batches()
    n = len(G.gen_lineitem(SF))
    rows = s.conf.batch_size_rows
    per = rows // SMALL_RG * SMALL_RG if layout == "small_row_groups" else n
    assert len(batches) == -(-n // per)
    assert sum(int(b.num_rows) for b in batches) == n


@pytest.mark.parametrize("qname", ["q1", "q3", "q4", "q6", "q18_groupby"])
def test_parquet_query_syncs(files, qname):
    """A second execution from the files with capacity speculation off:
    one counted sync a row group read (its upload), plus one a join that
    expands (Q3's two shuffled joins), as the query runners make, plus
    Q4's semi join's dense-route verification (the row groups' footer
    statistics bound l_orderkey), plus one ``exchange.shrink`` for each
    exchange over a partial or final aggregate (Q1, Q3 and Q4 two, Q6 and
    the Q18 group-by one). The encoded-page cache is off here: with it, a
    warm row group whose buffers the cache's device tier holds uploads
    nothing (``tests/test_torch_pagecache.py``).
    ``test_parquet_query_syncs_speculated`` holds the default confs."""
    paths = files["small_row_groups"]
    s = _port_session(**dict(LAYOUTS["small_row_groups"], **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.scan.pageCache.enabled": False,
        "spark.rapids.sql.adaptiveCapacity.enabled": False}))
    df = tpch.QUERIES[qname](s, _read(s, paths))
    df.collect_batches()  # learns the partial-skip decision
    tables = {"q1": ["lineitem"], "q6": ["lineitem"],
              "q18_groupby": ["lineitem"], "q4": ["orders", "lineitem"],
              "q3": ["customer", "orders", "lineitem"]}[qname]
    row_groups = sum(praw.file_metadata(paths[t]).num_row_groups
                     for t in tables)
    before = SYNCS.total()
    df.collect_batches()
    assert SYNCS.total() - before == row_groups + {"q3": 2, "q4": 1}.get(
        qname, 0) + SHRINKS[qname]


# exchanges over a partial or final aggregate, each one exchange.shrink
SHRINKS = {"q1": 2, "q3": 2, "q4": 2, "q6": 1, "q18_groupby": 1}


@pytest.mark.parametrize("qname", ["q1", "q3", "q4", "q6", "q18_groupby"])
def test_parquet_query_syncs_speculated(files, qname):
    """The default confs from the files: once the join sizes and the
    shrink counts are cached and proved stable, a warm execution makes
    one counted sync a row group read and one ``speculation.verify``."""
    paths = files["small_row_groups"]
    s = _port_session(**dict(LAYOUTS["small_row_groups"], **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
        "spark.rapids.sql.scan.pageCache.enabled": False}))
    df = tpch.QUERIES[qname](s, _read(s, paths))
    for _ in range(3):
        df.collect_batches()
    tables = {"q1": ["lineitem"], "q6": ["lineitem"],
              "q18_groupby": ["lineitem"], "q4": ["orders", "lineitem"],
              "q3": ["customer", "orders", "lineitem"]}[qname]
    row_groups = sum(praw.file_metadata(paths[t]).num_row_groups
                     for t in tables)
    before = dict(SYNCS.syncs)
    df.collect_batches()
    assert {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
            if v != before.get(k, 0)} == {"scan.upload": row_groups,
                                          "speculation.verify": 1}
    assert s.capacity_spec_reruns == 0


def test_parquet_scan_disabled_by_conf_stays_on_cpu(files):
    """With the scan's operator key off, the CPU scan reads the files and
    the device operators above it take its rows through a transition."""
    s = _port_session(**{"spark.rapids.sql.exec.ScanExec": False})
    df = tpch.q6(s, _read(s, files["row_group_per_file"]))
    assert ("CpuScanExec is disabled by conf spark.rapids.sql.exec.ScanExec"
            in df.explain())
    want = _pandas("q6", G.gen_lineitem(SF))
    _assert_same(df.collect(), want, [])
