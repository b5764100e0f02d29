"""Statistics pushdown and split pruning of the port (``sql/pushdown.py``,
``ParquetSource.prune_splits``) against the JAX package's, on the CPU.

``extract_pushable_filters`` gives the JAX package's tuples over a table
of conditions; ``maybe_matches`` and ``partition_value_matches`` agree with
its functions on random statistics (hypothesis); ``prune_splits`` keeps
the JAX package's (path, row group, partition values) splits on a file of
four row groups with disjoint id ranges and string statistics, and on a
hive layout of int, float, string and ``__HIVE_DEFAULT_PARTITION__``
values. Pruned queries equal pandas over the whole files and the JAX
session, with its pruned counts. A date filter prunes in the port only
(the JAX package never prunes on a date). The scan cache and the reuse
fingerprint keep two filters of one source apart.
"""

import datetime
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu.sql import pushdown as RP
from spark_rapids_tpu.sql.sources import ParquetSource as RefParquetSource
from spark_rapids_tpu_torch.exec.base import plan_fingerprint
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import pushdown as P
from spark_rapids_tpu_torch.sql.sources import ParquetSource
from tests.querytest import assert_frames_equal

N = 10_000
RG = 2_500
HIVE = "__HIVE_DEFAULT_PARTITION__"
# (k, f, c) directory values of the hive layout
LAYOUT = [("1", "0.5", "a"), ("2", "1.5", "b"), (HIVE, "2", "a"),
          ("3", HIVE, HIVE)]


def _conditions(f):
    """Conditions over the columns of ``_flat``, in either package's
    functions module ``f``."""
    col, d0 = f.col, datetime.date(1995, 1, 1)
    return {
        "lt": col("id") < 2500,
        "range": (col("id") >= 4000) & (col("id") < 6000),
        "flipped": f.lit(5) > col("id"),
        "string_eq": col("s") == "s00001",
        "isnull": col("v").isNull(),
        "isnotnull": col("v").isNotNull(),
        "isin_null": col("id").isin(1, 2, None),
        "or": (col("id") > 5) | (col("id") < 2),
        "date": col("d") >= d0,
        "neq_and_le": (col("id") != 3) & (col("s") <= "s5"),
        "computed": col("id") + 1 > 5,
        "not": ~(col("id") > 3),
        "three": (col("id") > 1) & ((col("v") < 0.5) & col("s").isNotNull()),
    }


@pytest.mark.parametrize("name", list(_conditions(F)))
def test_extract_pushable_filters_matches_reference(name):
    got = P.extract_pushable_filters(_conditions(F)[name].expr)
    want = RP.extract_pushable_filters(_conditions(RF)[name].expr)
    assert got == want
    assert [repr(g) for g in got] == [repr(w) for w in want] or name == \
        "date"


_OPS = ["<", "<=", ">", ">=", "==", "!=", "isnull", "isnotnull", "in"]


def _stats(values):
    return st.tuples(values, values).map(sorted)


@settings(max_examples=150, deadline=None, database=None)
@given(bounds=st.one_of(_stats(st.integers(-50, 50)),
                        _stats(st.floats(-5, 5, allow_nan=False)),
                        _stats(st.text("abc", max_size=3)),
                        st.just([None, None])),
       nulls=st.one_of(st.none(), st.integers(0, 3)),
       nvals=st.one_of(st.none(), st.integers(0, 3)),
       op=st.sampled_from(_OPS),
       value=st.one_of(st.integers(-60, 60), st.floats(-6, 6, allow_nan=False),
                       st.text("abc", max_size=3)))
def test_maybe_matches_agrees_with_reference(bounds, nulls, nvals, op,
                                             value):
    mn, mx = bounds
    if op == "in":
        value = (value,)
    assert (P.maybe_matches(mn, mx, nulls, nvals, op, value)
            == RP.maybe_matches(mn, mx, nulls, nvals, op, value))


@settings(max_examples=150, deadline=None, database=None)
@given(pval=st.one_of(st.none(), st.integers(-5, 5),
                      st.floats(-5, 5, allow_nan=False),
                      st.text("ab1", max_size=3)),
       op=st.sampled_from(_OPS),
       value=st.one_of(st.integers(-6, 6), st.floats(-6, 6, allow_nan=False),
                       st.text("ab1", max_size=3)))
def test_partition_value_matches_agrees_with_reference(pval, op, value):
    if op == "in":
        value = (value, 3)
    assert (P.partition_value_matches(pval, op, value)
            == RP.partition_value_matches(pval, op, value))


@settings(max_examples=100, deadline=None, database=None)
@given(days=st.lists(st.integers(0, 20000), min_size=1, max_size=6),
       op=st.sampled_from(["<", "<=", ">", ">=", "==", "!="]),
       value=st.integers(0, 20000), timestamp=st.booleans())
def test_date_statistics_prune_soundly(days, op, value, timestamp):
    """A date or timestamp split is pruned only where none of its values
    satisfies the filter: the pushed day count against the footer's
    ``date`` (or ``datetime``, widened) statistics."""
    epoch = datetime.date(1970, 1, 1)
    vals = [epoch + datetime.timedelta(days=d) for d in days]
    if timestamp:
        vals = [datetime.datetime.combine(v, datetime.time()) for v in vals]
    lit = P.TemporalLiteral(value, "days")
    target = epoch + datetime.timedelta(days=value)
    cmp = {"<": np.less, "<=": np.less_equal, ">": np.greater,
           ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal}[op]
    kept = P.maybe_matches(min(vals), max(vals), 0, len(vals), op, lit)
    if any(cmp(d, value) for d in days):
        assert kept
    # exact against the min/max interval the statistics give
    lo, hi = min(days), max(days)
    want = {"<": lo < value, "<=": lo <= value, ">": hi > value,
            ">=": hi >= value, "==": lo <= value <= hi,
            "!=": not lo == hi == value}[op]
    assert kept == want, (min(vals), max(vals), op, target)


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    """Four row groups of 2,500 rows with disjoint id ranges, string and
    date statistics (sorted), NULLs in ``v`` of the third only."""
    rng = np.random.default_rng(12)
    ids = np.arange(N, dtype=np.int64)
    v = rng.random(N)
    vmask = (ids >= 2 * RG) & (ids < 3 * RG) & (rng.random(N) < 0.2)
    table = pa.table({
        "id": ids,
        "v": pa.array(v, mask=vmask),
        "s": pa.array([f"s{i:05d}" for i in ids]),
        "d": pa.array((8000 + ids // 4).astype("datetime64[D]"),
                      type=pa.date32()),
        "g": pa.array(ids % 97),
    })
    d = tmp_path_factory.mktemp("flat")
    pq.write_table(table, str(d / "t.parquet"), row_group_size=RG)
    return str(d), table.to_pandas()


@pytest.fixture(scope="module")
def hive(tmp_path_factory):
    root = tmp_path_factory.mktemp("hive")
    frames = []
    for j, (k, f, c) in enumerate(LAYOUT):
        sub = root / f"k={k}" / f"f={f}" / f"c={c}"
        os.makedirs(sub)
        x = np.arange(100, dtype=np.int64) + 1000 * j
        pq.write_table(pa.table({"x": x}), str(sub / "part.parquet"),
                       row_group_size=50)
        frames.append(pd.DataFrame({
            "x": x, "k": None if k == HIVE else int(k),
            "f": None if f == HIVE else float(f),
            "c": None if c == HIVE else c}))
    return str(root), pd.concat(frames, ignore_index=True)


FILTER_SETS = {
    "id_lt": [("id", "<", 2500)],
    "id_range": [("id", ">=", 4000), ("id", "<", 6000)],
    "s_eq": [("s", "==", "s00001")],
    "s_ge": [("s", ">=", "s07500")],
    "id_in": [("id", "in", (1, 9999))],
    "v_isnull": [("v", "isnull", None)],
    "v_isnotnull": [("v", "isnotnull", None)],
    "id_ne": [("id", "!=", 3)],
    "k_eq": [("k", "==", 1)],
    "k_isnull": [("k", "isnull", None)],
    "k_gt": [("k", ">", 1)],
    "f_le": [("f", "<=", 1.5)],
    "f_isnotnull": [("f", "isnotnull", None)],
    "c_eq": [("c", "==", "a")],
    "c_in": [("c", "in", ("b",))],
    "x_lt": [("x", "<", 50)],
    "missing": [("nope", "==", 1)],
    "mixed": [("k", ">=", 1), ("x", ">=", 1050)],
}


@pytest.mark.parametrize("name", list(FILTER_SETS))
def test_prune_splits_matches_reference(flat, hive, name):
    for root in (flat[0], hive[0]):
        got = ParquetSource([root]).prune_splits(FILTER_SETS[name])
        want = RefParquetSource([root]).prune_splits(FILTER_SETS[name])
        assert got == want, root


def test_hive_schema_matches_reference(hive):
    got, want = ParquetSource([hive[0]]), RefParquetSource([hive[0]])
    assert (list(got.schema.names) == list(want.schema.names)
            == ["x", "c", "f", "k"])
    assert ([d.name for d in got.schema.dtypes]
            == [d.name for d in want.schema.dtypes]
            == ["int64", "string", "float64", "int64"])


def _port(**conf):
    b = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.sql.test.enabled", True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _pruned(session, prefix="Parquet["):
    for op, ms in session.last_query_metrics.items():
        if op.startswith(prefix):
            return ms.get("numRowGroupsPruned", 0)
    return 0


QUERIES = {
    "flat_lt": ("flat", lambda f: f.col("id") < 2500, 3),
    "flat_range": ("flat", lambda f: (f.col("id") >= 4000)
                   & (f.col("id") < 6000), 2),
    "flat_string": ("flat", lambda f: f.col("s") == "s00001", 3),
    "flat_isnull": ("flat", lambda f: f.col("v").isNull(), 3),
    "hive_k": ("hive", lambda f: f.col("k") == 1, 6),
    "hive_c_null": ("hive", lambda f: f.col("c").isNull(), 6),
    "hive_f_x": ("hive", lambda f: (f.col("f") <= 1.5)
                 & (f.col("x") >= 1050), 7),
}


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("qname", list(QUERIES))
def test_pruned_query_matches_unpruned_and_reference(session, flat, hive,
                                                     qname, route):
    which, cond, pruned = QUERIES[qname]
    root, frame = {"flat": flat, "hive": hive}[which]
    conf = ({} if route == "device" else
            {"spark.rapids.sql.enabled": False,
             "spark.rapids.sql.test.enabled": False})
    s = _port(**conf)
    got = s.read.parquet(root).filter(cond(F)).collect()
    assert _pruned(s) == pruned
    # the JAX package's host route fails on a hive layout (its pandas
    # concat of frames whose dictionary hints differ), so a hive query
    # holds the port's host route to its device route
    session.set_conf("spark.rapids.sql.enabled",
                     route == "device" or which == "hive")
    want = session.read.parquet(root).filter(cond(RF)).collect()
    assert _pruned(session) == pruned
    assert_frames_equal(got, want, ignore_order=True)
    # unpruned: pandas over every row of the files
    rows = frame.query({
        "flat_lt": "id < 2500", "flat_range": "4000 <= id < 6000",
        "flat_string": "s == 's00001'", "flat_isnull": "v != v",
        "hive_k": "k == 1", "hive_c_null": "c != c",
        "hive_f_x": "f <= 1.5 and x >= 1050"}[qname])
    assert len(got) == len(rows) > 0
    key = "id" if which == "flat" else "x"
    assert sorted(got[key]) == sorted(rows[key])


def test_date_filter_prunes_in_the_port_only(session, flat):
    root, frame = flat
    cond = (lambda f: f.col("d") < datetime.date(1994, 1, 1))
    s = _port()
    got = s.read.parquet(root).filter(cond(F)).collect()
    cut = (datetime.date(1994, 1, 1) - datetime.date(1970, 1, 1)).days
    first_out = int(np.argmax(8000 + np.arange(N) // 4 >= cut))
    assert _pruned(s) == N // RG - -(-first_out // RG) > 0
    session.set_conf("spark.rapids.sql.enabled", True)
    want = session.read.parquet(root).filter(cond(RF)).collect()
    assert _pruned(session) == 0
    assert len(got) == first_out
    assert_frames_equal(got, want, ignore_order=True)


def _scans(plan):
    return [n for n in plan.walk() if n.name == "TpuScanExec"]


def test_scan_cache_and_fingerprint_keep_filters_apart(flat):
    """A self-join of one Parquet source under two filters, with cached
    device scans: the two scans differ only by their pushed filters, and
    neither the scan cache nor the reuse fingerprint lets one stand for
    the other, cold or warm."""
    root, frame = flat
    s = _port(**{"spark.rapids.sql.cacheDeviceScans": True,
                 "spark.rapids.sql.autoBroadcastJoinThreshold": -1})
    src = s.read.parquet(root)
    a = src.filter(F.col("id") < 2500).select("g", "id")
    b = src.filter(F.col("id") >= 7500).select(
        F.col("g").alias("g2"), F.col("id").alias("id2"))
    q = (a.join(b, left_on=["g"], right_on=["g2"])
         .agg(F.count("*").alias("n"), F.sum("id").alias("si"),
              F.sum("id2").alias("si2")))
    left = frame[frame.id < 2500][["g", "id"]]
    right = frame[frame.id >= 7500][["g", "id"]].rename(
        columns={"g": "g2", "id": "id2"})
    j = left.merge(right, left_on="g", right_on="g2")
    want = [len(j), int(j.id.sum()), int(j.id2.sum())]
    for _run in range(2):
        out = q.collect()
        assert [int(out.n[0]), int(out.si[0]), int(out.si2[0])] == want
    plan = s.physical_plan(q._plan)
    scans = _scans(plan)
    assert len(scans) == 2
    assert scans[0].pushed_filters != scans[1].pushed_filters
    assert (scans[0].fingerprint_extra() != scans[1].fingerprint_extra())
    assert plan_fingerprint(scans[0]) != plan_fingerprint(scans[1])
    keys = [k for k in s.device_scan_cache if k[3] is not None]
    assert len(keys) == 2
