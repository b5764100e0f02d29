"""The port's device Parquet scan against the JAX package, on the CPU.

  * Plan parity: both packages' ``prepare_rowgroup`` on the same files (the
    shapes of ``tests/test_parquet_decode.py`` and tiny TPC-H tables
    written with ``tpch_data.PARQUET_SPEC`` and with pyarrow's defaults):
    the same split type, fallback reasons, plan kinds, ``meta`` and upload
    arrays, exactly.
  * Kernel parity: the plain versions of B5-B8 against the JAX package's
    default jnp twins (``mode="jnp"``; not the Pallas interpret mode, whose
    ``slab_pack`` body needs ``pl.load``) on the same buffers, exactly.
  * Scan parity: the port's scan equals ``pq.read_table(p).to_pandas()``
    and the JAX session's ``read.parquet(p).collect()`` with
    ``spark.rapids.sql.scan.deviceDecode`` on.
  * Driver parity: the Parquet drivers at tiny SF against the JAX
    session's ``QUERIES`` over the same files (Q1, Q3, Q4, Q6) and pandas
    (the Q18 group-by, the customer collect).

The JAX package's device decode has two faults the port does not copy: a
page whose codec output is exactly as long as its input is parsed
compressed (``parquet_raw._decompress``), and the padding of a page's last
bit-packed run shifts every later page of a merged run table
(``parquet_raw.hybrid_run_table``). Columns they hit decode wrong in the
JAX package; there the port is held to pyarrow, and the two faults have
tests of their own.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.ops import pallas_kernels as ref_pk
from spark_rapids_tpu.ops import parquet_decode as ref_pd
from spark_rapids_tpu.sql import parquet_raw as ref_praw
from spark_rapids_tpu.sql.sources import ParquetSource as RefSource
from spark_rapids_tpu.models.tpch import QUERIES
from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
from spark_rapids_tpu_torch.models import q1_step as Q
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.models import tpch_joins as J
from spark_rapids_tpu_torch.models import tpch_scan as S
from spark_rapids_tpu_torch.obs.metrics import REGISTRY, delta
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import parquet_decode as PD
from spark_rapids_tpu_torch.sql import parquet_raw as praw
from spark_rapids_tpu_torch.sql.sources import ParquetSource
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

F64_RTOL = 1e-9
SF = 0.005  # 30,000 lineitem rows: two data pages per column chunk
BLOCKED = upload_blocked_chars()


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _write_files(d) -> dict:
    """{name: path}: the shapes of tests/test_parquet_decode.py plus tiny
    TPC-H tables with the port's encoding spec and with pyarrow's
    defaults."""
    rng = np.random.default_rng(42)
    out = {}

    def put(name, table, **kw):
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(table, out[name], **kw)

    rows = 600
    df = pd.DataFrame({
        "i": np.arange(rows, dtype=np.int64),
        "f": rng.random(rows),
        "b": (np.arange(rows) % 3 == 0),
        "s": [f"str{k % 13}" for k in range(rows)],
        "ni": pd.array([None if k % 7 == 0 else k for k in range(rows)],
                       dtype="Int64"),
        "ns": [None if k % 5 == 0 else f"v{k % 9}" for k in range(rows)],
    })
    out["types"] = str(d / "types.parquet")
    df.to_parquet(out["types"], row_group_size=50, index=False)
    rows = 500
    put("delta", pa.table({
        "d64": pa.array(np.cumsum(rng.integers(-50, 90, rows))
                        .astype(np.int64)),
        "d32": pa.array(rng.integers(-10000, 10000, rows).astype(np.int32)),
        "wrap": pa.array(np.where(np.arange(rows) % 2 == 0,
                                  np.iinfo(np.int32).max,
                                  np.iinfo(np.int32).min).astype(np.int32)),
    }), row_group_size=128, use_dictionary=False,
        column_encoding={"d64": "DELTA_BINARY_PACKED",
                         "d32": "DELTA_BINARY_PACKED",
                         "wrap": "DELTA_BINARY_PACKED"})
    rows = 300
    put("strings", pa.table({
        "s": pa.array([None if k % 11 == 0 else f"unique-{k}-{'x' * (k % 23)}"
                       for k in range(rows)]),
        "e": pa.array(["" if k % 2 else f"p{k}" for k in range(rows)]),
    }), row_group_size=100, use_dictionary=False)
    rows = 240
    out["timestamps"] = str(d / "timestamps.parquet")
    pd.DataFrame({
        "ts": pd.date_range("2021-03-01", periods=rows, freq="37min"),
        "i8": np.arange(rows, dtype=np.int8),
        "i16": (np.arange(rows) * 7 - 500).astype(np.int16),
    }).to_parquet(out["timestamps"], row_group_size=80, index=False)
    rows = 2000
    put("multipage", pa.table({
        "i": pa.array(rng.integers(0, 1 << 40, rows).astype(np.int64)),
        "s": pa.array([f"s{k % 7}" for k in range(rows)]),
        "ni": pa.array([None if k % 9 == 0 else k for k in range(rows)],
                       type=pa.int64()),
    }), row_group_size=1000, data_page_size=1024)
    allnull = pa.table({
        "an": pa.array([None] * 64, type=pa.int64()),
        "asn": pa.array([None] * 64, type=pa.string()),
        "i": pa.array(list(range(64)), type=pa.int32()),
    })
    put("allnull", allnull, row_group_size=32)
    put("empty", allnull.slice(0, 0))
    rows = 120
    put("bss", pa.table({
        "i": pa.array(np.arange(rows, dtype=np.int64)),
        "bss": pa.array(np.linspace(0.0, 1.0, rows)),
    }), use_dictionary=False,
        column_encoding={"i": "PLAIN", "bss": "BYTE_STREAM_SPLIT"})
    # one row group per part: the scan's dictionary for "s" is established,
    # remapped (a subset), reused, closed (a value outside it, too long for
    # the plan's slab), then rows ride the plan's slab
    out["dictladder"] = str(d / "dictladder.parquet")
    parts = [["a", "b", "c", "a", None], ["c", "a", "a"], ["b", "a", "c"],
             ["a", "z" * 70, None], ["b", "b"]]
    with pq.ParquetWriter(out["dictladder"],
                          pa.schema([("s", pa.string())])) as w:
        for part in parts:
            w.write_table(pa.table({"s": pa.array(part, pa.string())}))
    for spec in (True, False):
        tag = "spec" if spec else "default"
        for table, path in G.write_parquet(str(d / tag), SF,
                                           spec=spec).items():
            out[f"{table}_{tag}"] = path
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write_files(tmp_path_factory.mktemp("pq"))


SHAPES = ["types", "delta", "strings", "timestamps", "multipage", "allnull",
          "empty", "bss", "dictladder", "lineitem_spec", "orders_spec", "customer_spec",
          "lineitem_default", "orders_default", "customer_default"]


_JAX_SCANS = {}


def _jax_scan(session, path):
    """The JAX session's device-decode read of ``path`` (once per file)."""
    if path not in _JAX_SCANS:
        session.set_conf("spark.rapids.sql.scan.deviceDecode", True)
        try:
            _JAX_SCANS[path] = session.read.parquet(path).collect()
        finally:
            session.set_conf("spark.rapids.sql.scan.deviceDecode", False)
    return _JAX_SCANS[path]


def _same_values(a: pd.Series, b: pd.Series) -> bool:
    """Equal null masks and equal values (timestamps in microseconds)."""
    na, nb = a.isna().to_numpy(), b.isna().to_numpy()
    if len(a) != len(b) or not np.array_equal(na, nb):
        return False
    a, b = a[~na], b[~nb]
    if pd.api.types.is_datetime64_any_dtype(b.dtype):
        return np.array_equal(a.to_numpy("datetime64[us]"),
                              b.to_numpy("datetime64[us]"))
    return list(a) == list(b)


def _reference_faults(session, path) -> set:
    """Columns the JAX package's device decode gets wrong (vs pyarrow)."""
    want = pq.read_table(path).to_pandas()
    got = _jax_scan(session, path)
    return {c for c in want.columns if not _same_values(got[c], want[c])}


# columns the reference's two decode faults hit in these files
KNOWN_REFERENCE_FAULTS = {"l_linestatus", "l_shipmode", "o_orderstatus",
                          "c_nationkey"}


# ---------------------------------------------------------------------------
# Plan parity
# ---------------------------------------------------------------------------

def _assert_same_plan(got: dict, want: dict, where: str) -> None:
    assert got["kind"] == want["kind"], where
    assert got["meta"] == want["meta"], where
    assert sorted(got["upload"]) == sorted(want["upload"]), where
    for k, w in want["upload"].items():
        g = got["upload"][k]
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{where} {k}"
    assert got["nbytes"] == want["nbytes"], where


@pytest.mark.parametrize("shape", SHAPES)
def test_plans_match_reference(session, files, shape):
    path = files[shape]
    ref_src, src = RefSource([path]), ParquetSource(path)
    assert list(src.schema.names) == list(ref_src.schema.names)
    assert [d.name for d in src.schema.dtypes] == \
        [d.name for d in ref_src.schema.dtypes]
    ref_dts = dict(zip(ref_src.schema.names, ref_src.schema.dtypes))
    dts = dict(zip(src.schema.names, src.schema.dtypes))
    faults = _reference_faults(session, path)
    assert faults <= KNOWN_REFERENCE_FAULTS, faults
    for rg in range(praw.file_metadata(path).num_row_groups):
        want = ref_pd.prepare_rowgroup(path, rg, {}, src.columns, ref_dts,
                                       BLOCKED, page_cache=None)
        got = PD.prepare_rowgroup(path, rg, src.columns, dts, BLOCKED)
        assert isinstance(got, pd.DataFrame) == isinstance(want,
                                                           pd.DataFrame)
        if isinstance(want, pd.DataFrame):
            pd.testing.assert_frame_equal(got, want)
            continue
        assert got.fallback == want.fallback
        assert got.n == want.n and sorted(got.plans) == sorted(want.plans)
        for name in want.plans:
            if name not in faults:
                _assert_same_plan(got.plans[name], want.plans[name],
                                  f"{shape} rg{rg} {name}")
        if got.fallback_df is not None:
            pd.testing.assert_frame_equal(got.fallback_df, want.fallback_df)


def test_fallback_reasons(files):
    """BYTE_STREAM_SPLIT falls back per column with the reference's reason;
    the spec'd TPC-H tables never fall back."""
    src = ParquetSource(files["bss"])
    raw = PD.prepare_rowgroup(files["bss"], 0, src.columns,
                              dict(zip(src.schema.names, src.schema.dtypes)),
                              BLOCKED)
    assert raw.fallback == [("bss", "enc:BYTE_STREAM_SPLIT")]
    assert list(raw.plans) == ["i"]
    for table in ("lineitem", "orders", "customer"):
        path = files[f"{table}_spec"]
        src = ParquetSource(path)
        raw = PD.prepare_rowgroup(
            path, 0, src.columns,
            dict(zip(src.schema.names, src.schema.dtypes)), BLOCKED)
        assert raw.fallback == [], table
        kinds = {p["kind"] for p in raw.plans.values()}
        assert "fixed_delta" in kinds and "fixed_plain" in kinds


def test_merged_pages_start_after_the_previous_pages_values():
    """Two pages of 12 values: an RLE run of 9, then one bit-packed group
    of 8 of which 3 belong to the page. The last run counts all 8 in both
    packages; merging, the reference starts the second page at 17 (5
    values late), the port at 12."""
    stream = bytes([9 << 1, 1, (1 << 1) | 1, 0b101])
    want = ref_praw.hybrid_run_table(stream, 1, 12)
    got = praw.hybrid_run_table(stream, 1, 12)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert list(want["out_start"]) == [0, 9, 17]
    ref = ref_praw.merge_run_tables([want, want])
    port = praw.merge_run_tables([got, got], [12, 12])
    assert list(ref["out_start"]) == [0, 9, 17, 26, 34]
    assert list(port["out_start"]) == [0, 9, 12, 21, 29]
    for k in ("kind", "value", "bit_start", "bw"):
        assert np.array_equal(port[k], ref[k]), k


def test_page_as_long_as_its_codec_output_is_decompressed():
    """Snappy output exactly as long as its input: the reference returns
    the compressed bytes as the page, the port decompresses them."""
    body = b"ab" * 4 + np.random.default_rng(0).integers(
        0, 256, 100).astype(np.uint8).tobytes()
    packed = pa.Codec("snappy").compress(body).to_pybytes()
    assert len(packed) == len(body)
    assert praw._decompress(packed, "SNAPPY", len(body)) == body
    assert ref_praw._decompress(packed, "SNAPPY", len(body)) == packed


# ---------------------------------------------------------------------------
# Kernel parity: plain versions against the jnp twins
# ---------------------------------------------------------------------------

def _run_table(rng, nruns, bws, kinds, nwords):
    counts = rng.integers(1, 40, nruns)
    return {
        "out_start": np.concatenate([[0], np.cumsum(counts),
                                     [np.iinfo(np.int32).max]])
        .astype(np.int32),
        "kind": np.append(rng.choice(kinds, nruns), 0).astype(np.uint8),
        "value": np.append(rng.integers(-3, 1 << 20, nruns), 0)
        .astype(np.int32),
        "bit_start": np.append(rng.integers(0, (nwords - 2) * 32 - 40 * 32,
                                            nruns), 0).astype(np.int64),
        "bw": np.append(rng.choice(bws, nruns), 0).astype(np.int32),
    }, int(counts.sum())


_HYBRID_KEYS = ("out_start", "kind", "value", "bit_start", "bw")


@pytest.mark.parametrize("bws,kinds", [([0], [1]), ([1], [1]), ([17], [1]),
                                       ([32], [1]), ([0, 5, 32], [0]),
                                       ([1, 17, 32], [0, 1])])
def test_hybrid_expand_plain_matches_jnp_twin(bws, kinds):
    rng = np.random.default_rng(len(bws) + 7 * len(kinds))
    words = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    tbl, total = _run_table(rng, 30, bws, kinds, 300)
    # past the last run (the guard row's rows), and n % 8 != 0
    for n in (total + 77, 13):
        want = np.asarray(ref_pk.hybrid_expand(
            jnp.asarray(words), *[jnp.asarray(tbl[k]) for k in _HYBRID_KEYS],
            n, mode="jnp"))
        got = K.hybrid_expand(_t(words), *[_t(tbl[k]) for k in _HYBRID_KEYS],
                              n)
        np.testing.assert_array_equal(got.numpy(), want)


def _hybrid_many(seed: int, count: int) -> list:
    """``count`` ragged hybrid streams from one seed: run tables of 1 to 60
    runs, outputs up to and past their runs, n = 0 for every fifth."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(count):
        nwords = int(rng.integers(50, 400))
        words = rng.integers(0, 1 << 32, nwords, dtype=np.uint64).astype(
            np.uint32)
        tbl, total = _run_table(rng, int(rng.integers(1, 60)),
                                [0, 1, 5, 17, 32], [0, 1], nwords)
        n = 0 if j % 5 == 4 else total + int(rng.integers(-total // 2, 90))
        out.append((words, tbl, n))
    return out


@pytest.mark.parametrize("count", [1, 7, 33])
def test_hybrid_expand_many_plain_matches_jnp_twin(count):
    """Each output of one ``hybrid_expand_many`` call equals the JAX
    package's ``_hybrid_expand_jnp`` of its stream."""
    spec = _hybrid_many(count, count)
    got = K.hybrid_expand_many([
        (_t(w), *[_t(tbl[k]) for k in _HYBRID_KEYS], n)
        for w, tbl, n in spec])
    assert len(got) == count
    for g, (w, tbl, n) in zip(got, spec):
        want = np.asarray(ref_pk._hybrid_expand_jnp(
            jnp.asarray(w), *[jnp.asarray(tbl[k]) for k in _HYBRID_KEYS], n))
        assert g.dtype == torch.int32 and g.shape == (n,)
        np.testing.assert_array_equal(g.numpy(), want)


def _ref_delta_pages(up, meta):
    return [np.asarray(ref_pk.delta_unpack(
        jnp.asarray(up["dl_words"]), jnp.asarray(up[f"d{j}_out_start"]),
        jnp.asarray(up[f"d{j}_bit_width"]), jnp.asarray(up[f"d{j}_min_delta"]),
        jnp.asarray(up[f"d{j}_bit_start"]), jnp.asarray(up[f"d{j}_first"]),
        total, mode="jnp")) for j, total in meta["delta_pages"]]


def _port_delta(up, meta):
    tbl = PD.delta_chunk_table(up, meta)
    return K.delta_unpack(*[_t(tbl[k]) for k in (
        "dl_words", "dc_mstart", "dc_bw", "dc_min_delta", "dc_bit_start",
        "dc_page_start", "dc_first")], meta["nn"]).numpy()


def _delta_page(rng, total, min_delta):
    """The upload of a one-page DELTA plan, synthetic: 32-delta miniblocks
    at random bit offsets, one min delta."""
    nm = max(total - 1 + 31, 0) // 32
    words = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    counts = [min(32, total - 1 - 32 * m) for m in range(nm)]
    up = {"dl_words": words,
          "d0_out_start": np.concatenate([[0], np.cumsum(counts, dtype=int),
                                          [np.iinfo(np.int32).max]])
          .astype(np.int32),
          "d0_bit_width": np.append(rng.choice([0, 1, 17, 27, 32], nm), 0)
          .astype(np.int32),
          "d0_min_delta": np.append(np.full(nm, min_delta), 0)
          .astype(np.int64),
          "d0_bit_start": np.append(rng.integers(0, 1900 * 32, nm), 0)
          .astype(np.int64),
          "d0_first": np.asarray([rng.integers(-(1 << 62), 1 << 62)],
                                 np.int64)}
    return up, {"delta_pages": [(0, total)], "nn": total}


@pytest.mark.parametrize("total,min_delta", [(0, 0), (1, 5), (2, -3),
                                             (33, -(1 << 40)), (500, 7),
                                             (4097, -1)])
def test_delta_unpack_plain_matches_jnp_twin(total, min_delta):
    up, meta = _delta_page(np.random.default_rng(total), total, min_delta)
    want = _ref_delta_pages(up, meta)[0]
    np.testing.assert_array_equal(_port_delta(up, meta), want)


@pytest.mark.parametrize("shape,column", [("delta", "d64"), ("delta", "d32"),
                                          ("delta", "wrap"),
                                          ("lineitem_spec", "l_orderkey"),
                                          ("orders_spec", "o_custkey")])
def test_delta_chunk_matches_jnp_pages(files, shape, column):
    """One port launch over a real chunk's pages equals the reference's
    per-page twins concatenated (and the file's values)."""
    path = files[shape]
    src = ParquetSource(path)
    raw = PD.prepare_rowgroup(path, 0, [column],
                              {column: src.schema.dtype_of(column)}, BLOCKED)
    plan = raw.plans[column]
    assert plan["kind"] == "fixed_delta"
    want = np.concatenate(_ref_delta_pages(plan["upload"], plan["meta"]))
    got = _port_delta(plan["upload"], plan["meta"])
    np.testing.assert_array_equal(got, want)
    col = pq.ParquetFile(path).read_row_group(0, columns=[column]).column(0)
    np.testing.assert_array_equal(got.astype(col.type.to_pandas_dtype()),
                                  col.to_numpy())


def test_delta_unpack_many_plain_over_a_row_group(files):
    """``delta_unpack_many_plain`` over an orders row group's DELTA chunks
    (as ``decode_rowgroup`` collects them) equals the per-chunk plain
    version and the reference's per-page ``delta_unpack``."""
    path = files["orders_spec"]
    src = ParquetSource(path)
    cols = ["o_orderkey", "o_custkey", "o_totalprice"]
    raw = PD.prepare_rowgroup(path, 0, cols, {
        c: src.schema.dtype_of(c) for c in cols}, BLOCKED)
    tree = {name: PD._device_upload(p) for name, p in raw.plans.items()}
    streams = PD.delta_streams(raw.plans, PD.upload_arrays(tree, "cpu"))
    assert [name for name, _a in streams] == ["o_orderkey", "o_custkey"]
    chunks = [args for _name, args in streams]
    got = K.delta_unpack_many_plain(chunks)
    assert [g.shape[0] for g in got] == [c[7] for c in chunks]
    for g, c, (name, _a) in zip(got, chunks, streams):
        assert torch.equal(g, K.delta_unpack_plain(*c))
        plan = raw.plans[name]
        want = np.concatenate(_ref_delta_pages(plan["upload"], plan["meta"]))
        np.testing.assert_array_equal(g.numpy(), want)
    for g, w in zip(K.delta_unpack_many(chunks), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["i32", "f32", "i64", "f64", "bool"])
def test_plain_fixed_plain_matches_jnp_twin(kind):
    words = np.random.default_rng(5).integers(
        0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    for n in (31, 100, 4096):  # within, at and past the stream's end
        want = np.asarray(ref_pk.plain_fixed(jnp.asarray(words), kind, n,
                                             mode="jnp"))
        got = K.plain_fixed(_t(words), kind, n).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


def _words(seed: int, count: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 1 << 32, count, dtype=np.uint64).astype(np.uint32)


# (words, kind, n): every kind, n shorter than, equal to and past the stream
_MANY_STREAMS = {
    "row_group": [(64, "f64", 32), (20, "f64", 9), (24, "f64", 11),
                  (2530, "i32", 2526), (64, "bool", 100)],
    "short": [(64, "i32", 31), (64, "f32", 63), (64, "i64", 7),
              (64, "f64", 1), (64, "bool", 5)],
    "exact": [(64, "i32", 64), (64, "f32", 64), (64, "i64", 32),
              (64, "f64", 32), (64, "bool", 2048)],
    "past": [(64, "i32", 4096), (66, "f32", 100), (64, "i64", 33),
             (2, "f64", 8), (3, "bool", 200)],
}
# more streams than one launch takes (32)
_MANY_STREAMS["many"] = _MANY_STREAMS["short"] * 8


# one compiled program per stream shape, not one per operation
_REF_PLAIN_FIXED = jax.jit(ref_pk.plain_fixed, static_argnums=(1, 2),
                           static_argnames=("mode",))


@pytest.mark.parametrize("case", sorted(_MANY_STREAMS))
def test_plain_fixed_many_plain_matches_jnp_twin(case):
    """Each output of one ``plain_fixed_many`` call equals the JAX
    package's ``plain_fixed`` of its stream, bit for bit."""
    spec = _MANY_STREAMS[case]
    words = [_words(j, nw) for j, (nw, _k, _n) in enumerate(spec)]
    got = K.plain_fixed_many([(_t(w), kind, n)
                              for w, (_nw, kind, n) in zip(words, spec)])
    assert len(got) == len(spec)
    for g, w, (_nw, kind, n) in zip(got, words, spec):
        want = np.asarray(_REF_PLAIN_FIXED(jnp.asarray(w), kind, n,
                                           mode="jnp"))
        g = g.numpy()
        assert g.dtype == want.dtype and g.shape == want.shape, (kind, n)
        np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8))


def test_plain_fixed_many_refuses_odd_64_bit_streams():
    words = _t(_words(0, 64))
    assert K.plain_fixed_many([]) == []
    for kind in ("i64", "f64"):
        with pytest.raises(ValueError, match="even number of words"):
            K.plain_fixed_many([(words, "i32", 8), (words[:63], kind, 8)])
    with pytest.raises(ValueError, match="kind"):
        K.plain_fixed_many([(words, "u8", 8)])


@pytest.mark.parametrize("shape", ["lineitem_spec", "customer_spec",
                                   "types"])
def test_row_group_decodes_plain_streams_in_one_call(session, files, shape,
                                                     monkeypatch):
    """``decode_rowgroup`` hands every PLAIN fixed-width stream of a row
    group (values and dictionary pages) to one ``plain_fixed_many`` call,
    and the scan still equals pyarrow and the JAX package's device-decode
    scan."""
    calls = []
    many = K.plain_fixed_many

    def counted(streams):
        calls.append(len(streams))
        return many(streams)
    monkeypatch.setattr(K, "plain_fixed_many", counted)
    path = files[shape]
    src = ParquetSource(path)
    columns = list(src.columns)[:8]  # lineitem's: keys, prices, dictionaries
    dts = dict(zip(src.schema.names, src.schema.dtypes))
    nrg = praw.file_metadata(path).num_row_groups
    want_calls = []
    for rg in range(nrg):
        raw = PD.prepare_rowgroup(path, rg, columns, dts, BLOCKED)
        if isinstance(raw, pd.DataFrame):
            continue
        k = sum(p["kind"] in ("fixed_plain", "fixed_dict")
                for p in raw.plans.values())
        if k:
            want_calls.append(k)
    assert want_calls
    got = S.collect(S.scan_table(path, columns, device="cpu"))
    assert calls == want_calls
    want = pq.read_table(path, columns=columns).to_pandas()
    ref = _jax_scan(session, path)
    for c in columns:
        assert _same_values(got[c], want[c]), c
        if _same_values(ref[c], want[c]):
            assert _same_values(got[c], ref[c]), c


@pytest.mark.parametrize("shape", ["lineitem_spec", "customer_spec",
                                   "types", "multipage", "allnull"])
def test_row_group_expands_hybrid_streams_in_one_call(session, files, shape,
                                                      monkeypatch):
    """``decode_rowgroup`` hands every RLE/bit-packed hybrid stream of a
    row group (definition levels, dictionary codes, booleans) to one
    ``hybrid_expand_many`` call, and the scan still equals pyarrow and the
    JAX package's device-decode scan."""
    calls = []
    many = K.hybrid_expand_many

    def counted(streams):
        calls.append(len(streams))
        return many(streams)
    monkeypatch.setattr(K, "hybrid_expand_many", counted)
    path = files[shape]
    src = ParquetSource(path)
    columns = list(src.columns)[:8]
    dts = dict(zip(src.schema.names, src.schema.dtypes))
    want_calls = []
    for rg in range(praw.file_metadata(path).num_row_groups):
        raw = PD.prepare_rowgroup(path, rg, columns, dts, BLOCKED)
        if isinstance(raw, pd.DataFrame):
            continue
        host = {c: PD._device_upload(p) for c, p in raw.plans.items()}
        k = len(PD.hybrid_streams(raw.plans, host, 1))
        if k:
            want_calls.append(k)
    assert want_calls
    got = S.collect(S.scan_table(path, columns, device="cpu"))
    assert calls == want_calls
    want = pq.read_table(path, columns=columns).to_pandas()
    ref = _jax_scan(session, path)
    for c in columns:
        assert _same_values(got[c], want[c]), c
        if _same_values(ref[c], want[c]):
            assert _same_values(got[c], ref[c]), c


@pytest.mark.parametrize("stride", [8, 16, 64])
def test_slab_pack_plain_matches_jnp_twin(stride):
    rng = np.random.default_rng(stride)
    rows, cap = 50, 64
    lens = rng.integers(0, stride + 1, rows)
    lens[::5] = 0
    starts = np.concatenate([[4], 4 + np.cumsum(lens + 4)[:-1]])
    chars = rng.integers(0, 256, int(starts[-1] + lens[-1]) + stride + 8)
    st, ln = np.zeros(cap, np.int64), np.zeros(cap, np.int32)
    st[:rows], ln[:rows] = starts, lens
    chars = chars.astype(np.uint8)
    want = np.asarray(ref_pk.slab_pack(jnp.asarray(chars), jnp.asarray(st),
                                       jnp.asarray(ln), cap, stride,
                                       mode="jnp"))
    got = K.slab_pack(_t(chars), _t(st), _t(ln), cap, stride)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


# ---------------------------------------------------------------------------
# Scan parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_scan_matches_pyarrow_and_reference(session, files, shape):
    path = files[shape]
    want = pq.read_table(path).to_pandas()
    before = SYNCS.total()
    batches = S.scan_table(path, device="cpu")
    assert SYNCS.total() - before == praw.file_metadata(path).num_row_groups
    got = S.collect(batches)
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        assert _same_values(got[c], want[c]), c
    ref = _jax_scan(session, path)
    faults = {c for c in want.columns if not _same_values(ref[c], want[c])}
    assert faults <= KNOWN_REFERENCE_FAULTS, faults
    for c in want.columns:
        if c not in faults:
            assert _same_values(got[c], ref[c]), c


def test_spec_scan_decodes_every_column_on_the_device(files):
    before = REGISTRY.values()
    for table in ("lineitem", "orders", "customer"):
        S.scan_table(files[f"{table}_spec"], device="cpu")
    d = delta(before, REGISTRY.values())
    assert d.get("scan.device.fallbackColumns", 0) == 0
    assert d["scan.device.columns"] == 15 + 8 + 6
    assert d["scan.device.splits"] == 3 and d["scan.device.bytesDevice"] > 0


def test_serial_scan_matches_prefetched(files):
    path = files["lineitem_spec"]
    a = S.collect(S.scan_table(path, device="cpu", depth=0))
    b = S.collect(S.scan_table(path, device="cpu", depth=2, threads=2))
    pd.testing.assert_frame_equal(a, b)


# ---------------------------------------------------------------------------
# Driver parity
# ---------------------------------------------------------------------------

def _jax_query(qname, paths):
    def run(s):
        return QUERIES[qname](s, {n: s.read.parquet(p)
                                  for n, p in paths.items()})
    return with_tpu_session(run)


def _assert_frames(got, want, keys=None):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    if keys:
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
    for c in want.columns:
        if pd.api.types.is_float_dtype(want[c].dtype):
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64),
                                       rtol=F64_RTOL, err_msg=c)
        else:
            assert _same_values(got[c].reset_index(drop=True),
                                want[c].reset_index(drop=True)), c


@pytest.fixture(scope="module")
def spec_paths(files):
    return {t: files[f"{t}_spec"] for t in ("lineitem", "orders",
                                             "customer")}


def test_q1_q6_parquet_match_reference(spec_paths):
    li = {"lineitem": spec_paths["lineitem"]}
    got = S.run_q1_parquet(spec_paths["lineitem"], device="cpu")
    want = _jax_query("q1", li)
    _assert_frames(got, want[list(got.columns)],
                   ["l_returnflag", "l_linestatus"])
    got = S.run_q6_parquet(spec_paths["lineitem"], device="cpu")
    _assert_frames(got, _jax_query("q6", li))


def test_q3_q4_parquet_match_reference(spec_paths):
    got = S.run_q3_parquet(spec_paths, device="cpu")
    want = _jax_query("q3", spec_paths)[list(got.columns)]
    assert len(got) == J.Q3_LIMIT
    np.testing.assert_allclose(got.revenue, want.revenue, rtol=F64_RTOL)
    assert _same_values(got.o_orderdate, want.o_orderdate)
    ties = want.groupby(["revenue", "o_orderdate"], sort=False)
    for _, grp in ties:
        rows = grp.index
        assert sorted(got.loc[rows, "l_orderkey"]) == \
            sorted(want.loc[rows, "l_orderkey"])
    got = S.run_q4_parquet(spec_paths, device="cpu")
    want = _jax_query("q4", spec_paths)
    assert list(got.o_orderpriority) == list(want.o_orderpriority)
    assert list(got.order_count) == list(want.order_count)


def test_q18_and_customer_parquet_match_pandas(spec_paths, tmp_path):
    li = G.gen_lineitem(SF)
    big = li.assign(l_quantity=li.l_quantity * 20)  # some groups pass 300
    path = str(tmp_path / "big.parquet")
    G.write_table(big, path, G.PARQUET_SPEC["lineitem"])
    got = S.run_q18_agg_parquet(path, device="cpu")
    sums = big.groupby("l_orderkey").l_quantity.sum()
    want = sums[sums > 300]
    assert len(want) > 0
    got = got.set_index("l_orderkey").sum_qty.sort_index()
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL)
    cust = G.gen_customer(SF)
    got = S.customer_segment_collect(spec_paths["customer"], device="cpu")
    want = cust[cust.c_mktsegment == "BUILDING"].reset_index(drop=True)
    _assert_frames(got, want)


# ---------------------------------------------------------------------------
# The scan pipeline's contract under many threads
# ---------------------------------------------------------------------------

def test_prefetch_order_errors_and_cancel_under_many_threads():
    """More planning threads than cores and a short switch interval: the
    partitions still yield their own splits in order, the first failure
    reaches its consumer and stops further submissions, an abandoned
    partition cancels what has not started, and the budget drains."""
    import sys
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor
    from spark_rapids_tpu_torch.sql.scan_pipeline import ScanPrefetcher

    class Split:
        def __init__(self, i):
            self.i, self.nbytes = i, 1000

    started = []
    lock = threading.Lock()

    def task(i, fail=False):
        def run():
            with lock:
                started.append(i)
            time.sleep(0.001 * (i % 3))
            if fail:
                raise ValueError(f"split {i}")
            return Split(i)
        return run

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pool = ThreadPoolExecutor(max_workers=32)
    try:
        n = 200
        pf = ScanPrefetcher([task(i) for i in range(n)], 16, pool, 1 << 30)
        assert [pf.get(i).i for i in range(n)] == list(range(n))
        assert pf._pending_bytes == 0
        started.clear()
        pf = ScanPrefetcher([task(i, fail=i == 5) for i in range(50)], 4,
                            pool, 1 << 30)
        assert [pf.get(i).i for i in range(5)] == list(range(5))
        with pytest.raises(ValueError, match="split 5"):
            pf.get(5)
        assert max(started) <= 9  # nothing submitted past the window
        assert pf.get(6).i == 6 and max(started) <= 9
        pf = ScanPrefetcher([task(i) for i in range(50)], 8, pool, 1 << 30)
        assert pf.get(0).i == 0
        pf.cancel()
        assert pf._pending_bytes == 0 and not pf._futures
    finally:
        sys.setswitchinterval(old)
        pool.shutdown(wait=True, cancel_futures=True)
