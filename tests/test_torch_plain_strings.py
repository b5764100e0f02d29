"""Plain offsets+chars string columns (the repair of C.6) through the port
on the CPU, against the JAX package and pandas.

C.6: a string column with one 256 KiB value among short ones uploaded as
a slab as wide as that value (rows x 2^18 bytes). The upload now takes the
JAX package's rule (a dictionary, else a slab up to
``spark.rapids.sql.dict.blockedChars.maxStride``, else plain), and plain
columns move through every operator:

  * the probe itself, and the upload's choice of form against the JAX
    package's, column kind by column kind;
  * filter, gather, slice and concat over mixed forms;
  * sort in both directions and null orders over values tying on their
    first 64 bytes, equal to pandas and to the JAX session (which settles
    such ties by full-length compares; the port ranks the tied tails);
  * group-by count and min/max, distinct, and the six join types on
    plain keys against plain, slab and dictionary keys (the JAX session);
  * ``hash()`` equal in all three forms; a spill round trip through host
    and disk.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, flatten_batch,
)
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, host_string_packed, host_string_slab,
)
from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
from spark_rapids_tpu_torch.ops import hashing, rowops
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session
from tests.test_torch_session_joins import _rows

HEAD = "h" * 64  # the shared 64-byte prefix of the tied values
JOIN_TYPES = ["inner", "left", "right", "full", "leftsemi", "leftanti"]


def _port(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _both(query, **conf):
    """(port answer, JAX session answer) of ``query(session, functions)``."""
    got = query(_port(**conf), F).collect()
    want = with_tpu_session(lambda rs: query(rs, RF), conf=conf)
    return got, want


def _form(col) -> str:
    if col.dict_values is not None:
        return "dict"
    if col.has_slab:
        return "slab"
    return "plain"


def _tied(n: int, seed: int, nulls: bool = True) -> np.ndarray:
    """``n`` values, most of them sharing their first 64 bytes and then
    differing in their tails (lengths 64 to 200, tails that tie on their
    length or hold zero bytes), some short, some empty."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.6:
            tail = "".join(rng.choice(list("ab\0z"), rng.integers(0, 137)))
            out.append(HEAD + tail)
        elif r < 0.7:
            out.append("")
        else:
            out.append(f"s{i}-" + "q" * int(rng.integers(0, 90)))
    vals = np.asarray(out, dtype=object)
    if nulls:
        vals[rng.random(n) < 0.08] = None
    return vals


# ---------------------------------------------------------------------------
# C.6 and the upload's rule
# ---------------------------------------------------------------------------

def _c6_frame() -> pd.DataFrame:
    rng = np.random.default_rng(6)
    n = 4096
    s = np.asarray([f"r{i}-" + "x" * int(rng.integers(0, 40))
                    for i in range(n)], dtype=object)
    s[1234] = "L" * (256 * 1024)
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64), "s": s})


def test_c6_probe_returns_reference_rows_from_a_plain_column(session):
    """The probe of C.6: 4096 rows, one 256 KiB value; ``filter(k < 10)
    .select(k, s)`` gives the JAX session's 10 rows, and the uploaded
    column is plain, its device bytes under 2 MiB (it was 1 GiB as a
    slab)."""
    df = _c6_frame()
    got, want = _both(lambda s, fn: s.create_dataframe(df)
                      .filter(fn.col("k") < 10).select("k", "s"))
    assert len(got) == 10 and _rows(got) == _rows(want)
    batch = DeviceBatch.from_pandas(df, {}, device="cpu",
                                    slab_stride=upload_blocked_chars())
    col = batch.columns[1]
    assert col.is_plain
    nbytes = sum(t.numel() * t.element_size()
                 for t in (col.chars, col.offsets, col.validity))
    assert nbytes < 2 << 20, nbytes
    long_row = batch.to_pandas().s[1234]
    assert long_row == df.s[1234]


def _upload_frame(kind: str, n: int = 3000) -> pd.DataFrame:
    rng = np.random.default_rng(len(kind))
    if kind == "low_card":
        vals = np.asarray(["a", "bb", "", "ccc" * 30], dtype=object)[
            rng.integers(0, 4, n)]
    elif kind == "short":
        vals = np.asarray([f"k{i}" for i in range(n)], dtype=object)
    elif kind == "at_stride":
        vals = np.asarray([f"{i:064d}" for i in range(n)], dtype=object)
    elif kind == "past_stride":
        vals = np.asarray([f"{i:065d}" for i in range(n)], dtype=object)
    elif kind == "skewed":
        vals = _c6_frame().s.to_numpy()[:n].copy()
    elif kind == "nul":
        vals = np.asarray(["a\0", "a", "b"] * (n // 3), dtype=object)
    else:  # all_null
        vals = np.full(n, None, dtype=object)
    if kind != "all_null":
        vals = vals.copy()
        vals[rng.random(len(vals)) < 0.05] = None
    return pd.DataFrame({"s": vals})


@pytest.mark.parametrize("kind", ["low_card", "short", "at_stride",
                                  "past_stride", "skewed", "nul",
                                  "all_null"])
def test_upload_form_matches_reference(kind):
    """The form the upload gives a string column (dictionary, slab or
    plain) is the JAX package's, at the stride limit the session uses,
    and the values read back."""
    df = _upload_frame(kind)
    stride = upload_blocked_chars()
    got = DeviceBatch.from_pandas(df, {}, device="cpu", slab_stride=stride)
    ref = RefBatch.from_pandas(df, dict_state={}, blocked_chars=stride)
    rc = ref.columns[0]
    ref_form = ("dict" if rc.dict_values is not None
                else "slab" if rc.has_slab else "plain")
    if kind == "all_null":  # both read every row back as NULL
        assert got.to_pandas().s.isna().all()
        return
    assert _form(got.columns[0]) == ref_form
    assert got.to_pandas().s.tolist() == df.s.tolist()


def test_scan_stride_registry_keeps_later_batches_plain(session):
    """One scan: a first batch past the stride limit goes plain, and a
    later batch that would fit a slab stays plain (the JAX package's
    per-scan registry); the answer equals the JAX session's."""
    short = pd.DataFrame({"s": [f"k{i}" for i in range(1000)]})
    wide = pd.DataFrame({"s": [f"{i:080d}" for i in range(1000)]})
    state: dict = {}
    first = DeviceBatch.from_pandas(wide, state, device="cpu",
                                    slab_stride=64)
    later = DeviceBatch.from_pandas(short, state, device="cpu",
                                    slab_stride=64)
    assert first.columns[0].is_plain and later.columns[0].is_plain
    df = pd.concat([wide, short], ignore_index=True).assign(
        k=np.arange(2000))
    got, want = _both(lambda s, fn: s.create_dataframe(df)
                      .filter(fn.col("k") % 3 == 0),
                      **{"spark.rapids.sql.batchSizeRows": 1000})
    assert _rows(got) == _rows(want)


# ---------------------------------------------------------------------------
# Row movement over mixed forms
# ---------------------------------------------------------------------------

def _column(vals: np.ndarray, form: str, cap: int) -> DeviceColumn:
    valid = np.zeros(cap, bool)
    valid[:len(vals)] = [v is not None for v in vals]
    v = torch.from_numpy(valid)
    if form == "plain":
        chars, offsets = host_string_packed(vals, valid, cap)
        return DeviceColumn(dtypes.STRING, None, v,
                            chars=torch.from_numpy(chars),
                            offsets=torch.from_numpy(offsets))
    if form == "slab":
        slab, lens = host_string_slab(vals, valid, cap, 1 << 10)
        return DeviceColumn(dtypes.STRING, None, v,
                            slab64=torch.from_numpy(slab.view(np.int64)),
                            lens=torch.from_numpy(lens))
    uniq = tuple(sorted({x for x in vals if x is not None}))
    codes = np.full(cap, len(uniq), np.int32)
    codes[:len(vals)] = [uniq.index(x) if x is not None else len(uniq)
                         for x in vals]
    return DeviceColumn(dtypes.STRING, None, v, torch.from_numpy(codes),
                        uniq)


def _batch(vals: np.ndarray, form: str) -> DeviceBatch:
    from spark_rapids_tpu_torch.columnar.batch import Schema, bucket_capacity
    n = len(vals)
    cap = bucket_capacity(n)
    key = DeviceColumn(dtypes.INT64, torch.arange(cap, dtype=torch.int64),
                       torch.arange(cap) < n)
    return DeviceBatch(Schema(["k", "s"], [dtypes.INT64, dtypes.STRING]),
                       [key, _column(vals, form, cap)],
                       torch.tensor(n, dtype=torch.int32))


def _values(seed: int, n: int = 300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pool = _tied(40, seed)  # few distinct values: dictionaries stay small
    return pool[rng.integers(0, len(pool), n)]


@pytest.mark.parametrize("parts", [("plain",), ("plain", "slab"),
                                   ("dict", "plain"),
                                   ("slab", "dict", "plain"),
                                   ("plain", "plain")])
@pytest.mark.parametrize("op", ["filter", "gather", "slice", "concat"])
def test_row_movement_over_mixed_forms(op, parts):
    """filter, gather and slice of each part, and the concat of all of
    them (a fused filter included), equal pandas row for row."""
    vals = [_values(i) for i in range(len(parts))]
    batches = [_batch(v, f) for v, f in zip(vals, parts)]
    frames = [pd.DataFrame({"k": np.arange(len(v)), "s": v}) for v in vals]
    rng = np.random.default_rng(7)
    if op == "concat":
        keeps = [torch.from_numpy(rng.random(b.capacity) < 0.6)
                 for b in batches]
        got = rowops.concat_batches(batches, 2048).to_pandas()
        want = pd.concat(frames, ignore_index=True)
        assert got.s.tolist() == want.s.tolist()
        got = rowops.concat_batches(batches, 2048, keep_masks=keeps)
        want = pd.concat([f[k.numpy()[:len(f)]] for f, k in
                          zip(frames, keeps)], ignore_index=True)
        assert got.to_pandas().s.tolist() == want.s.tolist()
        assert got.columns[1].is_plain
        return
    for b, f in zip(batches, frames):
        if op == "filter":
            keep = rng.random(b.capacity) < 0.5
            got = rowops.filter_batch(b, torch.from_numpy(keep))
            want = f[keep[:len(f)]]
        elif op == "gather":
            perm = rng.permutation(b.capacity)
            got = rowops.gather_batch(b, torch.from_numpy(perm).int(),
                                      torch.tensor(b.capacity))
            want = pd.DataFrame({"s": [f.s[i] if i < len(f) else None
                                       for i in perm]})
        else:
            got = rowops.slice_batch(b, 17, 120)
            want = f.iloc[17:137]
        assert got.to_pandas().s.tolist() == want.s.tolist()


def _filtered(vals: np.ndarray, form: str, seed: int):
    """(the batch of ``vals`` filtered to a tenth of its rows, the kept
    values)."""
    b = _batch(vals, form)
    keep = np.random.default_rng(seed).random(b.capacity) < 0.1
    out = rowops.filter_batch(b, torch.from_numpy(keep))
    return out, [v for v, k in zip(vals, keep) if k]


def _strs(batch: DeviceBatch) -> list:
    return [x if isinstance(x, str) else None for x in batch.to_pandas().s]


def test_concat_past_the_shrink_takes_live_chars(monkeypatch):
    """Filtered batches keep their source's char capacity. A concat whose
    parts' char capacities sum past CONCAT_SHRINK_CHARS reads their live
    char totals in one counted sync and its chars hold just those bytes,
    equal to pandas; with a fused filter too."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    monkeypatch.setattr(rowops, "CONCAT_SHRINK_CHARS", 0)
    parts = [_filtered(_values(20 + i), f, 30 + i)
             for i, f in enumerate(("plain", "slab", "dict", "plain"))]
    batches = [b for b, _v in parts]
    want = [v for _b, vals in parts for v in vals]
    live = sum(len(v.encode("utf-8")) for v in want if v is not None)
    capacity = sum(int(b.columns[1].chars.shape[0]) for b in batches
                   if b.columns[1].is_plain)
    assert capacity > 4 * live
    before = SYNCS.syncs.get("concat.charTotals", 0)
    got = rowops.concat_batches(batches, 512)
    assert SYNCS.syncs["concat.charTotals"] == before + 1
    assert got.columns[1].is_plain
    assert int(got.columns[1].chars.shape[0]) == live
    assert _strs(got) == want
    keeps = [torch.arange(b.capacity) % 2 == 0 for b in batches]
    got = rowops.concat_batches(batches, 512, keep_masks=keeps)
    assert _strs(got) == [v for _b, vals in parts for v in vals[::2]]


def test_concat_past_int32_chars_raises(monkeypatch):
    """A concat whose live chars pass what int32 offsets address raises
    rather than wrap."""
    monkeypatch.setattr(rowops, "CONCAT_SHRINK_CHARS", 0)
    monkeypatch.setattr(rowops, "MAX_PLAIN_CHARS", 100)
    b = _batch(_values(1), "plain")
    with pytest.raises(ValueError, match="int32 offsets"):
        rowops.concat_batches([b, b], 1024)


# ---------------------------------------------------------------------------
# Sort, group-by, distinct and joins over plain keys
# ---------------------------------------------------------------------------

def _plain_frame(n: int = 900, seed: int = 3) -> pd.DataFrame:
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64),
                         "s": _tied(n, seed)})


def _pandas_sorted(df: pd.DataFrame, asc: bool, nulls_first: bool):
    key = df.s.map(lambda x: x.encode() if isinstance(x, str) else None)
    nulls = df[key.isna()]
    rest = df[key.notna()].assign(_b=key[key.notna()])
    rest = rest.sort_values(["_b", "k"], ascending=[asc, True],
                            kind="stable").drop(columns="_b")
    parts = [nulls, rest] if nulls_first else [rest, nulls]
    return pd.concat(parts, ignore_index=True)


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_sort_exact_past_64_bytes(session, asc, nulls_first):
    """Values tying on their first 64 bytes (and on their length) sort in
    exact byte order, both directions, both null orders, equal to pandas
    and to the JAX session; a tie on the whole value falls back to the
    second key."""
    df = _plain_frame()

    def query(s, fn):
        order = fn.SortOrder(fn.col("s").expr, ascending=asc,
                             nulls_first=nulls_first)
        return s.create_dataframe(df).order_by(order, "k")
    got, ref = _both(query)
    assert got.k.tolist() == ref.k.tolist()
    want = _pandas_sorted(df, asc, nulls_first)
    assert [x if isinstance(x, str) else None for x in got.s] == \
        [x if isinstance(x, str) else None for x in want.s]
    assert got.k.tolist() == want.k.tolist()


@pytest.mark.parametrize("agg", ["count", "min_max", "distinct",
                                 "count_distinct"])
def test_group_by_over_plain_keys(session, agg):
    """Group-by count, string min/max, distinct and a grouped count
    distinct over a plain key column equal the JAX session."""
    df = _plain_frame().assign(g=lambda d: d.k % 7)

    def query(s, fn):
        t = s.create_dataframe(df)
        if agg == "count":
            return t.group_by("s").agg(fn.count("*").alias("n"),
                                       fn.sum("k").alias("sk"))
        if agg == "min_max":
            return t.group_by("g").agg(fn.min("s").alias("lo"),
                                       fn.max("s").alias("hi"))
        if agg == "distinct":
            return t.select("s").distinct()
        return t.group_by("g").agg(fn.count_distinct("s").alias("nd"))
    got, want = _both(query)
    assert _rows(got) == _rows(want)


def _join_side(form: str, side: str, n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    if form == "plain":
        pool = [HEAD + f"{i:020d}" for i in range(300)]
    elif form == "slab":
        pool = [f"{i:020d}" for i in range(300)]
    else:
        pool = [f"{i:020d}" for i in range(0, 300, 20)]
    keys = np.asarray(pool, dtype=object)[rng.integers(0, len(pool), n)]
    keys[rng.random(n) < 0.1] = None
    return pd.DataFrame({f"{side}s": keys,
                         f"{side}v": rng.integers(0, 100, n)})


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("other", ["plain", "slab", "dict"])
def test_join_on_plain_keys(session, other, how):
    """The six join types with a plain key on the left against a plain, a
    slab and a dictionary key on the right (values of both shapes so some
    match), through the union probe, equal the JAX session."""
    l_df = _join_side("plain", "l", 240, 1)
    extra = _join_side(other, "l", 80, 2)
    l_df = pd.concat([l_df, extra], ignore_index=True)
    r_df = pd.concat([_join_side(other, "r", 120, 4),
                      _join_side("plain", "r", 40, 5)], ignore_index=True)

    def query(s, fn):
        return s.create_dataframe(l_df).join(
            s.create_dataframe(r_df), left_on=["ls"], right_on=["rs"],
            how=how)
    got, want = _both(query)
    assert _rows(got) == _rows(want)
    if how in ("inner", "leftsemi"):
        assert len(got) > 0


def test_string_payload_crosses_an_expanding_join(session):
    """A plain payload column duplicated by a many-to-many join takes the
    char totals the expand's sync reads."""
    rng = np.random.default_rng(9)
    left = pd.DataFrame({"k": rng.integers(0, 20, 400),
                         "p": _tied(400, 9)})
    right = pd.DataFrame({"k2": rng.integers(0, 20, 300),
                          "q": _tied(300, 10)})
    got, want = _both(lambda s, fn: s.create_dataframe(left).join(
        s.create_dataframe(right), left_on=["k"], right_on=["k2"]))
    assert len(got) > 2000 and _rows(got) == _rows(want)


# ---------------------------------------------------------------------------
# hash() across forms, and a spill round trip
# ---------------------------------------------------------------------------

def test_hash_equal_across_the_three_forms(session):
    """The same values hash to the same bits as a dictionary, a slab and
    plain chars, equal to the numpy twin; through the session ``hash()``
    over a plain column equals the JAX session's."""
    vals = _values(11)
    cap = 512
    want = hashing.np_string_hashes(vals, np.array([v is not None
                                                    for v in vals]))
    for form in ("dict", "slab", "plain"):
        got = hashing.hash_string_col(_column(vals, form, cap))
        assert got[:len(vals)].numpy().view(np.uint64).tolist() == \
            want.tolist(), form
    df = _plain_frame()
    got, want = _both(lambda s, fn: s.create_dataframe(df).select(
        "k", fn.hash(fn.col("s")).alias("h")))
    assert _rows(got) == _rows(want)


def test_plain_batch_spills_through_host_and_disk(tmp_path):
    """A batch holding a plain column spills to the host arena and to disk
    and faults back bit-equal."""
    from spark_rapids_tpu_torch.memory.spill import (
        BufferCatalog, StorageTier,
    )
    df = _plain_frame(500)
    batch = DeviceBatch.from_pandas(df, {}, device="cpu", slab_stride=64)
    assert batch.columns[1].is_plain
    want, layout = flatten_batch(batch)
    want = [t.clone() for t in want]
    c = BufferCatalog(host_limit_bytes=1 << 22, disk_dir=str(tmp_path))
    try:
        bid = c.add_batch(batch)
        del batch
        c.device_store.synchronous_spill(0)
        assert c.buffer_tier(bid) == StorageTier.HOST
        c.host_store.synchronous_spill(0)
        assert c.buffer_tier(bid) == StorageTier.DISK
        back = c.acquire_batch(bid)
        got, got_layout = flatten_batch(back)
        assert got_layout == layout
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert back.to_pandas().s.tolist() == df.s.tolist()
        c.remove(bid)
    finally:
        c.close()


def test_parquet_dictionary_of_long_values_closes_to_plain(tmp_path):
    """A Parquet string column of long dictionary values whose second row
    group brings values the scan's first dictionary lacks: the scan closes
    the dictionary, and the later row group's column comes out as plain
    chars (not a slab as wide as the longest value); the answer equals
    pandas."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    long_a = ["L" * 100 + f"{i}" for i in range(5)]
    long_b = ["M" * 300 + f"{i}" for i in range(5)]
    rng = np.random.default_rng(12)
    vals = np.concatenate([np.asarray(long_a, object)[rng.integers(0, 5, 500)],
                           np.asarray(long_b, object)[rng.integers(0, 5, 500)]])
    df = pd.DataFrame({"k": np.arange(1000, dtype=np.int64), "s": vals})
    path = str(tmp_path / "long.parquet")
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path,
                   row_group_size=500, use_dictionary=True)
    got = _port().read.parquet(path).filter(F.col("k") % 3 == 0).collect()
    want = df[df.k % 3 == 0]
    assert sorted(zip(got.k, got.s)) == sorted(zip(want.k, want.s))
