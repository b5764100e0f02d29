"""The port's hash joins against the JAX package, on the CPU.

  * Kernels B3 and B4 (``hash_table_build``, ``hash_table_probe``,
    ``hash_join_probe``): on CPU tensors the port runs their plain versions,
    held against the JAX package's jnp twins (``mode="jnp"``; the Pallas
    interpret mode is not used) on the cases of
    ``tests/test_pallas_kernels.py``. Counts exact, each stream row's match
    range in bperm exact, the table compared by key.
  * ``exec/tpujoin.hash_join`` and ``ops/joins`` against the JAX
    package's ``ops/joins`` on ``batch_from_reference`` copies of the same
    batches: the JAX side probes with its own union-lexsort ``join_probe``,
    so the port's hash route is held against the sort route. Within a match
    group both keep build rows ascending, so the expanded batches agree row
    for row: integer and dictionary columns exactly, floats bit for bit.
  * The slice: ``run_q3``/``run_q4`` at SF 0.002 against the JAX package's
    ``models/tpch`` Q3 and Q4 through a ``TpuSparkSession`` on the CPU, and
    against pandas. Keys, counts, dates and integers exact, revenue at rtol
    1e-9; rows compare in the query's order, rows tied on the sort key as
    a set.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.columnar.batch import bucket_capacity as ref_bucket
from spark_rapids_tpu.models import tpch_data as ref_gen
from spark_rapids_tpu.models.tpch import QUERIES
from spark_rapids_tpu.ops import joins as ref_joins
from spark_rapids_tpu.ops import pallas_kernels as ref_pk
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.exec import tpujoin
from spark_rapids_tpu_torch.models import tpch_data as G
from spark_rapids_tpu_torch.models import tpch_joins as J
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.ops import joins, kernels as K
from spark_rapids_tpu_torch.testing import hashcheck
from spark_rapids_tpu_torch.testing.reference import batch_from_reference
from tests.querytest import with_tpu_session

F64_RTOL = 1e-9
SF = 0.002


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# B3 / B4 plain versions against the jnp twins
# ---------------------------------------------------------------------------

def _typed_images(np_dtype, rng, n, pool):
    """Exact u64 key images of a typed column (via both packages'
    ``u64_key_image``) drawn from ``pool``."""
    from spark_rapids_tpu.ops.sortops import u64_key_image as ref_image
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image
    vals = np.asarray(pool, dtype=np_dtype)[rng.integers(0, len(pool), n)]
    ref = RefBatch.from_pandas(pd.DataFrame({"k": vals}), dict_numerics=False)
    img_r = np.asarray(ref_image(ref.columns[0])[0])
    img_p = u64_key_image(batch_from_reference(ref).columns[0])[0]
    np.testing.assert_array_equal(img_p.numpy().view(np.uint64), img_r)
    return img_r[:n]


def _join_case(case, rng):
    """(build images [k], build valid, stream images [k], stream valid),
    numpy uint64 images: the oracle cases of test_pallas_kernels.py."""
    if case == "random":
        nb, ns = 257, 400
        return ([rng.integers(0, 60, nb).astype(np.uint64)],
                rng.random(nb) < 0.85,
                [rng.integers(0, 80, ns).astype(np.uint64)],
                rng.random(ns) < 0.9)
    if case == "skewed":
        return ([np.full(64, 7, np.uint64)], np.ones(64, bool),
                [np.asarray([7, 8, 7], np.uint64)], np.ones(3, bool))
    if case == "all_null_build":
        return ([rng.integers(0, 4, 32).astype(np.uint64)],
                np.zeros(32, bool),
                [rng.integers(0, 4, 16).astype(np.uint64)], np.ones(16, bool))
    if case == "all_null_stream":
        return ([rng.integers(0, 4, 32).astype(np.uint64)], np.ones(32, bool),
                [rng.integers(0, 4, 16).astype(np.uint64)],
                np.zeros(16, bool))
    if case == "empty":
        return ([np.zeros(0, np.uint64)], np.zeros(0, bool),
                [np.zeros(0, np.uint64)], np.zeros(0, bool))
    if case in ("multi_k2", "multi_k3"):
        k = 2 if case == "multi_k2" else 3
        nb, ns = 120, 200
        return ([rng.integers(0, 6, nb).astype(np.uint64) for _ in range(k)],
                rng.random(nb) < 0.9,
                [rng.integers(0, 7, ns).astype(np.uint64) for _ in range(k)],
                rng.random(ns) < 0.9)
    np_dtype = {"typed_int64": np.int64, "typed_float64": np.float64}[case]
    pool = ([-5, 0, 3, 1 << 40, -(1 << 62), np.iinfo(np.int64).max]
            if np_dtype is np.int64
            else [0.0, -0.0, np.nan, -1.5, 2.25, np.inf, -np.inf, 1e300])
    return ([_typed_images(np_dtype, rng, 150, pool)], rng.random(150) < 0.9,
            [_typed_images(np_dtype, rng, 90, pool)], rng.random(90) < 0.95)


CASES = ["random", "skewed", "all_null_build", "all_null_stream", "empty",
         "multi_k2", "multi_k3", "typed_int64", "typed_float64"]


def _oracle_counts(bimg, bv, simg, sv):
    from collections import Counter
    groups = Counter(tuple(int(w[i]) for w in bimg)
                     for i in range(len(bv)) if bv[i])
    return np.asarray([groups[tuple(int(w[i]) for w in simg)] if sv[i] else 0
                       for i in range(len(sv))], dtype=np.int64)


@pytest.mark.parametrize("case", CASES)
def test_hash_join_probe_matches_jnp_twin(case, rng):
    bimg, bv, simg, sv = _join_case(case, rng)
    T = ref_pk.hash_table_size(len(bv))
    assert K.hash_table_size(len(bv)) == T
    want = ref_pk.hash_join_probe([jnp.asarray(w) for w in bimg],
                                  jnp.asarray(bv),
                                  [jnp.asarray(w) for w in simg],
                                  jnp.asarray(sv), T, mode="jnp")
    got = K.hash_join_probe([_t(w) for w in bimg], _t(bv),
                            [_t(w) for w in simg], _t(sv), T)
    c_w, rows_w = hashcheck.join_matches(*[torch.from_numpy(np.array(a))
                                           for a in want])
    c_g, rows_g = hashcheck.join_matches(*got)
    np.testing.assert_array_equal(c_g.numpy(), c_w.numpy())
    np.testing.assert_array_equal(c_g.numpy(),
                                  _oracle_counts(bimg, bv, simg, sv))
    np.testing.assert_array_equal(rows_g.numpy(), rows_w.numpy())
    assert sorted(got[2].tolist()) == list(range(len(bv)))


@pytest.mark.parametrize("case", CASES)
def test_hash_table_build_and_probe_match_jnp_twin(case, rng):
    bimg, bv, simg, sv = _join_case(case, rng)
    T = K.hash_table_size(len(bv))
    _s, rank_r, table_r, counts_r = ref_pk.hash_table_build(
        [jnp.asarray(w) for w in bimg], jnp.asarray(bv), T, mode="jnp")
    images = [_t(w) for w in bimg]
    slot, rank, table, counts = K.hash_table_build(images, _t(bv), T)
    assert rank is None and rank_r is None
    hashcheck.check_build(images, _t(bv), slot, table, counts)
    table_r = _t(np.asarray(table_r))
    counts_r = _t(counts_r)
    assert torch.equal(hashcheck.table_by_key(table, counts),
                       hashcheck.table_by_key(table_r, counts_r))
    want = np.asarray(ref_pk.hash_table_probe(
        jnp.asarray(np.asarray(table_r).view(np.uint64)),
        jnp.asarray(counts_r.numpy()), [jnp.asarray(w) for w in simg],
        jnp.asarray(sv), T, mode="jnp"))
    got = K.hash_table_probe(table, counts, [_t(w) for w in simg], _t(sv), T)
    hit = got.numpy() < T
    np.testing.assert_array_equal(hit, want < T)
    for j, w in enumerate(simg):
        np.testing.assert_array_equal(
            table[j][got[torch.from_numpy(hit)].long()].numpy(),
            w[hit].view(np.int64))


# ---------------------------------------------------------------------------
# ops/joins and exec/tpujoin against the JAX package's ops/joins
# ---------------------------------------------------------------------------

def _side(rng, n, prefix, key_hi):
    k = pd.Series(rng.integers(0, key_hi, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.2] = -0.0
    f[rng.random(n) < 0.1] = np.nan
    s = np.array(["ab", "c", "de", None], dtype=object)[rng.integers(0, 4, n)]
    return pd.DataFrame({f"{prefix}k": k, f"{prefix}f": f, f"{prefix}s": s,
                         f"{prefix}v": rng.integers(-100, 100, n)})


def _ref_join(build, stream, jt, bkey, skey):
    """The JAX package's composition for one build and one stream batch:
    join_probe, then (semi) filter or expand plus the full-outer tail."""
    counts, bstart, bperm = ref_joins.join_probe(build, stream, bkey, skey)
    if jt in ("leftsemi", "leftanti"):
        return [ref_joins.semi_anti_filter(stream, counts,
                                           anti=jt == "leftanti")]
    adj = (ref_joins.outer_adjusted_counts(stream, counts)
           if jt in ("left", "right", "full") else counts)
    total = int(ref_joins.expand_totals(build, stream, counts, adj, bperm,
                                        bstart)[0])
    out = []
    if total:
        out.append(ref_joins.join_expand(build, stream, counts, adj, bstart,
                                         bperm, ref_bucket(total),
                                         jt == "right"))
    if jt == "full":
        flags = ref_joins.build_match_flags(build, counts, bstart, bperm)
        out.append(ref_joins.unmatched_build_batch(build, flags,
                                                   stream.schema, False))
    return out


def _frames(batches):
    return [b.to_pandas() for b in batches]


def _assert_batches_equal(got, want):
    got = [df for df in _frames(got) if len(df)]
    want = [df for df in _frames(want) if len(df)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        pd.testing.assert_frame_equal(g.reset_index(drop=True),
                                      w.reset_index(drop=True),
                                      check_dtype=False, check_exact=True)


@pytest.fixture(scope="module")
def join_sides():
    rng = np.random.default_rng(5)
    return (RefBatch.from_pandas(_side(rng, 300, "l", 40)),
            RefBatch.from_pandas(_side(rng, 200, "r", 50)))


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full",
                                "leftsemi", "leftanti"])
@pytest.mark.parametrize("keys", ["int", "int_float"])
def test_hash_join_matches_reference_sort_route(jt, keys, join_sides):
    left, right = join_sides
    lk, rk = ([0], [0]) if keys == "int" else ([0, 1], [0, 1])
    # the JAX side: stream = left except for right outer
    if jt == "right":
        want = _ref_join(left, right, jt, lk, rk)
    else:
        want = _ref_join(right, left, jt, rk, lk)
    got = tpujoin.hash_join([batch_from_reference(left)],
                            [batch_from_reference(right)], jt, lk, rk)
    _assert_batches_equal(got, want)


def _pandas_join(l_df, r_df, jt):
    """pandas oracle on key 'lk' = 'rk' (SQL: null keys never match)."""
    lk = l_df.assign(_li=np.arange(len(l_df)))
    rk = r_df.assign(_ri=np.arange(len(r_df)))
    lnn, rnn = lk[lk.lk.notna()], rk[rk.rk.notna()]
    inner = lnn.merge(rnn, left_on="lk", right_on="rk")
    if jt == "leftsemi":
        return l_df[l_df.lk.isin(rnn.rk)]
    if jt == "leftanti":
        return l_df[~l_df.lk.isin(rnn.rk)]
    parts = [inner]
    if jt in ("left", "full"):
        parts.append(lk[~lk._li.isin(inner._li)])
    if jt in ("right", "full"):
        parts.append(rk[~rk._ri.isin(inner._ri)])
    return pd.concat(parts, ignore_index=True).drop(columns=["_li", "_ri"])


def _canon(df):
    """Rows as strings, sorted: numbers through float64 (pandas turns the
    int columns of outer rows into floats), NaN and null both 'nan'."""
    out = {}
    for c in df.columns:
        s = df[c]
        if pd.api.types.is_numeric_dtype(s.dtype):
            out[c] = [repr(x) for x in s.to_numpy(dtype=np.float64,
                                                  na_value=np.nan)]
        else:
            out[c] = [x if isinstance(x, str) else "nan" for x in s]
    out = pd.DataFrame(out)
    return out.sort_values(list(out.columns)).reset_index(drop=True)


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full",
                                "leftsemi", "leftanti"])
def test_hash_join_many_batches_matches_pandas(jt, rng):
    """Several stream and build batches (the build concatenated once), the
    totals fetched in one copy per join, none for semi and anti."""
    l_df, r_df = _side(rng, 500, "l", 30), _side(rng, 400, "r", 35)
    lb = [DeviceBatch.from_pandas(l_df.iloc[s:s + 128], device="cpu")
          for s in range(0, len(l_df), 128)]
    rb = [DeviceBatch.from_pandas(r_df.iloc[s:s + 100], device="cpu")
          for s in range(0, len(r_df), 100)]
    before = dict(SYNCS.syncs)
    out = tpujoin.hash_join(lb, rb, jt, [0], [0])
    fetches = (SYNCS.syncs.get("join.expandTotals", 0)
               - before.get("join.expandTotals", 0))
    assert fetches == (0 if jt in ("leftsemi", "leftanti") else 1)
    got = pd.concat(_frames(out), ignore_index=True)
    want = _pandas_join(l_df, r_df, jt)
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(_canon(got), _canon(want))


def test_join_expand_rows_do_not_depend_on_slot_layout(rng):
    """join_expand's output is the same row for row whatever slots the
    build took: a probe whose groups sit in another bperm order (slots
    reversed) expands to the same batch."""
    build = batch_from_reference(RefBatch.from_pandas(_side(rng, 200, "r",
                                                            25)))
    stream = batch_from_reference(RefBatch.from_pandas(_side(rng, 150, "l",
                                                             30)))
    bimg = tpujoin._key_images(build, [0])
    bv = joins._key_valid(build, [0])
    T = K.hash_table_size(build.capacity)
    slot, _r, table, counts_t = K.hash_table_build(bimg, bv, T)
    outs = []
    for flip in (False, True):
        s = torch.where(bv, T - 1 - slot, slot) if flip else slot
        c_t = counts_t.flip(0) if flip else counts_t
        starts, bperm = K._placement(s, c_t, bv)
        probe = K.hash_table_probe(table, counts_t, tpujoin._key_images(
            stream, [0]), joins._key_valid(stream, [0]), T)
        probe = torch.where(probe < T, T - 1 - probe, probe) if flip else probe
        counts, bstart = K._lookup(probe, c_t, starts)
        total = int(counts.sum())
        outs.append(joins.join_expand(build, stream, counts, counts, bstart,
                                      bperm, 1 << (total - 1).bit_length(),
                                      False).to_pandas())
    pd.testing.assert_frame_equal(outs[0], outs[1])
    assert len(outs[0]) > 0


def test_join_type_and_key_checks():
    """A cross join takes no keys (and gives every pair without them); an
    unknown join type and a string key raise."""
    b = DeviceBatch.from_pandas(pd.DataFrame({"k": [1, 2]}), device="cpu")
    with pytest.raises(ValueError, match="cross join takes no keys"):
        tpujoin.hash_join([b], [b], "cross", [0], [0])
    out = tpujoin.hash_join([b], [b], "cross", [], [])[0].to_pandas()
    assert sorted(zip(out.iloc[:, 0], out.iloc[:, 1])) == [
        (1, 1), (1, 2), (2, 1), (2, 2)]
    with pytest.raises(NotImplementedError, match="asof"):
        tpujoin.hash_join([b], [b], "asof", [0], [0])
    s = DeviceBatch.from_pandas(pd.DataFrame({"s": ["a", "b"]}),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="string join keys"):
        tpujoin.hash_join([s], [s], "inner", [0], [0])


# ---------------------------------------------------------------------------
# The slice: Q3 and Q4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    out = {"lineitem": G.gen_lineitem(SF), "orders": G.gen_orders(SF),
           "customer": G.gen_customer(SF)}
    pd.testing.assert_frame_equal(out["orders"], ref_gen.gen_orders(SF))
    pd.testing.assert_frame_equal(out["customer"], ref_gen.gen_customer(SF))
    pd.testing.assert_frame_equal(out["lineitem"], ref_gen.gen_lineitem(SF))
    return out


def _pandas_q3(fr):
    li, o, c = fr["lineitem"], fr["orders"], fr["customer"]
    cut = np.datetime64("1995-03-15")
    m = (c[c.c_mktsegment == "BUILDING"]
         .merge(o[o.o_orderdate < cut], left_on="c_custkey",
                right_on="o_custkey")
         .merge(li[li.l_shipdate > cut], left_on="o_orderkey",
                right_on="l_orderkey"))
    m = m.assign(revenue=m.l_extendedprice * (1 - m.l_discount))
    g = m.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False).revenue.sum()
    return g.sort_values(["revenue", "o_orderdate"],
                         ascending=[False, True]).reset_index(drop=True)


def _pandas_q4(fr):
    li, o = fr["lineitem"], fr["orders"]
    late = li[li.l_commitdate < li.l_receiptdate]
    oo = o[(o.o_orderdate >= np.datetime64("1993-07-01"))
           & (o.o_orderdate < np.datetime64("1993-10-01"))]
    oo = oo[oo.o_orderkey.isin(late.l_orderkey)]
    return (oo.groupby("o_orderpriority").size().rename("order_count")
            .reset_index())


def _assert_ordered(got, want, sort_cols):
    """Rows in the query's order; rows tied on the sort key as a set.
    Dates and integers exact, floats at rtol 1e-9."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c], want[c]
        if pd.api.types.is_float_dtype(w.dtype):
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64),
                                       rtol=F64_RTOL, err_msg=c)
        elif pd.api.types.is_datetime64_any_dtype(w.dtype):
            np.testing.assert_array_equal(
                g.to_numpy().astype("datetime64[us]"),
                w.to_numpy().astype("datetime64[us]"), err_msg=c)
    keyed = [c for c in got.columns if c not in sort_cols]
    for _, grp in want.groupby(sort_cols, sort=False):
        rows = grp.index
        gk = got.loc[rows, keyed].astype(str).sort_values(keyed)
        wk = want.loc[rows, keyed].astype(str).sort_values(keyed)
        np.testing.assert_array_equal(gk.to_numpy(), wk.to_numpy())


def _jax_query(session, qname, fr):
    def run(s):
        tables = {n: s.create_dataframe(df, 2) for n, df in fr.items()}
        return QUERIES[qname](s, tables)
    return with_tpu_session(run)


def test_q3_matches_reference_and_pandas(session, frames):
    got = J.run_q3(frames, 1 << 12, device="cpu")
    want = _pandas_q3(frames)
    assert len(want) >= J.Q3_LIMIT
    _assert_ordered(got, want.head(J.Q3_LIMIT)[list(got.columns)],
                    ["revenue", "o_orderdate"])
    ref = _jax_query(session, "q3", frames)
    _assert_ordered(got, ref[list(got.columns)], ["revenue", "o_orderdate"])


def test_q4_matches_reference_and_pandas(session, frames):
    got = J.run_q4(frames, 1 << 12, device="cpu")
    want = _pandas_q4(frames)
    assert list(got.o_orderpriority) == list(want.o_orderpriority)
    assert list(got.order_count) == list(want.order_count)
    ref = _jax_query(session, "q4", frames)
    assert list(got.o_orderpriority) == list(ref.o_orderpriority)
    assert list(got.order_count) == list(ref.order_count)


def test_q3_syncs_once_per_join_and_q4_never(frames):
    t3 = J.upload_q3(frames, 1 << 12, device="cpu")
    t4 = J.upload_q4(frames, 1 << 12, device="cpu")
    before = SYNCS.total()
    J.q3_from_batches(t3)
    assert SYNCS.total() - before == 2
    before = SYNCS.total()
    J.q4_from_batches(t4)
    assert SYNCS.total() - before == 0


# ---------------------------------------------------------------------------
# String equality with a literal (Q3's c_mktsegment = 'BUILDING')
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lit", ["ab", "c", "zz"])
@pytest.mark.parametrize("op", ["eq", "neq", "lit_first"])
def test_string_equal_literal_matches_reference(lit, op, rng):
    from spark_rapids_tpu.sql import functions as RF
    from spark_rapids_tpu.sql.exprs.core import bind_references as ref_bind
    from spark_rapids_tpu.sql.exprs.evalbridge import (
        make_context as ref_ctx, to_device_column as ref_to_col,
    )
    from spark_rapids_tpu_torch.models.q1_step import filter_rows
    from spark_rapids_tpu_torch.sql import functions as F
    ref = RefBatch.from_pandas(_side(rng, 200, "l", 10))
    cond, ref_cond = {
        "eq": (F.col("ls") == lit, RF.col("ls") == lit),
        "neq": (F.col("ls") != lit, RF.col("ls") != lit),
        "lit_first": (F.lit(lit) == F.col("ls"), RF.lit(lit) == RF.col("ls")),
    }[op]
    ctx = ref_ctx(ref)
    pred = ref_to_col(ctx, ref_bind(ref_cond.expr, ref.schema)
                      .eval_device(ctx))
    want = ref_rowops_filter(ref, pred)
    got = filter_rows(batch_from_reference(ref), cond)
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


def ref_rowops_filter(ref, pred):
    from spark_rapids_tpu.ops import rowops as ref_rowops
    return ref_rowops.filter_batch(ref, pred.data & pred.validity)


def test_string_comparisons_outside_the_slice_raise(rng):
    """The comparisons that raised before string comparisons were ported
    (an order comparison with a literal, column against column) now give
    the JAX package's rows."""
    from spark_rapids_tpu.sql import functions as RF
    from spark_rapids_tpu.sql.exprs.core import bind_references as ref_bind
    from spark_rapids_tpu.sql.exprs.evalbridge import (
        make_context as ref_ctx, to_device_column as ref_to_col,
    )
    from spark_rapids_tpu_torch.models.q1_step import filter_rows
    from spark_rapids_tpu_torch.sql import functions as F
    ref = RefBatch.from_pandas(_side(rng, 50, "l", 10))
    for cond, ref_cond in ((F.col("ls") < "b", RF.col("ls") < "b"),
                           (F.col("ls") == F.col("ls"),
                            RF.col("ls") == RF.col("ls"))):
        ctx = ref_ctx(ref)
        pred = ref_to_col(ctx, ref_bind(ref_cond.expr, ref.schema)
                          .eval_device(ctx))
        want = ref_rowops_filter(ref, pred).to_pandas()
        got = filter_rows(batch_from_reference(ref), cond).to_pandas()
        pd.testing.assert_frame_equal(got, want)
        assert len(got) > 0


@pytest.mark.parametrize("case", ["random", "skewed", "multi_key"])
def test_hash_join_lookup_contract(case, rng):
    """Per stream row: the build rows of its key (int32 count, 0 where it
    has none) and the first position of their group in bperm (0 where it
    has none), as the plain probe and ``_lookup`` give them; the group
    holds exactly the matching build rows."""
    k = 2 if case == "multi_key" else 1
    hi = 3 if case == "skewed" else 60
    nb, ns = 300, 200
    bimg = [rng.integers(0, hi, nb) for _ in range(k)]
    simg = [rng.integers(0, hi + 20, ns) for _ in range(k)]
    bv, sv = rng.random(nb) < 0.9, rng.random(ns) < 0.9
    T = K.hash_table_size(nb)
    jt = K.hash_join_build([_t(w) for w in bimg], _t(bv), T)
    match, first = K.hash_join_lookup(jt, [_t(w) for w in simg], _t(sv))
    assert match.dtype == first.dtype == torch.int32
    assert match.shape == first.shape == (ns,)
    slot = K.hash_table_probe(jt.table, jt.counts, [_t(w) for w in simg],
                              _t(sv), T)
    want = K._lookup(slot, jt.counts, jt.starts)
    assert torch.equal(match, want[0]) and torch.equal(first, want[1])
    bkeys = list(zip(*bimg))
    for i in range(ns):
        rows = [r for r in range(nb)
                if bv[r] and sv[i] and bkeys[r] == tuple(w[i] for w in simg)]
        assert int(match[i]) == len(rows)
        if not rows:
            assert int(first[i]) == 0
            continue
        got = jt.bperm[int(first[i]):int(first[i]) + len(rows)]
        assert sorted(got.tolist()) == rows
