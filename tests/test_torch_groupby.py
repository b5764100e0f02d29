"""The port's sort-based grouping against the JAX package, on the CPU:
every branch of ``ops/aggregate._grouped_reduce`` (sorted payload, sorted
space, row space through its slot and sort halves, the hash branch
declining), and the row hashes and string key images bit for bit. The same
seeded frames go through both packages (the port's batches are built from
the JAX package's buffers, plain strings as char slabs); keys and integers
must match exactly, float64 at rtol 1e-9, compared by key."""

import math

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.columnar import dtype as ref_dtypes
from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.columnar.batch import Schema as RefSchema
from spark_rapids_tpu.ops import aggregate as ref_agg
from spark_rapids_tpu.ops import groupby as ref_gb
from spark_rapids_tpu.ops import hashing as ref_hashing
from spark_rapids_tpu.ops import sortops as ref_sortops
from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.ops import aggregate, groupby, hashing, sortops
from spark_rapids_tpu_torch.testing import datagen
from spark_rapids_tpu_torch.testing.reference import batch_from_reference

F64_RTOL = 1e-9


def _words(rng, n, card, width):
    """``card`` distinct strings of up to ``width`` bytes (shared prefixes,
    an empty string and a NUL-free tail), drawn for ``n`` rows."""
    base = ["", "a", "ab", "abc", "b", "zz" * (width // 2)]
    base += ["w%0*d" % (width - 1, i) for i in range(card)]
    vals = np.asarray(base[:card], dtype=object)
    return vals[rng.integers(0, card, n)]


def _frame(rng, n):
    ikey = pd.Series(rng.integers(-400, 400, n), dtype="Int64")
    ikey[rng.random(n) < 0.1] = pd.NA
    # NaN is a value of a numpy float column (a NaN key makes the upload
    # skip the dictionary); nulls ride a nullable column
    fkey = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25, 1e300]), n)
    fkeyn = np.round(rng.standard_normal(n) * 100, 1)
    fkeyn[rng.random(n) < 0.1] = -0.0
    fkeyn = pd.Series(fkeyn, dtype="Float64")
    fkeyn[rng.random(n) < 0.1] = pd.NA
    # dates upload as timestamps, as the TPC-H frames' do
    dkey = pd.Series(np.datetime64("1995-01-01")
                     + rng.integers(0, 1000, n).astype("timedelta64[D]"))
    dkey[rng.random(n) < 0.1] = pd.NaT
    slab = pd.Series(_words(rng, n, n // 3, 24), dtype=object)
    slab[rng.random(n) < 0.1] = None
    dstr = pd.Series(np.array(["x", "yy", "", "zzz", "a"], dtype=object)[
        rng.integers(0, 5, n)])
    dstr[rng.random(n) < 0.1] = None
    ival = pd.Series(rng.integers(-1000, 1000, n), dtype="Int64")
    ival[rng.random(n) < 0.2] = pd.NA
    fval = rng.standard_normal(n) * 1e3
    fval[rng.random(n) < 0.05] = np.nan
    return pd.DataFrame({"ikey": ikey, "fkey": fkey, "fkeyn": fkeyn,
                         "dkey": dkey, "slab": slab, "dstr": dstr,
                         "ival": ival, "fval": fval,
                         "bval": rng.random(n) < 0.5})


def _dict_frame(rng, n, cards, tuples=None):
    """Dictionary-encoded int keys with the given cardinalities; with
    ``tuples``, the rows draw from that many key tuples only (few groups
    under a large joint table)."""
    if tuples is None:
        cols = {f"k{i}": rng.integers(0, c, n).astype(np.int32)
                for i, c in enumerate(cards)}
    else:
        pick = rng.integers(0, tuples, n)
        cols = {f"k{i}": (pick % c).astype(np.int32)
                for i, c in enumerate(cards)}
    k0 = pd.Series(cols["k0"], dtype="Int32")
    k0[rng.random(n) < 0.05] = pd.NA
    cols["k0"] = k0
    cols["ival"] = rng.integers(-5, 5, n).astype(np.int64)
    cols["fval"] = rng.standard_normal(n)
    return pd.DataFrame(cols)


_NUMERIC_KINDS = ["count_valid", "sum", "min", "max", "first", "last",
                  "first_valid", "last_valid"]


def _reductions(schema, cols, kinds):
    """(kind, column index, output dtype) for each kind over each column."""
    out = []
    for c in cols:
        i = schema.index_of(c)
        dt = schema.dtypes[i]
        for k in kinds:
            if k == "count_valid":
                odt = dtypes.INT64
            elif k == "sum":
                odt = dtypes.FLOAT64 if dt.name.startswith("float") \
                    else dtypes.INT64
            else:
                odt = dt
            out.append((k, i, odt))
    return out


def _out_schemas(schema, key_idx, reds):
    names = [schema.names[k] for k in key_idx] + [
        f"r{i}" for i in range(len(reds))]
    dts = [schema.dtypes[k] for k in key_idx] + [d for _, _, d in reds]
    return (Schema(names, dts),
            RefSchema(names, [ref_dtypes.by_name(d.name) for d in dts]))


def _rows(cols, n):
    """Rows of (values, validity) pairs as canonical tuples: floats as
    their repr with -0.0 folded into 0.0 (one group), None where null."""
    out = []
    for i in range(n):
        row = []
        for vals, valid in cols:
            if not valid[i]:
                row.append(None)
                continue
            v = vals[i]
            if isinstance(v, (float, np.floating)):
                v = float(v)
                v = "nan" if math.isnan(v) else (0.0 if v == 0 else v)
            elif isinstance(v, (np.integer, np.bool_)):
                v = v.item()
            row.append(v)
        out.append(tuple(row))
    return out


def _assert_same(port_out, ref_out, nkeys):
    n = int(port_out.num_rows)
    assert n == int(np.asarray(ref_out.num_rows))
    got = _rows([c.to_numpy(n) for c in port_out.columns], n)
    want = _rows([c.to_numpy(n) for c in ref_out.columns], n)
    order = lambda r: repr(r[:nkeys])  # noqa: E731
    got, want = sorted(got, key=order), sorted(want, key=order)
    for g, w in zip(got, want):
        assert g[:nkeys] == w[:nkeys]
        for a, b in zip(g[nkeys:], w[nkeys:]):
            if isinstance(b, float):
                assert isinstance(a, float) and math.isclose(
                    a, b, rel_tol=F64_RTOL, abs_tol=1e-6), (g, w)
            else:
                assert a == b, (g, w)


def _run(df, keys, reds_of, hash_table=None, blocked=0, n_live=None):
    ref = RefBatch.from_pandas(df, blocked_chars=blocked)
    if n_live is not None:  # trailing rows dead (a filtered batch)
        import jax.numpy as jnp
        ref = RefBatch(ref.schema, ref.columns, jnp.asarray(n_live,
                                                           jnp.int32))
    port = batch_from_reference(ref)
    for c in ref.columns:
        if c.dtype.is_string and c.has_slab:
            # the reference's string min/max traces a refinement inside a
            # lax.cond that unpacks a slab and caches the result on the
            # column, which leaks a tracer when run eagerly: unpack it
            # first (its images are the same bits either way)
            c.offsets  # noqa: B018
    key_idx = [port.schema.index_of(k) for k in keys]
    reds = reds_of(port.schema)
    schema, ref_schema = _out_schemas(port.schema, key_idx, reds)
    ref_reds = [(k, i, ref_dtypes.by_name(d.name)) for k, i, d in reds]
    aggregate.reset_branches()
    got = aggregate._grouped_reduce(port, key_idx, reds, schema,
                                    hash_table=hash_table)
    want = ref_agg._grouped_reduce(ref, key_idx, ref_reds, ref_schema,
                                   force_single_group=False,
                                   hash_table=hash_table)
    _assert_same(got, want, len(keys))
    return port, dict(aggregate.BRANCHES)


_PAYLOAD_CASES = {
    "int": ["ikey"],
    "float": ["fkey"],
    "float_nullable": ["fkeyn"],
    "date": ["dkey"],
    "dict_string_and_int": ["dstr", "ikey"],
    "slab_string": ["slab"],
    "slab_string_and_float": ["slab", "fkey"],
}


@pytest.mark.parametrize("case", sorted(_PAYLOAD_CASES))
def test_sorted_payload_matches_reference(case, rng):
    df = _frame(rng, 700)
    port, branches = _run(df, _PAYLOAD_CASES[case], lambda s: _reductions(
        s, ["ival", "fval", "bval"], _NUMERIC_KINDS) + _reductions(
        s, ["slab"], ["count_valid"]), n_live=650)
    assert branches == {"sorted_payload": 1}
    if "slab" in case:
        assert port.column("slab").has_slab


@pytest.mark.parametrize("blocked", [0, 64], ids=["packed", "slab"])
@pytest.mark.parametrize("keys", [["ikey"], ["dstr"], []],
                         ids=["grouped", "dict_key", "global"])
def test_sorted_space_string_reductions_match_reference(keys, blocked, rng):
    df = _frame(rng, 600)
    _port, branches = _run(df, keys, lambda s: _reductions(
        s, ["slab", "dstr"], ["min", "max", "first", "last", "first_valid",
                              "last_valid", "count_valid"]) + _reductions(
        s, ["ival"], ["sum"]), blocked=blocked, n_live=580)
    assert branches == ({"single": 1} if not keys else {"sorted_space": 1})


def test_string_min_max_over_ties_and_empty_strings(rng):
    """Equal strings, prefixes and the empty string: min/max are byte order
    (a valid empty string is the max's last candidate, never a null's)."""
    n = 400
    df = pd.DataFrame({
        "k": rng.integers(0, 6, n).astype(np.int64),
        "s": pd.Series(np.array(["", "a", "a\x01", "ab", "abc" * 7, None],
                                dtype=object)[rng.integers(0, 6, n)])})
    _run(df, ["k"], lambda s: _reductions(s, ["s"], ["min", "max", "first",
                                                     "last"]))


@pytest.mark.parametrize("half", ["slot", "sort"])
def test_rowspace_matches_reference(half, rng):
    # four dictionary keys, joint table ((c+1) each) above DICT_SLOT_MAX;
    # few groups fit the slot table, thousands collide in it
    if half == "slot":
        df = _dict_frame(rng, 6000, [4, 3, 50, 11], tuples=50)
    else:
        df = _dict_frame(rng, 3000, [40, 40, 40, 3])
    port, branches = _run(df, [f"k{i}" for i in range(4)], lambda s:
                          _reductions(s, ["ival", "fval"], _NUMERIC_KINDS),
                          n_live=2900)
    assert all(port.columns[i].dict_values is not None for i in range(4))
    assert branches == {"rowspace": 1, f"rowspace_{half}": 1}


@pytest.mark.parametrize("why", ["over_budget", "slab_key"])
def test_hash_branch_declines_to_sorted_payload(why, rng):
    df = _frame(rng, 700)
    keys = ["ikey", "fkey"] if why == "over_budget" else ["slab", "ikey"]
    hash_table = 16 if why == "over_budget" else 1 << 20
    _port, branches = _run(df, keys, lambda s: _reductions(
        s, ["ival", "fval"], ["sum", "count_valid", "min", "first"]),
        hash_table=hash_table)
    assert branches == {"sorted_payload": 1}


def test_hash_branch_runs_within_budget(rng):
    df = _frame(rng, 700)
    _port, branches = _run(df, ["ikey", "fkey"], lambda s: _reductions(
        s, ["ival", "fval"], ["sum", "count_valid", "max", "last"]),
        hash_table=1 << 20)
    assert branches == {"hash": 1}


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("blocked", [0, 64], ids=["packed", "slab"])
def test_row_hashes_and_string_images_bit_identical(blocked, rng):
    df = _frame(rng, 500)
    ref = RefBatch.from_pandas(df, blocked_chars=blocked)
    port = batch_from_reference(ref)
    keys = [port.schema.index_of(k) for k in
            ("ikey", "fkey", "dkey", "slab", "dstr", "bval")]
    for local in (False, True):
        got = groupby.row_hashes(port, keys, batch_local=local)
        want = ref_gb.row_hashes(ref, keys, batch_local=local)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u64(g), np.asarray(w))
    for name in ("slab", "dstr"):
        pc, rc = port.column(name), ref.column(name)
        for g, w in zip(hashing.string_poly_hashes_col(pc),
                        ref_hashing.string_poly_hashes_col(rc)):
            np.testing.assert_array_equal(_u64(g), np.asarray(w))
        got = sortops._string_prefix_chunks(pc)
        want = ref_sortops._string_prefix_chunks(rc)
        assert len(got) == len(want) == sortops.STRING_PREFIX_CHUNKS + 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u64(g), np.asarray(w))
        np.testing.assert_array_equal(
            _u64(sortops.string_prefix8(pc)),
            np.asarray(ref_sortops.string_prefix8(rc)))


def test_group_rows_matches_reference(rng):
    df = _frame(rng, 500)
    ref = RefBatch.from_pandas(df, blocked_chars=64)
    port = batch_from_reference(ref)
    keys = [port.schema.index_of(k) for k in ("slab", "ikey")]
    got = groupby.group_rows(port, keys)
    want = ref_gb.group_rows(ref, keys)
    for a in ("perm", "group_id_sorted", "boundary", "num_groups",
              "rep_rows"):
        np.testing.assert_array_equal(getattr(got, a).numpy(),
                                      np.asarray(getattr(want, a)), a)


def test_datagen_frames_group_alike(rng):
    """Null-heavy, skewed and NaN keys from the generators of
    ``testing/datagen.py`` (a copy of the JAX package's)."""
    df = datagen.gen_df(np.random.default_rng(9), [
        ("k", datagen.SkewedKeyGen(num_keys=30, nullable=True,
                                   null_prob=0.3)),
        ("f", datagen.RepeatSeqGen([0.0, -0.0, float("nan"), None, 2.5],
                                   pandas_dtype="Float64")),
        ("s", datagen.StringGen(max_len=12)),
        ("v", datagen.IntegerGen())], n=800)
    _port, branches = _run(df, ["k", "f"], lambda s: _reductions(
        s, ["v"], ["sum", "min", "max", "count_valid"]) + _reductions(
        s, ["s"], ["min", "max"]), blocked=64)
    assert branches == {"sorted_space": 1}

