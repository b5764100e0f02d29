"""The port's Sort and Limit pieces against the JAX package, on the CPU:
``lexsort_permutation``, ``sort_key_operands``, ``sort_batch`` and
``slice_batch``/``slice_batch_to`` on ``batch_from_reference`` copies of the
same batches. Mixed ascending and descending keys, nulls first and last,
float edge values (-0.0, NaN, infinities), dictionary string keys and
plain string keys (char slabs in the port, 64-byte prefix images). The
sort permutation must be exact, so the sorted batches agree row for row."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.ops import rowops as ref_rowops
from spark_rapids_tpu.ops import sortops as ref_sortops
from spark_rapids_tpu_torch.ops import rowops, sortops
from spark_rapids_tpu_torch.testing.reference import batch_from_reference
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

EDGE_F64 = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5, 1e-300]


def _frame(rng, n=400):
    f = pd.Series(np.asarray(EDGE_F64)[rng.integers(0, len(EDGE_F64), n)],
                  dtype="Float64")
    f[rng.random(n) < 0.1] = pd.NA
    i = pd.Series(rng.integers(-3, 3, n), dtype="Int64")
    i[rng.random(n) < 0.15] = pd.NA
    s = np.array(["pear", "apple", "fig", None], dtype=object)[
        rng.integers(0, 4, n)]
    ts = pd.Series(pd.to_datetime(rng.integers(0, 5, n) * 86400, unit="s"))
    # a numpy float column holds NaN as a value (the nullable "f" turns
    # NaN into NULL)
    raw = np.asarray(EDGE_F64)[rng.integers(0, len(EDGE_F64), n)]
    big = rng.integers(-(1 << 62), 1 << 62, n)
    # a plain string column (no dictionary: a char slab in the port):
    # prefixes of one another, the empty string, ties, nulls
    words = np.array(["", "a", "ab", "abc", "b", "ba", None] + [
        f"w{k:03d}" for k in range(300)], dtype=object)
    plain = words[rng.integers(0, len(words), n)]
    return pd.DataFrame({"f": f, "i": i, "s": s, "ts": ts, "big": big,
                         "raw": raw, "row": np.arange(n), "plain": plain})


# (key columns, ascending, nulls first)
ORDERS = [
    ([0], [True], [True]),
    ([0], [False], [False]),
    ([1, 0], [True, False], [False, True]),
    ([2, 1], [False, True], [True, False]),
    ([3, 2, 0, 1], [True, False, True, False], [False, False, True, True]),
    ([4], [False], [True]),
    ([5, 2], [False, True], [True, True]),
    ([5, 1], [True, False], [False, False]),
    ([7, 6], [True, True], [True, True]),
    ([7, 1], [False, True], [False, True]),
]


@pytest.mark.parametrize("order", range(len(ORDERS)))
def test_sort_batch_matches_reference(order, rng):
    keys, asc, nf = ORDERS[order]
    ref = RefBatch.from_pandas(_frame(rng), dict_numerics=False)
    ref = ref_rowops.slice_batch(ref, jnp.asarray(0, jnp.int32),
                                 jnp.asarray(370, jnp.int32))  # padding
    port = batch_from_reference(ref)
    want_perm = np.asarray(ref_sortops.sort_permutation(ref, keys, asc, nf))
    got_perm = sortops.sort_permutation(port, keys, asc, nf)
    np.testing.assert_array_equal(got_perm.numpy(), want_perm)
    got = sortops.sort_batch(port, keys, asc, nf).to_pandas()
    want = ref_sortops.sort_batch(ref, keys, asc, nf).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_sort_key_operands_bit_identical(rng):
    ref = RefBatch.from_pandas(_frame(rng), dict_numerics=False)
    port = batch_from_reference(ref)
    keys, asc, nf = ORDERS[4]
    want = ref_sortops.sort_key_operands(ref, keys, asc, nf, allow_dict=True)
    got = sortops.sort_key_operands(port, keys, asc, nf, allow_dict=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w).astype(np.uint64))


@pytest.mark.parametrize("nops", [1, 3, 7])
def test_lexsort_permutation_matches_reference(nops, rng):
    """Direct (<= 4 operands) and LSD (wider) spellings of the reference,
    on full-range unsigned images with many ties."""
    ops = [rng.integers(0, 4, 500).astype(np.uint64) << np.uint64(62)
           | rng.integers(0, 3, 500).astype(np.uint64)
           for _ in range(nops)]
    want = np.asarray(ref_sortops.lexsort_permutation(
        [jnp.asarray(o) for o in ops]))
    got = sortops.lexsort_permutation([torch.from_numpy(o.view(np.int64))
                                       for o in ops])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start,count,cap", [(0, 10, None), (5, 100, None),
                                             (360, 50, None), (400, 5, None),
                                             (0, 10, 16), (3, 40, 64)])
def test_slice_batch_matches_reference(start, count, cap, rng):
    ref = RefBatch.from_pandas(_frame(rng))
    port = batch_from_reference(ref)
    s, c = jnp.asarray(start, jnp.int32), jnp.asarray(count, jnp.int32)
    if cap is None:
        want = ref_rowops.slice_batch(ref, s, c)
        got = rowops.slice_batch(port, start, count)
        assert got.capacity == port.capacity
    else:
        want = ref_rowops.slice_batch_to(ref, s, c, cap)
        got = rowops.slice_batch_to(port, torch.tensor(start),
                                    torch.tensor(count), cap)
        assert got.capacity == cap
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas(),
                                  check_exact=True)


def test_rank_of_iota_matches_reference(rng):
    vals = np.sort(rng.integers(-3, 70, 50)).astype(np.int32)
    want = np.asarray(ref_rowops.rank_of_iota(jnp.asarray(vals), 64))
    got = rowops.rank_of_iota(torch.from_numpy(vals), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.searchsorted(vals, np.arange(64), side="right"))
