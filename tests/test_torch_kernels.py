"""The port's kernels and hashing against the JAX package, on the CPU.

On a CPU tensor each port wrapper runs its plain version; the JAX side runs
its default jnp twins. Exact equality for permutations, counts, integers
and key images; float64 sums at rtol 1e-9 (the two sum in other orders).
The CUDA kernels are held against the plain versions in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.ops import floatbits as ref_floatbits
from spark_rapids_tpu.ops import hashing as ref_hashing
from spark_rapids_tpu.ops import pallas_kernels as ref_pk
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops.floatbits import f64_bits
from spark_rapids_tpu_torch.ops.hashing import splitmix64

F64_RTOL = 1e-9

EDGE_F64 = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0,
                     5e-324, -5e-324, 2.2250738585072014e-308, 1.5e300,
                     -3.25, np.finfo(np.float64).max,
                     np.finfo(np.float64).min])
EDGE_I64 = np.array([0, 1, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min,
                     42, -(1 << 40)], dtype=np.int64)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_splitmix64_bit_identical(rng):
    x = np.concatenate([EDGE_I64.view(np.uint64),
                        rng.integers(0, 2 ** 63, 500, dtype=np.uint64) * 2
                        + 1]).astype(np.uint64)
    want = np.asarray(ref_hashing.splitmix64(jnp.asarray(x)))
    got = _u64(splitmix64(torch.from_numpy(x.view(np.int64))))
    np.testing.assert_array_equal(got, want)


def test_f64_bits_bit_identical(rng):
    x = np.concatenate([EDGE_F64, rng.standard_normal(300) * 1e5])
    want = np.asarray(ref_floatbits.f64_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(_u64(f64_bits(torch.from_numpy(x))), want)
    np.testing.assert_array_equal(want, ref_floatbits.np_f64_bits(x))


@pytest.mark.parametrize("kind", ["float64", "int64", "int32", "bool",
                                  "dict_string"])
def test_u64_key_image_bit_identical(kind, rng):
    import pandas as pd

    from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
    from spark_rapids_tpu.ops import sortops as ref_sortops
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image
    from spark_rapids_tpu_torch.testing.reference import batch_from_reference
    n = len(EDGE_F64)
    if kind == "float64":
        s = pd.Series(EDGE_F64)
    elif kind == "int64":
        s = pd.Series(np.resize(EDGE_I64, n)).astype("Int64")
        s[3] = pd.NA  # a null key
    elif kind == "int32":
        s = pd.Series(rng.integers(-2 ** 31, 2 ** 31, n), dtype="int32")
    elif kind == "bool":
        s = pd.Series(rng.random(n) < 0.5)
    else:
        s = pd.Series(np.array(["b", "a", None, "c"] * 4, dtype=object)[:n])
    ref = RefBatch.from_pandas(pd.DataFrame({"k": s}))
    port = batch_from_reference(ref)
    want = ref_sortops.u64_key_image(ref.columns[0], allow_dict=True)
    got = u64_key_image(port.columns[0], allow_dict=True)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(_u64(got[0]), np.asarray(want[0]))


@pytest.mark.parametrize("case", ["all", "none", "empty", "random",
                                  "ragged"])
def test_compact_permutation_matches_reference(case, rng):
    n = {"empty": 0, "ragged": 4099}.get(case, 2048)
    keep = {"all": np.ones(n, bool), "none": np.zeros(n, bool)}.get(
        case, rng.random(n) < 0.37)
    perm, total = K.compact_permutation(torch.from_numpy(keep))
    assert perm.dtype == torch.int32 and total.dtype == torch.int32
    if n == 0:
        assert perm.numel() == 0 and int(total) == 0
        return
    want_perm, want_total = ref_pk.compact_permutation(jnp.asarray(keep))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    assert int(total) == int(want_total) == int(keep.sum())


# one compiled program per size, not one per operation
_REF_COMPACT = jax.jit(ref_pk.compact_permutation)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 3 * 4096 + 1,
                               (1 << 16) + 13])
def test_compact_permutation_tile_edges(n, density):
    """Sizes around the kernel's 4096-row tile: the plain version equals
    the JAX package's ``compact_permutation`` and the one PyTorch call
    that computes the same permutation (a stable argsort of ~keep)."""
    keep = np.random.default_rng(n + int(density * 100)).random(n) < density
    keep_t = torch.from_numpy(keep)
    perm, total = K.compact_permutation(keep_t)
    assert perm.dtype == torch.int32 and total.dtype == torch.int32
    argsort = torch.argsort((~keep_t).to(torch.uint8), stable=True)
    np.testing.assert_array_equal(perm.numpy(), argsort.numpy())
    assert int(total) == int(keep.sum())
    if n:
        want_perm, want_total = _REF_COMPACT(jnp.asarray(keep))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
        assert int(total) == int(want_total)


def test_hash_table_size_matches_reference():
    for cap in (0, 1, 8, 9, 1000, 1 << 20, (1 << 22) + 3):
        assert K.hash_table_size(cap) == ref_pk.hash_table_size(cap)


def _groups(counts, rep, accs, nels):
    """{first-arrival row: (count, accs, nels)} over used slots."""
    counts, rep = np.asarray(counts), np.asarray(rep)
    out = {}
    for s in np.nonzero(counts > 0)[0]:
        out[int(rep[s])] = (int(counts[s]),
                            [np.asarray(a)[s] for a in accs],
                            [int(np.asarray(ne)[s]) for ne in nels])
    return out


def _check_against_reference(images, valid, jobs):
    T = K.hash_table_size(len(valid))
    got = K.hash_grouped_aggregate(
        [torch.from_numpy(im.view(np.int64)) for im in images],
        torch.from_numpy(valid),
        [(k, torch.from_numpy(d), torch.from_numpy(e)) for k, d, e in jobs],
        T)
    want = ref_pk.hash_grouped_aggregate(
        [jnp.asarray(im) for im in images], jnp.asarray(valid),
        [(k, jnp.asarray(d), jnp.asarray(e)) for k, d, e in jobs], T)
    g = _groups(got[0].numpy(), got[1].numpy(), [a.numpy() for a in got[2]],
                [ne.numpy() for ne in got[3]])
    w = _groups(*want)
    assert g.keys() == w.keys()
    for row, (cnt, accs, nels) in w.items():
        gcnt, gaccs, gnels = g[row]
        assert gcnt == cnt and gnels == nels
        for (kind, data, _e), a, b, ne in zip(jobs, gaccs, accs, nels):
            if ne == 0:
                continue  # accumulator undefined where nothing was eligible
            if data.dtype == np.float64 and kind == "sum":
                np.testing.assert_allclose(a, b, rtol=F64_RTOL)
            else:
                assert a == b, (kind, data.dtype, a, b)
    return g


def _jobs(rng, n, valid):
    pos = np.arange(n, dtype=np.int32)
    return [
        ("sum", rng.integers(-50, 50, n).astype(np.int64),
         rng.random(n) < 0.8),
        ("sum", rng.random(n) * 1e3, np.ones(n, bool)),
        ("min", rng.integers(-1000, 1000, n).astype(np.int32),
         rng.random(n) < 0.7),
        ("max", rng.integers(-1000, 1000, n).astype(np.int32),
         rng.random(n) < 0.7),
        ("min", rng.random(n) * 100 - 50, rng.random(n) < 0.9),
        ("max", rng.random(n) * 100 - 50, rng.random(n) < 0.9),
        ("min", pos, valid),          # first
        ("max", pos, valid),          # last
        ("sum", np.ones(n, np.int64), rng.random(n) < 0.5),  # count
    ]


def test_hash_grouped_aggregate_matches_reference(rng):
    n = 600
    keys = rng.integers(0, 40, n).astype(np.uint64)
    valid = rng.random(n) < 0.9
    g = _check_against_reference([keys], valid, _jobs(rng, n, valid))
    assert len(g) == len(np.unique(keys[valid]))


def test_hash_grouped_aggregate_null_keys_and_two_images(rng):
    # the aggregate's key layout: null keys take image 0 plus a validity
    # signature image, so a null and a real 0 stay apart
    n = 500
    keys = rng.integers(0, 12, n).astype(np.uint64)
    key_valid = rng.random(n) < 0.8
    images = [np.where(key_valid, keys, np.uint64(0)),
              key_valid.astype(np.uint64)]
    valid = rng.random(n) < 0.95
    g = _check_against_reference(images, valid, _jobs(rng, n, valid))
    distinct = {(int(k) if kv else None) for k, kv, v
                in zip(keys, key_valid, valid) if v}
    assert len(g) == len(distinct)


def test_hash_grouped_aggregate_skew_and_all_invalid(rng):
    n = 256
    keys = np.full(n, 9, np.uint64)
    jobs = [("sum", np.arange(n, dtype=np.int64), np.ones(n, bool)),
            ("max", np.arange(n, dtype=np.int64), np.ones(n, bool))]
    g = _check_against_reference([keys], np.ones(n, bool), jobs)
    assert list(g) == [0] and g[0][0] == n
    assert _check_against_reference([keys], np.zeros(n, bool), jobs) == {}


@pytest.mark.parametrize("k,dtypes,stride,state", [
    (2, [torch.float64], 48, -1),   # the Q18 partial: 36 bytes
    (4, [torch.float64], 64, 32),   # Q3's group-by: 60 bytes
    (1, [torch.int32], 32, -1),
    (3, [torch.int64, torch.int32, torch.float64, torch.int32, torch.int64,
         torch.float64, torch.int32], 112, 24),
    (8, [torch.int64] * 16, 272, 64),  # the largest record the kernel takes
])
def test_agg_record_layout_init_and_views(k, dtypes, stride, state):
    """B2's record: 8-byte fields 8-aligned, a stride that is a multiple of
    16 bytes, no two fields overlapping; the initial pattern read through
    the views: key words all ones, count 0, rep n, each accumulator its
    kind's neutral, eligible counts 0; each view a strided column of the
    record tensor with the job's dtype."""
    lay = K.AggRecord(k, dtypes)
    assert (lay.stride, lay.state) == (stride, state)
    fields = [(0, 8 * k), (lay.count, 4), (lay.rep, 4)]
    fields += [(off, dt.itemsize) for off, dt in zip(lay.accs, dtypes)]
    fields += [(off, 4) for off in lay.nels]
    if state >= 0:
        fields.append((state, 4))
    spans = sorted(fields)
    for (a, la), (b, _lb) in zip(spans, spans[1:]):
        assert a + la <= b
    assert spans[-1][0] + spans[-1][1] <= lay.stride
    for off, size in fields:
        assert off % size == 0
    kinds = ["sum", "min", "max"] * 6
    n, T = 77, 16
    init = lay.init(kinds[:len(dtypes)], n)
    assert init.dtype == np.int64 and init.shape == (stride // 8,)
    rec = torch.from_numpy(np.tile(init, (T + 1, 1)))
    counts, rep, accs, nels = lay.views(rec, T)
    assert counts.dtype == rep.dtype == torch.int32
    assert bool((counts == 0).all()) and bool((rep == n).all())
    assert bool((rec[:, :k] == -1).all())
    if state >= 0:
        assert bool((rec.view(torch.int32)[:, state // 4] == 0).all())
    for kind, dt, acc, nel in zip(kinds, dtypes, accs, nels):
        assert acc.dtype == dt and acc.shape == (T,) and nel.shape == (T,)
        assert nel.dtype == torch.int32 and bool((nel == 0).all())
        want = 0 if kind == "sum" else K._minmax_init(dt, kind)
        assert bool((acc == want).all())
    for t in [counts, rep] + accs + nels:
        assert t.untyped_storage().data_ptr() == rec.untyped_storage(
        ).data_ptr()
        assert t.stride(0) * t.element_size() == stride
    # a write through a view lands in its own record and field only
    counts[3] = 5
    accs[0][3] = 9
    assert int(rec.view(torch.int32)[3, lay.count // 4]) == 5
    assert int(counts.sum()) == 5 and int(rep.sum()) == n * T
    assert float(accs[0][3]) == 9
