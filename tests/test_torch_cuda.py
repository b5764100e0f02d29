"""The port's CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device. The file imports nothing of JAX, so it runs where JAX is not
installed: ``python3 -m pytest tests/test_torch_cuda.py -m cuda
--noconftest -q``. Exact equality for permutations, counts and integers;
float64 sums at rtol 1e-9 (atomics add in another order). Hash tables
compare by key (``testing/hashcheck.py``): the kernels claim slots in
another order than the plain versions.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.testing import hashcheck
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

F64_RTOL = 1e-9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _groups(counts, rep, accs, nels):
    """{first-arrival row: (count, accs, nels)} over used slots."""
    counts, rep = counts.cpu().numpy(), rep.cpu().numpy()
    accs = [a.cpu().numpy() for a in accs]
    nels = [ne.cpu().numpy() for ne in nels]
    return {int(rep[s]): (int(counts[s]), [float(a[s]) for a in accs],
                          [int(ne[s]) for ne in nels])
            for s in np.nonzero(counts > 0)[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_compact_kernel_matches_plain(cuda_device, density):
    keep = torch.rand(100_003, device=cuda_device) < density
    for view in (keep, keep[1:], keep[:0]):
        perm, total = K.compact_permutation(view)
        perm_p, total_p = K.compact_permutation_plain(view)
        assert torch.equal(perm, perm_p) and int(total) == int(total_p)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_compact_kernel_tile_edges_and_unaligned_views(cuda_device, density):
    """Sizes around the 4096-row tile and views whose first byte is not
    16-byte aligned (the kernel's byte-load path); repeated calls on one
    stream reuse its ticket."""
    from spark_rapids_tpu_torch.ops import cudalib
    lib = cudalib.load("compact")
    assert lib.srt_compact_tile_rows() == K.COMPACT_TILE_ROWS
    tile = K.COMPACT_TILE_ROWS
    keep = torch.rand(5 * tile + 64, device=cuda_device) < density
    for n in (1, 15, 16, 17, tile - 1, tile, tile + 1, 3 * tile + 1):
        for view in (keep[:n], keep[1:n + 1], keep[3:n + 3]):
            perm, total = K.compact_permutation(view)
            perm_p, total_p = K.compact_permutation_plain(view)
            assert torch.equal(perm, perm_p) and int(total) == int(total_p)
            assert torch.equal(perm.long(), torch.argsort(
                (~view).to(torch.uint8), stable=True))


@pytest.mark.cuda
def test_compact_kernel_on_a_second_stream(cuda_device):
    keep = torch.rand(100_003, device=cuda_device) < 0.4
    want = K.compact_permutation_plain(keep)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [K.compact_permutation(keep) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    for perm, total in got:
        assert torch.equal(perm, want[0]) and int(total) == int(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nkeys", [1, 50, 5000])
def test_hash_agg_kernel_matches_plain(cuda_device, nkeys):
    rng = np.random.default_rng(nkeys)
    n = 20_000
    dev = cuda_device
    keys = torch.from_numpy(rng.integers(0, nkeys, n)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    def t(a):
        return torch.from_numpy(a).to(dev)
    jobs = [("sum", t(rng.integers(-50, 50, n)), t(rng.random(n) < 0.8)),
            ("sum", t(rng.random(n) * 1e3), valid),
            ("min", t(rng.integers(-1000, 1000, n).astype(np.int32)), valid),
            ("max", t(rng.random(n) * 100 - 50), t(rng.random(n) < 0.9)),
            ("min", pos, valid), ("max", pos, valid)]
    T = K.hash_table_size(n)
    images = [keys, (keys * 7) % 3]  # a two-word key
    got = _groups(*K.hash_grouped_aggregate(images, valid, jobs, T))
    want = _groups(*K.hash_grouped_aggregate_plain(images, valid, jobs, T))
    assert got.keys() == want.keys()
    for row, (cnt, accs, nels) in want.items():
        assert got[row][0] == cnt and got[row][2] == nels
        np.testing.assert_allclose(got[row][1], accs, rtol=F64_RTOL)


def _agg_jobs(rng, n, nj, valid, dev):
    """``nj`` of seven jobs over every kind and dtype the kernel takes (7:
    a record with two 4-byte accumulators, its stride not 16-aligned
    before the pad)."""
    def t(a):
        return torch.from_numpy(a).to(dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    jobs = [("sum", t(rng.random(n) * 1e3), valid),
            ("sum", t(rng.integers(-50, 50, n)), t(rng.random(n) < 0.8)),
            ("min", t(rng.integers(-1000, 1000, n).astype(np.int32)), valid),
            ("max", t(rng.random(n) * 100 - 50), t(rng.random(n) < 0.9)),
            ("min", pos, valid), ("max", t(rng.integers(-9, 9, n)), valid),
            ("min", t(rng.random(n) - 0.5), t(rng.random(n) < 0.5))]
    return jobs[:nj]


def _check_agg(images, valid, jobs):
    T = K.hash_table_size(valid.shape[0])
    out = K.hash_grouped_aggregate(images, valid, jobs, T)
    got = _groups(*out)
    want = _groups(*K.hash_grouped_aggregate_plain(images, valid, jobs, T))
    assert got.keys() == want.keys()
    for row, (cnt, accs, nels) in want.items():
        assert got[row][0] == cnt and got[row][2] == nels
        for (kind, data, _e), a, b in zip(jobs, got[row][1], accs):
            if data.dtype == torch.float64 and kind == "sum":
                np.testing.assert_allclose(a, b, rtol=F64_RTOL)
            else:  # exact, NaN equal to NaN
                np.testing.assert_array_equal(a, b)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nj", [1, 7])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_hash_agg_kernel_key_words_and_jobs(cuda_device, k, nj):
    """k = 1 and 2 claim on the key words, k > 2 on the record's state
    word; 1 and 7 jobs give records of other strides. The counts, reps and
    accumulators are views of one record tensor."""
    rng = np.random.default_rng(10 * k + nj)
    n = 30_000
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    # few distinct keys over k words, words 0 and the fill among them
    pool = np.array([-1, 0, 1, 2, 3, 1 << 40], np.int64)
    images = [torch.from_numpy(rng.choice(pool[:3 + j % 4], n)).to(
        cuda_device) for j in range(k)]
    jobs = _agg_jobs(rng, n, nj, valid, cuda_device)
    counts, rep, accs, nels = _check_agg(images, valid, jobs)
    layout = K.AggRecord(k, [d.dtype for _k, d, _e in jobs])
    base = counts.untyped_storage().data_ptr()
    for t in [rep] + accs + nels:
        assert t.untyped_storage().data_ptr() == base
        assert t.stride(0) * t.element_size() == layout.stride


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_hash_agg_kernel_fill_key(cuda_device, k):
    """The all-ones key (every word the fill) among keys whose chains
    cross its first slot takes one slot after them; at k = 2 a key with
    one fill word claims as any other."""
    rng = np.random.default_rng(k)
    n = 20_000
    T = K.hash_table_size(n)
    near = _keys_near_fill_slot(T, 40) if k == 1 else np.arange(1, 40)
    pool = np.append(near, [_FILL])
    images = [torch.from_numpy(rng.choice(pool, n)).to(cuda_device)]
    if k == 2:
        images.append(torch.from_numpy(rng.choice([_FILL, 3], n)).to(
            cuda_device))
    valid = torch.from_numpy(rng.random(n) < 0.95).to(cuda_device)
    jobs = _agg_jobs(rng, n, 3, valid, cuda_device)
    counts, rep, _a, _n = _check_agg(images, valid, jobs)
    fill = valid & torch.stack(images).eq(_FILL).all(0)
    assert int(fill.sum()) > 0
    used = counts > 0
    first = int(fill.nonzero()[0])
    assert int((rep[used] == first).sum()) == 1
    assert int(counts[rep == first].sum()) == int(fill.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n,live", [(0, 0.0), (5000, 0.0)])
def test_hash_agg_kernel_empty_and_all_invalid(cuda_device, n, live):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 40, n)).to(cuda_device)
    valid = torch.from_numpy(rng.random(n) < live).to(cuda_device)
    jobs = _agg_jobs(rng, n, 7, valid, cuda_device)
    T = K.hash_table_size(n)
    counts, rep, accs, nels = K.hash_grouped_aggregate([keys, keys], valid,
                                                       jobs, T)
    want = K.hash_grouped_aggregate_plain([keys, keys], valid, jobs, T)
    assert int(counts.sum()) == 0 and torch.equal(rep, want[1])
    for a, b in zip(accs + nels, want[2] + want[3]):
        assert a.dtype == b.dtype and a.shape == (T,) and torch.equal(a, b)


@pytest.mark.cuda
def test_hash_agg_kernel_nan_min_max(cuda_device):
    """NaN is sticky in float64 min and max, wherever it arrives."""
    rng = np.random.default_rng(5)
    n = 20_000
    keys = torch.from_numpy(rng.integers(0, 300, n)).to(cuda_device)
    x = rng.random(n) * 10 - 5
    x[rng.random(n) < 0.002] = np.nan
    x[rng.random(n) < 0.01] = np.inf
    x[rng.random(n) < 0.01] = -np.inf
    data = torch.from_numpy(x).to(cuda_device)
    valid = torch.ones(n, dtype=torch.bool, device=cuda_device)
    jobs = [("min", data, valid), ("max", data, valid)]
    counts, _r, accs, _n = _check_agg([keys], valid, jobs)
    assert bool(accs[0][counts > 0].isnan().any())


@pytest.mark.cuda
def test_hash_agg_kernel_on_a_second_stream(cuda_device):
    rng = np.random.default_rng(17)
    n = 30_000
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    images = [torch.from_numpy(rng.integers(0, 500, n)).to(cuda_device)
              for _ in range(2)]
    jobs = _agg_jobs(rng, n, 7, valid, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in (1, 2):
            _check_agg(images[:k], valid, jobs)
    torch.cuda.current_stream().wait_stream(side)


_FILL = -1  # the all-ones image B3 fills unused key words with


def _keys_near_fill_slot(T: int, count: int) -> np.ndarray:
    """``count`` distinct one-word keys whose chains start at most 8 slots
    before the all-ones image's first slot, so that they cross it."""
    home = int(K._mix_images([torch.tensor([_FILL])])[0]) & (T - 1)
    x = torch.arange(1, 1 << 22, dtype=torch.int64)
    dist = (home - (K._mix_images([x]) & (T - 1))) % T
    near = x[dist < 8].numpy()
    assert len(near) >= count
    return near[:count]


def _join_case(case, rng, dev):
    """(build images, build valid, stream images, stream valid)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nb, ns = 30_000, 40_000
    if case == "empty":
        nb = ns = 0
    elif case == "skewed":  # one key: every hit expands to ~nb rows
        ns = 64
    if case == "fill_key":
        # the all-ones image among keys whose chains cross its slot
        pool = np.append(_keys_near_fill_slot(K.hash_table_size(nb), 60),
                         [_FILL, 5, 6])
        bimg = [t(rng.choice(pool, nb))]
        simg = [t(rng.choice(np.append(pool, [7, 8]), ns))]
    elif case == "key0":  # stream image 0, absent from the build
        bimg = [t(rng.integers(1, 2000, nb))]
        simg = [t(np.where(rng.random(ns) < 0.3, 0,
                           rng.integers(0, 2500, ns)))]
    elif case == "bool_key":  # image 0 for about half the rows
        bimg = [t((rng.random(nb) < 0.5).astype(np.int64))]
        simg = [t((rng.random(ns) < 0.5).astype(np.int64))]
    elif case in ("k2_fill", "k3_fill"):
        # a key of several words claims on a state word: all ones is an
        # ordinary key word there, alone and as the all-ones key
        k = int(case[1])
        words = np.array([_FILL, 0, 1, 5, np.iinfo(np.int64).max])
        ns = 64
        bimg = [t(rng.choice(words, nb)) for _ in range(k)]
        simg = [t(rng.choice(np.append(words, 9), ns)) for _ in range(k)]
    elif case == "int64_max":  # INT64_MAX's image is the all-ones word
        vals = np.array([np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0,
                         -1, 1])
        bimg = [t(np.where(rng.random(nb) < 0.3, vals[0],
                           rng.integers(-50, 50, nb)) ^ (-1 << 63))]
        simg = [t(rng.choice(np.append(vals, [60, 70]), ns) ^ (-1 << 63))]
    else:
        k = {"k2": 2, "k3": 3}.get(case, 1)
        hi = {"skewed": 1, "k2": 40, "k3": 12}.get(case, 20_000)
        bimg = [t(rng.integers(0, hi, nb)) for _ in range(k)]
        simg = [t(rng.integers(0, hi + hi // 4 + 1, ns)) for _ in range(k)]
    bv = t(rng.random(nb) < (0.0 if case == "all_invalid" else 0.9))
    sv = t(rng.random(ns) < 0.95)
    return bimg, bv, simg, sv


def _check_join(bimg, bv, simg, sv):
    """B3 by key, then B4 probing its table, then the composed join."""
    T = K.hash_table_size(bv.shape[0])
    slot, rank, table, counts = K.hash_table_build(bimg, bv, T)
    slot_p, _r, table_p, counts_p = K.hash_table_build_plain(bimg, bv, T)
    assert rank is None
    hashcheck.check_build(bimg, bv, slot, table, counts)
    assert torch.equal(hashcheck.table_by_key(table, counts),
                       hashcheck.table_by_key(table_p, counts_p))
    got = K.hash_table_probe(table, counts, simg, sv, T)
    want = K.hash_table_probe_plain(table_p, counts_p, simg, sv, T)
    hit = got < T
    assert torch.equal(hit, want < T)
    for j, img in enumerate(simg):
        assert torch.equal(table[j][got[hit].long()], img[hit])
    assert torch.equal(counts[got[hit].long()], counts_p[want[hit].long()])
    # the fused lookup on the kernel's table: the plain probe, then _lookup
    jt = K.JoinTable(table, counts, *K._placement(slot, counts, bv))
    for g, w in zip(K.hash_join_lookup(jt, simg, sv),
                    K._lookup(K.hash_table_probe_plain(table, counts, simg,
                                                       sv, T),
                              counts, jt.starts)):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    c, rows = hashcheck.join_matches(*K.hash_join_probe(bimg, bv, simg, sv,
                                                        T))
    c_p, rows_p = hashcheck.join_matches(*K.hash_join_probe_plain(
        bimg, bv, simg, sv, T))
    assert torch.equal(c, c_p) and torch.equal(rows, rows_p)
    return slot, counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "skewed", "k2", "k3",
                                  "all_invalid", "empty", "fill_key",
                                  "bool_key", "int64_max", "k2_fill",
                                  "k3_fill", "key0"])
def test_hash_join_kernels_match_plain(cuda_device, case):
    rng = np.random.default_rng(7)
    bimg, bv, simg, sv = _join_case(case, rng, cuda_device)
    slot, counts = _check_join(bimg, bv, simg, sv)
    if case in ("fill_key", "int64_max", "k2_fill", "k3_fill"):
        # the all-ones key has one slot
        fill = bv & torch.stack(bimg).eq(_FILL).all(0)
        assert int(fill.sum()) > 0
        assert slot[fill].unique().numel() == 1
        assert int(counts[slot[fill][0].long()]) == int(fill.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_hash_probe_takes_the_cards_build(cuda_device, k):
    """The card's probe reads a key word before the count: it takes a table
    whose unused key words hold the fill (all ones), as the card's build
    leaves them. Were they 0, as the plain build leaves them, key image 0
    would hit an empty slot."""
    rng = np.random.default_rng(k)
    nb = 5000
    bimg = [torch.from_numpy(rng.integers(1, 900, nb)).to(cuda_device)
            for _ in range(k)]
    bv = torch.ones(nb, dtype=torch.bool, device=cuda_device)
    T = K.hash_table_size(nb)
    jt = K.hash_join_build(bimg, bv, T)
    assert bool((jt.table[:, jt.counts == 0] == _FILL).all())
    zero = [torch.zeros(64, dtype=torch.int64, device=cuda_device)] * k
    sv = torch.ones(64, dtype=torch.bool, device=cuda_device)
    assert bool((K.hash_table_probe(jt.table, jt.counts, zero, sv, T)
                 == T).all())
    match, first = K.hash_join_lookup(jt, zero, sv)
    assert int(match.abs().sum()) == 0 and int(first.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "k3", "fill_key"])
def test_hash_join_kernels_on_a_second_stream(cuda_device, case):
    rng = np.random.default_rng(13)
    bimg, bv, simg, sv = _join_case(case, rng, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _check_join(bimg, bv, simg, sv)
    torch.cuda.current_stream().wait_stream(side)


# ---------------------------------------------------------------------------
# B5-B8: the device Parquet decode kernels, exact against the plain versions
# ---------------------------------------------------------------------------

def _dev(a, dev):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(dev)


def _run_table(rng, nruns, bws, kinds, nwords):
    """A hybrid run table with a guard row, as ops/parquet_decode plans it:
    run lengths 1..600, bit-packed runs at random bit offsets."""
    counts = rng.integers(1, 600, nruns)
    out_start = np.concatenate([[0], np.cumsum(counts),
                                [np.iinfo(np.int32).max]]).astype(np.int32)
    kind = np.append(rng.choice(kinds, nruns), 0).astype(np.uint8)
    value = np.append(rng.integers(-3, 1 << 20, nruns), 0).astype(np.int32)
    bw = np.append(rng.choice(bws, nruns), 0).astype(np.int32)
    bit_start = np.append(rng.integers(0, (nwords - 2) * 32 - 600 * 32,
                                       nruns), 0).astype(np.int64)
    return out_start, kind, value, bit_start, bw, int(counts.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("bws,kinds", [([0], [1]), ([1], [1]), ([17], [1]),
                                       ([32], [1]), ([0, 1, 17, 32], [0]),
                                       ([3, 9, 32], [0, 1])])
def test_hybrid_expand_kernel_matches_plain(cuda_device, bws, kinds):
    rng = np.random.default_rng(len(bws) * 10 + len(kinds))
    nwords = 40_000
    words = _dev(rng.integers(0, 1 << 32, nwords, dtype=np.uint64)
                 .astype(np.uint32), cuda_device)
    table = _run_table(rng, 800, bws, kinds, nwords)
    args = [words] + [_dev(a, cuda_device) for a in table[:5]]
    total = table[5]
    # exact length, one past, a padded capacity (guard-row rows), n % 8 != 0
    for n in (total, total + 1, 1 << 20, 12_345, 1):
        got = K.hybrid_expand(*args, n)
        want = K.hybrid_expand_plain(*args, n)
        assert torch.equal(got, want), n


def _hybrid_streams(rng, count, dev, upload=False):
    """``count`` ragged hybrid streams (2 to 3000 runs, outputs up to and
    past their runs, then one more with n = 0); with ``upload``, every array
    is a view of one uint8 buffer, as ``parquet_decode.upload_arrays``
    cuts them, but 8 bytes past a 16-byte boundary."""
    host = []
    for j in range(count):
        nwords = int(rng.integers(700, 5000))
        words = rng.integers(0, 1 << 32, nwords, dtype=np.uint64).astype(
            np.uint32)
        *table, total = _run_table(rng, int(rng.integers(2, 3000)),
                                   [0, 1, 5, 17, 32], [0, 1], nwords + 600)
        host.append(([words] + table,
                     total + int(rng.integers(-total // 2, 3000))))
    host.append((host[0][0], 0))
    if not upload:
        return [tuple(_dev(a, dev) for a in arrays) + (n,)
                for arrays, n in host]
    flat = [np.ascontiguousarray(a).view(np.uint8) for arrays, _n in host
            for a in arrays]
    offs = 8 + 16 * np.cumsum([0] + [len(f) // 16 + 1 for f in flat])
    buf = np.zeros(int(offs[-1]), np.uint8)
    for f, o in zip(flat, offs):
        buf[o:o + len(f)] = f
    dbuf = torch.from_numpy(buf).to(dev)
    out, i = [], 0
    for arrays, n in host:
        views = []
        for a in arrays:
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            t = dbuf[offs[i]:offs[i] + a.nbytes]
            views.append(t.view(torch.from_numpy(a[:0]).dtype))
            i += 1
        out.append(tuple(views) + (n,))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("count,upload", [(1, False), (13, False),
                                          (33, False), (33, True)])
def test_hybrid_expand_many_kernel_matches_plain(cuda_device, count,
                                                 upload):
    """Ragged streams in one call (n = 0 among them, outputs past the guard
    row), split into launches of 32, from views of one upload buffer at
    offsets that are 8- but not 16-byte aligned; bit for bit."""
    from spark_rapids_tpu_torch.ops import cudalib
    lib = cudalib.load("parquet_decode")
    assert lib.srt_hybrid_expand_max_streams() == K.HYBRID_MAX_STREAMS
    rng = np.random.default_rng(count)
    streams = _hybrid_streams(rng, count, cuda_device, upload)
    if upload:
        assert any(s[0].data_ptr() % 16 for s in streams)
    before = K.LAUNCHES["hybrid_expand"]
    got = K.hybrid_expand_many(streams)
    # one launch per 32 streams with outputs: 33 take two
    assert K.LAUNCHES["hybrid_expand"] - before == -(-count // 32)
    want = K.hybrid_expand_many_plain(streams)
    assert len(got) == count + 1 and got[-1].shape == (0,)
    for g, w, s in zip(got, want, streams):
        assert g.shape == (s[6],) and torch.equal(g, w), s[6]


def _delta_chunk(rng, totals, bws, nwords):
    """A merged DELTA chunk table (ops/parquet_decode.delta_chunk_table's
    layout): 32-delta miniblocks at random bit offsets, min deltas of both
    signs."""
    mstart, bw, mind, bits, first = [], [], [], [], []
    page_start = [0]
    for t in totals:
        base = page_start[-1]
        for s in range(0, max(t - 1, 0), 32):
            mstart.append(base + 1 + s)
            bw.append(rng.choice(bws))
            mind.append(rng.integers(-(1 << 40), 1 << 40))
            bits.append(rng.integers(0, (nwords - 2) * 32 - 32 * 32))
        first.append(rng.integers(-(1 << 62), 1 << 62))
        page_start.append(base + t)
    mstart.append(np.iinfo(np.int32).max)
    bw.append(0)
    mind.append(0)
    bits.append(0)
    return (np.asarray(mstart, np.int32), np.asarray(bw, np.int32),
            np.asarray(mind, np.int64), np.asarray(bits, np.int64),
            np.asarray(page_start, np.int32), np.asarray(first, np.int64),
            int(sum(totals)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_page", "many_pages", "tiny_pages",
                                  "bw0", "bw32", "wrap32"])
def test_delta_unpack_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(len(case))
    nwords = 200_000
    totals = {"one_page": [100_000], "many_pages": [20_000] * 13 + [777],
              "tiny_pages": [1, 2, 0, 33, 1, 2048, 2049, 4095, 1, 5],
              "bw0": [70_000, 3], "bw32": [9_000, 50_001],
              "wrap32": [30_000]}[case]
    bws = {"bw0": [0], "bw32": [32]}.get(case, [0, 1, 17, 27, 32])
    words = _dev(rng.integers(0, 1 << 32, nwords, dtype=np.uint64)
                 .astype(np.uint32), cuda_device)
    *table, n = _delta_chunk(rng, totals, bws, nwords)
    args = [words] + [_dev(a, cuda_device) for a in table]
    got = K.delta_unpack(*args, n)
    want = K.delta_unpack_plain(*args, n)
    assert torch.equal(got, want)
    if case == "wrap32":  # an INT32 column takes the low 32 bits
        assert torch.equal(got.to(torch.int32), want.to(torch.int32))


def _delta_chunks(rng, count, dev):
    """``count`` ragged DELTA chunks (1 to 14 pages of 0 to 60,000 values,
    bit widths 0 to 32, min deltas of both signs), then one more with
    n = 0."""
    out = []
    for j in range(count):
        nwords = int(rng.integers(5_000, 60_000))
        words = _dev(rng.integers(0, 1 << 32, nwords, dtype=np.uint64)
                     .astype(np.uint32), dev)
        totals = list(rng.integers(0, 60_000, int(rng.integers(1, 15))))
        *table, n = _delta_chunk(rng, totals, [0, 1, 13, 27, 32], nwords)
        out.append((words, *[_dev(a, dev) for a in table], n))
    out.append(out[0][:7] + (0,))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 2, 33])
def test_delta_unpack_many_kernel_matches_plain(cuda_device, count):
    """A row group's chunks in one launch (one per 32 chunks), an empty
    chunk among them, bit for bit against the plain version."""
    from spark_rapids_tpu_torch.ops import cudalib
    lib = cudalib.load("parquet_decode")
    assert lib.srt_delta_unpack_max_chunks() == 32
    chunks = _delta_chunks(np.random.default_rng(count), count, cuda_device)
    before = K.LAUNCHES["delta_unpack"]
    got = K.delta_unpack_many(chunks)
    assert K.LAUNCHES["delta_unpack"] - before == -(-count // 32)
    want = K.delta_unpack_many_plain(chunks)
    assert len(got) == count + 1 and got[-1].shape == (0,)
    for g, w, c in zip(got, want, chunks):
        assert g.shape == (c[7],) and torch.equal(g, w), c[7]
        assert g.data_ptr() % 16 == 0


@pytest.mark.cuda
def test_delta_unpack_many_kernel_repeats_and_second_stream(cuda_device):
    """The look-back's scratch is cleared by every launch: back-to-back
    calls, and calls on another stream, give the same values."""
    chunks = _delta_chunks(np.random.default_rng(7), 3, cuda_device)
    want = K.delta_unpack_many_plain(chunks)
    for _ in range(5):
        for g, w in zip(K.delta_unpack_many(chunks), want):
            assert torch.equal(g, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = K.delta_unpack_many(chunks)
    torch.cuda.current_stream().wait_stream(side)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["i32", "f32", "i64", "f64", "bool"])
def test_plain_fixed_kernel_matches_plain(cuda_device, kind):
    rng = np.random.default_rng(3)
    words = _dev(rng.integers(0, 1 << 32, 100_002, dtype=np.uint64)
                 .astype(np.uint32), cuda_device)
    for n in (1, 8191, 100_002, 1 << 20):
        got = K.plain_fixed(words, kind, n)
        want = K.plain_fixed_plain(words, kind, n)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_plain_fixed_many_kernel_matches_plain(cuda_device, offset):
    """More streams than one launch takes (32), of every kind and length,
    their sources at ``offset`` words from a 16-byte boundary (offset 0:
    the 16-byte copies; else the word path)."""
    from spark_rapids_tpu_torch.ops import cudalib
    lib = cudalib.load("parquet_decode")
    assert lib.srt_plain_fixed_max_segments() == K.PLAIN_MAX_SEGMENTS
    rng = np.random.default_rng(offset)
    base = _dev(rng.integers(0, 1 << 32, 300_008, dtype=np.uint64)
                .astype(np.uint32), cuda_device)
    kinds = ("i32", "f32", "i64", "f64", "bool")
    streams = []
    for j in range(70):
        nw = int(rng.integers(1, 5000)) * 2 if j % 9 else 200_000
        n = int(rng.integers(0, 3 * nw))
        streams.append((base[offset:offset + nw], kinds[j % 5], n))
    before = K.LAUNCHES["plain_fixed"]
    got = K.plain_fixed_many(streams)
    assert K.LAUNCHES["plain_fixed"] - before == 3  # 70 streams: 32 + 32 + 6
    want = K.plain_fixed_many_plain(streams)
    for g, w, (_words, kind, n) in zip(got, want, streams):
        assert _bits_equal(g, w), (kind, n, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [8, 16, 32, 64])
def test_slab_pack_kernel_matches_plain(cuda_device, stride):
    rng = np.random.default_rng(stride)
    rows, cap = 50_001, 1 << 16
    lens = rng.integers(0, stride + 1, rows)
    lens[::7] = 0  # empty strings
    starts = np.concatenate([[0], np.cumsum(lens + 4)[:-1]]) + 4
    chars = rng.integers(0, 256, int(starts[-1] + lens[-1]) + stride + 8)
    st = np.zeros(cap, np.int64)
    ln = np.zeros(cap, np.int32)
    st[:rows], ln[:rows] = starts, lens
    args = [_dev(chars.astype(np.uint8), cuda_device),
            _dev(st, cuda_device), _dev(ln, cuda_device)]
    got = K.slab_pack(*args, cap, stride)
    want = K.slab_pack_plain(*args, cap, stride)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The session on the card: Q1, Q6 and the Q18 group-by against the query
# runners
# ---------------------------------------------------------------------------

def _same_by_key(got, want, keys):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    got = got.sort_values(keys).reset_index(drop=True)
    want = want.sort_values(keys).reset_index(drop=True)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=F64_RTOL, atol=0)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], c


@pytest.mark.cuda
@pytest.mark.parametrize("qname", ["q1", "q6", "q18_groupby"])
def test_session_queries_on_the_card(cuda_device, qname):
    """Through the port's session in test mode (no fallback), at SF 0.05
    in 2^16-row batches: equal to the query runners' answers, through
    kernels B1 (and B2 for the Q18 group-by). Q6's filter fuses into its
    global aggregate (``spark.rapids.sql.agg.fuseFilter``, the JAX
    package's default) and compacts nothing: it takes B1 only with the
    fusion off."""
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.session import TpuSparkSession
    df = G.gen_lineitem(0.05)
    batch = 1 << 16
    b = (TpuSparkSession.builder()
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.batchSizeRows", batch))
    for k, v in tpch.HASH_AGG_CONFS.items():
        b.config(k, v)
    s = b.get_or_create()
    query = tpch.QUERIES[qname](s, {"lineitem": s.create_dataframe(df)})
    K.reset_launches()
    got = query.collect()
    if qname == "q6":
        assert K.LAUNCHES["compact_permutation"] == 0
        s.set_conf("spark.rapids.sql.agg.fuseFilter", False)
        K.reset_launches()
        _same_by_key(query.collect(), got, ["revenue"])
    assert K.LAUNCHES["compact_permutation"] > 0
    if qname == "q1":
        want = Q.q1_from_batches(Q.upload_batches(df, Q.Q1_COLUMNS, batch))
        _same_by_key(got, want.to_pandas(), ["l_returnflag", "l_linestatus"])
    elif qname == "q6":
        want = Q.q6_from_batches(Q.upload_batches(df, Q.Q6_COLUMNS, batch))
        _same_by_key(got, want.to_pandas(), ["revenue"])
    else:
        assert K.LAUNCHES["hash_grouped_aggregate"] > 0
        _grouped, having = Q.q18_agg_from_batches(
            Q.upload_batches(df, Q.Q18_COLUMNS, batch))
        _same_by_key(got, having.to_pandas(), ["l_orderkey"])


def _session(device, **conf):
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = (TpuSparkSession.builder().device(device)
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.batchSizeRows", 1 << 16))
    for k, v in dict(tpch.HASH_AGG_CONFS, **conf).items():
        b.config(k, v)
    return b.get_or_create()


def _same_q3(got, want):
    """Q3's top 10 in the query's order: revenue at rtol 1e-9, dates
    exact, the keys of rows tied on (revenue, o_orderdate) as a set."""
    assert list(got.columns) == list(want.columns) and len(got) == 10
    np.testing.assert_allclose(got.revenue, want.revenue, rtol=F64_RTOL)
    assert list(got.o_orderdate) == list(want.o_orderdate)
    for _, grp in want.groupby(["revenue", "o_orderdate"], sort=False):
        rows = grp.index
        assert (sorted(got.loc[rows, "l_orderkey"])
                == sorted(want.loc[rows, "l_orderkey"]))


@pytest.fixture(scope="module")
def tpch_frames():
    from spark_rapids_tpu_torch.models import tpch_data as G
    return {"lineitem": G.gen_lineitem(0.05), "orders": G.gen_orders(0.05),
            "customer": G.gen_customer(0.05)}


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [None, -1])
@pytest.mark.parametrize("qname", ["q3", "q4"])
def test_session_join_queries_on_the_card(cuda_device, tpch_frames, qname,
                                          threshold):
    """Q3 and Q4 through the session at SF 0.05, broadcast (the default
    threshold) and shuffled: the card's answer equals the CPU session's;
    the broadcast builds its table once. Every join takes the dense route
    here (the scans' statistics bound each build key); with the
    statistics cleared before the run, they take kernels B3 and B4."""
    from spark_rapids_tpu_torch.exec import tpujoin
    from spark_rapids_tpu_torch.models import tpch
    conf = ({} if threshold is None else
            {"spark.rapids.sql.autoBroadcastJoinThreshold": threshold})
    outs = []
    builds = 2 if qname == "q3" else 1
    for device in ("cuda", "cpu"):
        s = _session(device, **dict(conf, **{
            "spark.rapids.sql.cacheDeviceScans": True}))
        t = {n: s.create_dataframe(f, 2) for n, f in tpch_frames.items()}
        query = tpch.QUERIES[qname](s, t)
        tpujoin.reset_routes()
        outs.append(query.collect())
        assert tpujoin.BUILDS["dense"] == builds
        if device == "cuda":
            s.column_stats.clear()
            K.reset_launches()
            outs.append(query.collect())
            assert K.LAUNCHES["hash_table_probe"] > 0
            assert K.LAUNCHES["hash_table_build"] == builds
    dense, hashed, want = outs
    for got in (dense, hashed):
        if qname == "q3":
            _same_q3(got, want)
        else:
            _same_by_key(got, want, ["o_orderpriority"])


@pytest.mark.cuda
def test_session_parquet_device_decode_on_the_card(cuda_device, tpch_frames,
                                                   tmp_path):
    """Q1, Q3, Q4, Q6, the Q18 group-by (without its filter) and the
    customer collect from Parquet files through the session, decoded on the
    card: equal to pandas, no column decoded on the host, kernels B5-B8
    launched, and Q3's and Q4's joins on the dense route (the row groups'
    footer statistics bound each build key)."""
    from spark_rapids_tpu_torch.exec import tpujoin
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.sql import functions as F
    fr = tpch_frames
    paths = G.write_parquet(str(tmp_path), 0.05, frames=fr)
    s = _session("cuda")
    t = {n: s.read.parquet(p) for n, p in paths.items()}
    li, o, c = fr["lineitem"], fr["orders"], fr["customer"]
    before = REGISTRY.values().get("scan.device.fallbackColumns", 0)
    K.reset_launches()
    tpujoin.reset_routes()

    got = tpch.q1(s, t).collect()
    f = li[li.l_shipdate <= np.datetime64("1998-09-02")]
    ep, d = f.l_extendedprice, f.l_discount
    f = f.assign(disc_price=ep * (1 - d), charge=ep * (1 - d) * (1 + f.l_tax))
    want = f.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"), avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"))
    _same_by_key(got, want, ["l_returnflag", "l_linestatus"])

    got = tpch.q6(s, t).collect()
    sd = li.l_shipdate
    m = ((sd >= np.datetime64("1994-01-01"))
         & (sd < np.datetime64("1995-01-01"))
         & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
         & (li.l_quantity < 24.0))
    np.testing.assert_allclose(
        got.revenue, [(li.l_extendedprice[m] * li.l_discount[m]).sum()],
        rtol=F64_RTOL)

    got = tpch.q3(s, t).collect()
    cut = np.datetime64("1995-03-15")
    mm = (c[c.c_mktsegment == "BUILDING"]
          .merge(o[o.o_orderdate < cut], left_on="c_custkey",
                 right_on="o_custkey")
          .merge(li[li.l_shipdate > cut], left_on="o_orderkey",
                 right_on="l_orderkey"))
    mm = mm.assign(revenue=mm.l_extendedprice * (1 - mm.l_discount))
    want = (mm.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                       as_index=False).revenue.sum()
            .sort_values(["revenue", "o_orderdate"], ascending=[False, True])
            .head(10).reset_index(drop=True))
    _same_q3(got, want)

    got = tpch.q4(s, t).collect()
    late = li.l_orderkey[li.l_commitdate < li.l_receiptdate]
    oo = o[(o.o_orderdate >= np.datetime64("1993-07-01"))
           & (o.o_orderdate < np.datetime64("1993-10-01"))]
    want = (oo[oo.o_orderkey.isin(late)].groupby("o_orderpriority").size()
            .rename("order_count").reset_index())
    _same_by_key(got, want, ["o_orderpriority"])

    got = (t["lineitem"].group_by("l_orderkey")
           .agg(F.sum("l_quantity").alias("sum_qty")).collect())
    want = li.groupby("l_orderkey", as_index=False).agg(
        sum_qty=("l_quantity", "sum"))
    _same_by_key(got, want, ["l_orderkey"])

    got = tpch.customer_segment(s, t).collect()
    want = c[c.c_mktsegment == "BUILDING"].reset_index(drop=True)
    _same_by_key(got, want, ["c_custkey"])

    assert REGISTRY.values().get("scan.device.fallbackColumns", 0) == before
    for k in ("hybrid_expand", "delta_unpack", "plain_fixed", "slab_pack"):
        assert K.LAUNCHES[k] > 0, k
    assert tpujoin.BUILDS["dense"] == 3


def _default_conf_query(name):
    """(session, tables) -> DataFrame of the sorted-branch card cases."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.sql import functions as F
    if name in tpch.QUERIES:
        return tpch.QUERIES[name]
    if name == "rowspace":  # 4 dictionary keys, 7344 joint slots
        return lambda s, t: t["lineitem"].group_by(
            "l_returnflag", "l_linestatus", "l_quantity", "l_discount").agg(
            F.sum("l_extendedprice").alias("p"), F.count("*").alias("n"),
            F.first("l_orderkey").alias("fk"))
    if name == "strings":
        return lambda s, t: t["customer"].group_by("c_nationkey").agg(
            F.min("c_name").alias("a"), F.max("c_phone").alias("b"),
            F.last("c_mktsegment").alias("c"), F.count("c_phone").alias("n"))
    assert name == "distinct"
    return lambda s, t: t["lineitem"].select("l_orderkey",
                                             "l_suppkey").distinct()


_SORTED_CASES = {"q3": ["l_orderkey"], "q10": ["c_custkey"],
                 "q17": ["avg_yearly"], "q18_groupby": ["l_orderkey"],
                 "q21": ["s_name"],
                 "rowspace": ["l_returnflag", "l_linestatus", "l_quantity",
                              "l_discount"],
                 "strings": ["c_nationkey"],
                 "distinct": ["l_orderkey", "l_suppkey"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_SORTED_CASES))
def test_sorted_branches_on_the_card(cuda_device, tpch_frames, name):
    """The sorted grouping branches (sorted payload, sorted space, row
    space) through the session at the JAX package's default confs, at SF
    0.05 in 2^16-row batches: the card's answer equals the CPU session's;
    the branch counts agree, so the card took the same branches."""
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import aggregate
    from spark_rapids_tpu_torch.session import TpuSparkSession
    fr = dict(tpch_frames, supplier=G.gen_supplier(0.05),
              part=G.gen_part(0.05), nation=G.gen_nation())
    outs, branches = [], []
    for device in ("cuda", "cpu"):
        s = (TpuSparkSession.builder().device(device)
             .config("spark.rapids.sql.test.enabled", True)
             .config("spark.rapids.sql.batchSizeRows", 1 << 16)
             .get_or_create())
        t = {n: s.create_dataframe(f) for n, f in fr.items()}
        aggregate.reset_branches()
        outs.append(_default_conf_query(name)(s, t).collect())
        branches.append(dict(aggregate.BRANCHES))
    assert branches[0] == branches[1] and "hash" not in branches[0]
    _same_by_key(outs[0], outs[1], _SORTED_CASES[name])


def _string_cases():
    from spark_rapids_tpu_torch.testing import stringcases
    return stringcases.cases(stringcases.port_conditional)


@pytest.fixture(scope="module")
def string_outputs():
    """Every string case (``testing/stringcases.py``) in one projection of
    a 2^16-row frame, through the session on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.testing import stringcases
    frame = stringcases.string_frame(1 << 16)
    table = _string_cases()
    outs = {}
    for device in ("cuda", "cpu"):
        s = _session(device)
        outs[device] = stringcases.projection(F, s, frame, table).collect()
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_string_cases()))
def test_string_cases_on_the_card(cuda_device, string_outputs, name):
    """Each comparison, string predicate, substring, IN, OR/NOT, CASE
    WHEN, if and year over a char slab and a dictionary: the card's values
    equal the CPU session's, nulls included."""
    def values(s):
        return [None if v is None or v is pd.NA or v != v else str(v)
                for v in s.astype(object)]
    assert (values(string_outputs["cuda"][name])
            == values(string_outputs["cpu"][name]))


_TPCH_NEW = ["q2", "q5", "q7", "q8", "q9", "q11", "q12", "q13", "q14", "q15",
             "q16", "q19", "q20", "q22"]


@pytest.mark.cuda
@pytest.mark.parametrize("qname", _TPCH_NEW)
def test_tpch_queries_on_the_card(cuda_device, tpch_frames, qname):
    """The 14 queries of the expression and cross-join slice at SF 0.05 in
    2^16-row batches, at the JAX package's default confs, on the card and
    on the CPU (Q20's and Q22's frames changed so that they give rows,
    ``testing/tpchcases.py``): equal answers, rows in each, and Q11, Q15
    and Q22 through the cartesian product."""
    from spark_rapids_tpu_torch.exec import tpujoin
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.session import TpuSparkSession
    from spark_rapids_tpu_torch.testing import tpchcases
    fr = tpchcases.query_frames(qname, dict(
        tpch_frames, supplier=G.gen_supplier(0.05), part=G.gen_part(0.05),
        partsupp=G.gen_partsupp(0.05), nation=G.gen_nation(),
        region=G.gen_region()))
    outs = []
    for device in ("cuda", "cpu"):
        s = (TpuSparkSession.builder().device(device)
             .config("spark.rapids.sql.test.enabled", True)
             .config("spark.rapids.sql.batchSizeRows", 1 << 16)
             .get_or_create())
        df = tpch.QUERIES[qname](s, {n: s.create_dataframe(f)
                                     for n, f in fr.items()})
        crosses = sum(isinstance(n, tpujoin.TpuCartesianProductExec)
                      for n in s.physical_plan(df._plan).walk())
        assert crosses == (1 if qname in ("q11", "q15", "q22") else 0)
        K.reset_launches()
        tpujoin.reset_routes()
        outs.append(df.collect())
        if device == "cuda":
            assert K.LAUNCHES["compact_permutation"] > 0
            # every equi-join on B4, or on the dense route where scan
            # statistics bound its build key
            assert (K.LAUNCHES["hash_table_probe"] > 0
                    or tpujoin.ROUTES["dense"] > 0)
    got, want = outs
    assert len(want) > 0
    order = tpchcases.ORDERS[qname]
    if order is not None:
        got = tpchcases.in_query_order(got, order)
        want = tpchcases.in_query_order(want, order)
    tpchcases.same_rows(got, want)


# ---------------------------------------------------------------------------
# Slice 11: hash_group_ids, the dense and union probes, wide strings,
# TPCxBB
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_hash_group_ids_on_the_cards_build(cuda_device, k):
    """``hash_group_ids`` over B3's table (unused key words -1) against
    its plain version over the plain build (unused words 0): the same
    partition of the rows into groups, the same group count, and each
    group's representative its least row."""
    rng = np.random.default_rng(k)
    n = 200_003
    pool = rng.integers(-5, 3000, (k, 4000))
    pick = rng.integers(0, 4000, n)
    imgs = [torch.from_numpy(pool[j][pick]) for j in range(k)]
    valid = torch.from_numpy(rng.random(n) < 0.9)
    T = K.hash_table_size(n)
    K.reset_launches()
    gid, ng, rep = K.hash_group_ids([im.to(cuda_device) for im in imgs],
                                    valid.to(cuda_device), T)
    assert K.LAUNCHES["hash_table_build"] == 1
    pg, pn, prep = K.hash_group_ids(imgs, valid, T)
    assert int(ng) == int(pn)
    gid, rep = gid.cpu().numpy(), rep.cpu().numpy()
    pg, prep = pg.numpy(), prep.numpy()
    v = valid.numpy()
    assert ((gid < 0) == ~v).all() and ((pg < 0) == ~v).all()
    # the same groups: representative rows name them on both sides
    np.testing.assert_array_equal(rep[gid[v]], prep[pg[v]])


@pytest.mark.cuda
def test_dense_probe_against_the_hash_kernels(cuda_device):
    """``join_probe_dense`` and B3 followed by B4 (``hash_join_probe``)
    give every stream row the same match count and the same build rows,
    and the dense flag holds; a build key outside the bounds clears it."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    from spark_rapids_tpu_torch.ops import joins as join_ops
    from spark_rapids_tpu_torch.ops.sortops import u64_key_image
    rng = np.random.default_rng(9)
    b = DeviceBatch.from_pandas(pd.DataFrame(
        {"k": rng.integers(0, 50_000, 100_000)}), device=cuda_device)
    st = DeviceBatch.from_pandas(pd.DataFrame(
        {"k": rng.integers(-100, 60_000, 300_000)}), device=cuda_device)
    counts, bstart, bperm, ok = join_ops.join_probe_dense(b, st, 0, 0, 0,
                                                          1 << 16)
    assert bool(ok)
    hc, hs, hp = K.hash_join_probe(
        u64_key_image(b.columns[0]), b.row_mask(),
        u64_key_image(st.columns[0]), st.row_mask(),
        K.hash_table_size(b.capacity))
    assert torch.equal(counts, hc)
    # the same build rows for each hit (bperm order within a key: both
    # ascending build rows)
    hit = (counts > 0).nonzero().flatten()[:5000]
    for d in range(3):
        sel = hit[counts[hit] > d]
        assert torch.equal(bperm[(bstart[sel] + d).long()],
                           hp[(hs[sel] + d).long()])
    *_, ok = join_ops.join_probe_dense(b, st, 0, 0, 100, 1 << 16)
    assert not bool(ok)


def _card_and_cpu(query, **conf):
    from spark_rapids_tpu_torch.session import TpuSparkSession
    outs = []
    for device in ("cuda", "cpu"):
        b = (TpuSparkSession.builder().device(device)
             .config("spark.rapids.sql.test.enabled", True))
        for k, v in conf.items():
            b.config(k, v)
        outs.append(query(b.get_or_create()).collect())
    return outs


def _sorted_rows(df):
    return sorted(tuple("NULL" if v is None or v is pd.NA or v != v
                        else str(v) for v in row)
                  for row in df.astype(object).itertuples(index=False))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dictionary", "slab", "wide"])
@pytest.mark.parametrize("how", ["inner", "full", "leftanti"])
def test_string_key_join_on_the_card(cuda_device, kind, how):
    """A string-key join (the union-lexsort probe) on the card equals the
    CPU session: dictionaries that differ, slabs, and 128-byte slabs that
    tie on 64 bytes and the length."""
    rng = np.random.default_rng(4)
    if kind == "dictionary":
        lv = [f"v{i}" for i in range(30)]
        rv = [f"v{i}" for i in range(15, 45)]
    else:
        pre = "y" * 64 if kind == "wide" else "key"
        lv = rv = [f"{pre}{i:011d}" for i in range(3000)]
    left = pd.DataFrame({"ls": np.asarray(lv, dtype=object)[
        rng.integers(0, len(lv), 20_000)], "lv": np.arange(20_000)})
    right = pd.DataFrame({"rs": np.asarray(rv, dtype=object)[
        rng.integers(0, len(rv), 5_000)], "rv": np.arange(5_000)})
    left.loc[rng.random(20_000) < 0.05, "ls"] = None

    def query(s):
        return s.create_dataframe(left).join(
            s.create_dataframe(right), left_on=["ls"], right_on=["rs"],
            how=how)
    got, want = _card_and_cpu(query)
    assert len(want) > 0
    assert _sorted_rows(got) == _sorted_rows(want)


@pytest.mark.cuda
def test_wide_string_upload_on_the_card(cuda_device):
    """600 distinct 75-byte values (a 128-byte slab) beside an int64 key:
    the filter returns the 10 rows, and a sort, a distinct and a min/max
    over values that tie on 64 bytes equal the CPU session's."""
    from spark_rapids_tpu_torch.sql import functions as F
    rng = np.random.default_rng(2)
    vals = np.asarray(["y" * 64 + f"{i:011d}" for i in range(600)],
                      dtype=object)[rng.permutation(600)]
    df = pd.DataFrame({"k": np.arange(600, dtype=np.int64), "s": vals})
    got, want = _card_and_cpu(lambda s: s.create_dataframe(df).filter(
        F.col("k") < 10).select("k", "s"))
    assert len(got) == 10 and _sorted_rows(got) == _sorted_rows(want)
    got, want = _card_and_cpu(lambda s: s.create_dataframe(df)
                              .order_by("s"))
    assert list(got.k) == list(want.k)
    for query in (lambda s: s.create_dataframe(df).select("s").distinct(),
                  lambda s: s.create_dataframe(df).agg(
                      F.min("s").alias("lo"), F.max("s").alias("hi"))):
        got, want = _card_and_cpu(query)
        assert _sorted_rows(got) == _sorted_rows(want)


def _plain_values(n: int, seed: int) -> np.ndarray:
    """``n`` values past the 64-byte slab limit (plain chars), most tying
    on their first 64 bytes, with NULLs and empty strings."""
    rng = np.random.default_rng(seed)
    out = ["h" * 64 + "".join(rng.choice(list("ab z"), rng.integers(0, 90)))
           if rng.random() < 0.7 else
           "" if rng.random() < 0.2 else f"w{i}-" + "q" * 80
           for i in range(n)]
    vals = np.asarray(out, dtype=object)
    vals[rng.random(n) < 0.08] = None
    return vals


@pytest.mark.cuda
def test_plain_gather_and_concat_on_the_card(cuda_device):
    """A plain column's filter (B1), gather and slice, and its concat with
    a slab part and a dictionary part, on the card equal the same steps on
    the CPU, offsets and chars exactly."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    from spark_rapids_tpu_torch.ops import rowops
    rng = np.random.default_rng(3)
    frames = [pd.DataFrame({"s": _plain_values(5000, 4)}),
              pd.DataFrame({"s": [f"v{i}" for i in range(3000)]}),
              pd.DataFrame({"s": ["a", "bb", None, "c" * 80] * 250})]
    keeps = [rng.random(8192) < 0.6 for _ in frames]
    perm = rng.permutation(8192)
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        parts = [DeviceBatch.from_pandas(f, {}, device=dev, slab_stride=64)
                 for f in frames]
        assert [c.columns[0].is_plain for c in parts] == [True, False, False]
        K.reset_launches()
        filt = rowops.filter_batch(parts[0], torch.from_numpy(
            keeps[0][:parts[0].capacity]).to(dev))
        gath = rowops.gather_batch(parts[0], torch.from_numpy(
            perm).int().to(dev), parts[0].num_rows)
        sl = rowops.slice_batch(parts[0], 100, 2000)
        cat = rowops.concat_batches(
            parts, 16384, keep_masks=[torch.from_numpy(
                k[:p.capacity]).to(dev) for k, p in zip(keeps, parts)])
        if dev.type == "cuda":
            assert K.LAUNCHES["compact_permutation"] >= 2
        outs[dev.type] = [b.columns[0] for b in (filt, gath, sl, cat)]
    for card, cpu in zip(outs["cuda"], outs["cpu"]):
        assert card.is_plain and cpu.is_plain
        assert torch.equal(card.validity.cpu(), cpu.validity)
        assert torch.equal(card.offsets.cpu(), cpu.offsets)
        total = int(cpu.offsets[-1])
        assert torch.equal(card.chars[:total].cpu(), cpu.chars[:total])


@pytest.mark.cuda
def test_plain_concat_past_int32_chars_on_the_card(cuda_device):
    """Three plain batches of 2^20 rows of 720 bytes, each filtered to 100
    rows (a filter keeps its source's 0.75 GB char capacity, so the three
    sum past 2^31): the concat reads their live char totals in one counted
    sync and holds just the kept rows' bytes, equal to them."""
    from spark_rapids_tpu_torch.columnar import dtypes
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    from spark_rapids_tpu_torch.ops import rowops
    rows, width, kept = 1 << 20, 720, 100
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(5)
    parts, want = [], []
    for p in range(3):
        chars = torch.randint(97, 123, (rows * width,), dtype=torch.uint8,
                              device=dev, generator=gen)
        col = DeviceColumn(
            dtypes.STRING, None, torch.ones(rows, dtype=torch.bool,
                                            device=dev), chars=chars,
            offsets=torch.arange(rows + 1, dtype=torch.int32,
                                 device=dev) * width)
        batch = DeviceBatch(Schema(["s"], [dtypes.STRING]), [col],
                            torch.full((), rows, dtype=torch.int32,
                                       device=dev))
        keep = torch.arange(rows, device=dev) // 7 % 1500 == 3 + p
        keep &= torch.cumsum(keep.to(torch.int32), 0) <= kept
        out = rowops.filter_batch(batch, keep)
        assert int(out.columns[0].chars.shape[0]) == rows * width
        want.append(chars.view(rows, width)[keep].cpu())
        parts.append(out)
        del chars, col, batch
    assert sum(int(b.columns[0].chars.shape[0]) for b in parts) >= 1 << 31
    before = SYNCS.syncs.get("concat.charTotals", 0)
    got = rowops.concat_batches(parts, 1024).columns[0]
    assert SYNCS.syncs["concat.charTotals"] == before + 1
    assert got.is_plain and int(got.chars.shape[0]) == 3 * kept * width
    assert torch.equal(got.chars.cpu().view(3 * kept, width),
                       torch.cat(want))
    assert torch.equal(got.offsets[:3 * kept + 1].cpu(), torch.arange(
        3 * kept + 1, dtype=torch.int32) * width)


@pytest.mark.cuda
def test_plain_sort_exact_past_64_bytes_on_the_card(cuda_device):
    """Values past 64 bytes that tie on their first 64: an order-by in
    both directions, a group-by count and a min/max on the card equal the
    CPU session's (the tied tails ranked on the card)."""
    from spark_rapids_tpu_torch.sql import functions as F
    df = pd.DataFrame({"k": np.arange(3000, dtype=np.int64),
                       "s": _plain_values(3000, 5)})
    df["g"] = df.k % 7
    for asc in (True, False):
        got, want = _card_and_cpu(lambda s: s.create_dataframe(df).order_by(
            F.col("s").asc() if asc else F.col("s").desc(), "k"))
        assert list(got.k) == list(want.k)
    for query in (lambda s: s.create_dataframe(df).group_by("s").agg(
                      F.count("*").alias("n")),
                  lambda s: s.create_dataframe(df).group_by("g").agg(
                      F.min("s").alias("lo"), F.max("s").alias("hi"))):
        got, want = _card_and_cpu(query)
        assert _sorted_rows(got) == _sorted_rows(want)


@pytest.mark.cuda
def test_plain_join_through_b3_b4_on_the_card(cuda_device):
    """A two-integer-key join carrying plain payloads on both sides runs
    on the hash route (B3 builds, B4 probes; the dense route takes only
    one key) with the payloads' chars sized by the expand's sync; a join
    on plain keys takes the union probe; both equal the CPU session."""
    from spark_rapids_tpu_torch.exec import tpujoin
    rng = np.random.default_rng(8)
    left = pd.DataFrame({"k": rng.integers(0, 500, 4000),
                         "p": _plain_values(4000, 6)})
    right = pd.DataFrame({"k2": rng.integers(0, 500, 1500),
                          "q": _plain_values(1500, 7)})
    left["m"], right["m2"] = left.k % 3, right.k2 % 3
    K.reset_launches()
    tpujoin.reset_routes()
    got, want = _card_and_cpu(lambda s: s.create_dataframe(left).join(
        s.create_dataframe(right), left_on=["k", "m"],
        right_on=["k2", "m2"]))
    assert K.LAUNCHES["hash_table_build"] > 0
    assert K.LAUNCHES["hash_table_probe"] > 0
    assert len(want) > 5000 and _sorted_rows(got) == _sorted_rows(want)
    for how in ("inner", "left", "leftanti"):
        got, want = _card_and_cpu(lambda s: s.create_dataframe(left).join(
            s.create_dataframe(right), left_on=["p"], right_on=["q"],
            how=how))
        assert _sorted_rows(got) == _sorted_rows(want)
    assert tpujoin.ROUTES["union"] > 0


def _tpcxbb_queries():
    from spark_rapids_tpu_torch.models import tpcxbb
    return sorted(tpcxbb.QUERIES, key=lambda q: int(q[1:]))


@pytest.fixture(scope="module")
def tpcxbb_frames():
    from spark_rapids_tpu_torch.models import tpcxbb_data as D
    return {n: f(0.5, None) for n, f in D.ALL_TABLES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("qname", _tpcxbb_queries())
def test_tpcxbb_queries_on_the_card(cuda_device, tpcxbb_frames, qname):
    """The 19 TPCxBB queries at SF 0.5 through the session in test mode:
    the card's answer equals the CPU session's and pandas'
    (``testing/tpcxbbcases.py``), with rows."""
    from spark_rapids_tpu_torch.models import tpcxbb
    from spark_rapids_tpu_torch.testing import tpcxbbcases
    fr = tpcxbbcases.query_frames(qname, tpcxbb_frames)
    got, cpu = _card_and_cpu(lambda s: tpcxbb.QUERIES[qname](
        s, {n: s.create_dataframe(f) for n, f in fr.items()}))
    assert len(got) > 0
    tpcxbbcases.same_answer(qname, got, cpu)
    tpcxbbcases.same_answer(qname, got,
                            tpcxbbcases.pandas_reference(qname, fr))


def _window_cases():
    from spark_rapids_tpu_torch.testing import windowcases
    return sorted(windowcases.CASES)


def _frames_match(got, want, approx):
    """Rows as a set: sorted on every non-float column, floats at rtol
    1e-6 where ``approx`` (a float sum frame's last bits follow the order
    of the adds), else exact."""
    keys = [c for c in want.columns
            if not pd.api.types.is_float_dtype(want[c].dtype)]
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    g = got.astype({c: str for c in keys}).sort_values(
        keys, kind="stable").reset_index(drop=True)
    w = want.astype({c: str for c in keys}).sort_values(
        keys, kind="stable").reset_index(drop=True)
    for c in want.columns:
        if c in keys:
            assert list(g[c]) == list(w[c]), c
        else:
            np.testing.assert_allclose(
                g[c].astype("Float64").to_numpy(np.float64, na_value=np.nan),
                w[c].astype("Float64").to_numpy(np.float64, na_value=np.nan),
                rtol=1e-6 if approx else 1e-12, equal_nan=True, err_msg=c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _window_cases())
def test_window_cases_on_the_card(cuda_device, name):
    """Every window descriptor kind (ranking, lead/lag with and without
    defaults over numbers and strings, count/sum/avg/min/max over whole,
    cumulative, ROW and RANGE frames, string min/max, slab, dictionary
    and NULL partition keys) on 20,000 rows: the card's answer equals the
    CPU session's (``device="cpu"``)."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.window import Window
    from spark_rapids_tpu_torch.testing import windowcases
    extra, query, approx = windowcases.CASES[name]
    df = windowcases.frame(extra, n=20_000)
    got, want = _card_and_cpu(lambda s: query(F, Window,
                                              s.create_dataframe(df)))
    _frames_match(got, want, approx)


@pytest.mark.cuda
def test_hash_and_string_select_on_the_card(cuda_device):
    """hash() over a slab, a dictionary and numbers, and the string
    if/CASE WHEN/coalesce over two dictionaries, a slab against a
    dictionary and two strides: the card equals the CPU session."""
    from spark_rapids_tpu_torch.sql import functions as F
    rng = np.random.default_rng(8)
    n = 50_000
    d = pd.DataFrame({
        "x": rng.integers(-3, 5, n),
        "f": rng.normal(0, 2, n),
        "d1": np.asarray(["a", "bb", None, ""], dtype=object)[
            rng.integers(0, 4, n)],
        "d2": np.asarray(["x", "yy", "a"], dtype=object)[
            rng.integers(0, 3, n)],
        "s1": np.asarray([f"k{i:05d}" for i in range(20_000)] + [None],
                         dtype=object)[rng.integers(0, 20_001, n)],
        "s2": np.asarray([f"long-{i}-" + "z" * (i % 40)
                          for i in range(20_000)], dtype=object)[
            rng.integers(0, 20_000, n)],
    })

    def query(s):
        return s.create_dataframe(d).select(
            F.hash("s1").alias("h1"), F.hash("d1").alias("h2"),
            F.hash("x", "f", "s2", "d2").alias("h3"),
            F.when(F.col("x") > 0, F.col("d1")).otherwise(F.col("d2"))
            .alias("c1"),
            F.when(F.col("x") > 2, F.col("s1")).when(F.col("x") > 0,
                                                     F.col("d1"))
            .alias("c2"),
            F.coalesce("s1", "s2").alias("c3"),
            F.coalesce("d1", "s1", F.lit("z")).alias("c4"))
    got, want = _card_and_cpu(query)
    for c in want.columns:
        assert list(got[c].astype(object).where(got[c].notna(), None)) == \
            list(want[c].astype(object).where(want[c].notna(), None)), c


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aggregates_with_percentiles", "etl"])
def test_mortgage_query_on_the_card(cuda_device, name):
    """A Mortgage query at SF 1 through the session in test mode equals
    pandas (``testing/mortgagecases.py``)."""
    from spark_rapids_tpu_torch.models import mortgage
    from spark_rapids_tpu_torch.models import mortgage_data as D
    from spark_rapids_tpu_torch.session import TpuSparkSession
    from spark_rapids_tpu_torch.testing import mortgagecases
    perf, acq = D.gen_performance(1.0), D.gen_acquisition(1.0)
    s = (TpuSparkSession.builder().config("spark.rapids.sql.test.enabled",
                                          True).get_or_create())
    got = mortgage.run_query(name, s, s.create_dataframe(perf),
                             s.create_dataframe(acq)).collect()
    mortgagecases.same_answer(
        name, got, mortgagecases.pandas_reference(name, perf, acq))


def _spill_batch(n, device, seed=0):
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    rng = np.random.default_rng(seed)
    return DeviceBatch.from_pandas(pd.DataFrame({
        "a": rng.integers(0, 1 << 40, n),
        "b": rng.normal(size=n),
        "s": np.array([f"k{i % 1000:04d}" for i in range(n)], dtype=object),
    }), {}, device=device, slab_stride=64)


@pytest.mark.cuda
def test_spill_frees_device_bytes(cuda_device, tmp_path):
    """A device -> host spill drops every device tensor of the batch:
    ``torch.cuda.memory_allocated()`` falls by at least the spilled bytes,
    and the fault-back gives the same rows."""
    from spark_rapids_tpu_torch.memory.spill import BufferCatalog
    batch = _spill_batch(1 << 22, cuda_device)
    want = batch.to_pandas()
    c = BufferCatalog(host_limit_bytes=1 << 30, disk_dir=str(tmp_path),
                      device="cuda")
    try:
        bid = c.add_batch(batch)
        size = batch.device_memory_size()
        del batch
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        assert c.device_store.synchronous_spill(0) == size
        assert before - torch.cuda.memory_allocated() >= size
        assert c.host_store.arena.pinned
        pd.testing.assert_frame_equal(c.acquire_batch(bid).to_pandas(), want)
    finally:
        c.close()


@pytest.mark.cuda
def test_pinned_extent_not_reused_before_its_copy_ends(cuda_device,
                                                       tmp_path):
    """The fault-back copies out of the pinned arena asynchronously: its
    extents go back to the pool only once the copy's event completes. With
    the copy held behind a long kernel, a new allocation of the whole
    arena waits for it (one counted sync), so overwriting the pool cannot
    reach the rows in flight."""
    from spark_rapids_tpu_torch.memory.spill import BufferCatalog
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    batch = _spill_batch(1 << 14, cuda_device, seed=1)
    want = batch.to_pandas()
    c = BufferCatalog(host_limit_bytes=1 << 20, disk_dir=str(tmp_path),
                      device="cuda")
    arena = c.host_store.arena
    try:
        bid = c.add_batch(batch)
        del batch
        c.device_store.synchronous_spill(0)
        assert arena.allocated > 0
        torch.cuda._sleep(500_000_000)  # the copy queues behind this
        got = c.acquire_batch(bid)
        assert arena.allocated > 0  # parked, not free
        before = SYNCS.syncs.get("spill.arenaReuse", 0)
        off = arena.alloc(arena.capacity)
        assert off == 0
        assert SYNCS.syncs.get("spill.arenaReuse", 0) == before + 1
        arena.view(off, arena.capacity).fill_(0xFF)
        torch.cuda.synchronize()
        pd.testing.assert_frame_equal(got.to_pandas(), want)
        arena.free(off)
    finally:
        c.close()


def _rollup_frame(n: int):
    rng = np.random.default_rng(16)

    def nulls(values):
        out = np.asarray(values, dtype=object)
        out[rng.random(n) < 0.08] = None
        return out
    regions = np.array(["east", "west", "north", "south"], dtype=object)
    return pd.DataFrame({
        "dct": nulls(regions[rng.integers(0, 4, n)]),
        "slb": nulls([f"store-{i:05d}" for i in rng.integers(0, 3000, n)]),
        "pln": nulls(["p" * 66 + str(i) for i in rng.integers(0, 3000, n)]),
        "k": rng.integers(0, 3, n).astype(np.int32),
        "qty": pd.Series(rng.integers(1, 50, n)).astype("Int64").mask(
            pd.Series(rng.random(n) < 0.1)),
    })


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dct", "slb", "pln"])
def test_rollup_null_string_keys_through_b2_on_the_card(cuda_device, form):
    """rollup(<string key>, k) under HASH_AGG_CONFS on 200,000 rows in
    2^16-row batches (each grouping set's batch stays whole), the key a
    dictionary, a slab or plain chars with NULLs of its own: the grouping
    sets whose key is the NULL literal (a dictionary) and every
    dictionary-keyed batch go through B2 (launched), a slab or plain key
    through the sorted branches; the card's groups equal the CPU
    session's."""
    from spark_rapids_tpu_torch.models.tpch import HASH_AGG_CONFS
    from spark_rapids_tpu_torch.sql import functions as F
    df = _rollup_frame(200_000)
    K.reset_launches()
    got, want = _card_and_cpu(
        lambda s: s.create_dataframe(df, 2).rollup(form, "k").agg(
            F.sum("qty").alias("total"), F.count("*").alias("n")),
        **dict(HASH_AGG_CONFS, **{"spark.rapids.sql.batchSizeRows":
                                  1 << 16}))
    assert K.LAUNCHES["hash_grouped_aggregate"] > 0
    assert _sorted_rows(got) == _sorted_rows(want)


@pytest.mark.cuda
def test_explode_past_int32_chars_raises_on_the_card(cuda_device):
    """2^17 rows of 400 bytes, 50 tokens each: the text copied once per
    token would take 2.6e9 chars, past what int32 offsets address. The
    one totals sync reads it and the operator raises, naming the column,
    before it allocates anything."""
    from spark_rapids_tpu_torch.columnar import dtypes
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec.cpu import CpuScanExec
    from spark_rapids_tpu_torch.exec.generate import TpuGenerateExec
    rows, width = 1 << 17, 400
    row = (b"abcdefg," * 50)[:width - 1] + b"z"
    chars = torch.tensor(list(row), dtype=torch.uint8,
                         device=cuda_device).repeat(rows)
    col = DeviceColumn(dtypes.STRING, None, torch.ones(
        rows, dtype=torch.bool, device=cuda_device), chars=chars,
        offsets=torch.arange(rows + 1, dtype=torch.int32,
                             device=cuda_device) * width)
    schema = Schema(["text"], [dtypes.STRING])
    batch = DeviceBatch(schema, [col], torch.full(
        (), rows, dtype=torch.int32, device=cuda_device))
    gen = TpuGenerateExec(CpuScanExec(None, schema), 0, ",", "w", False)
    with pytest.raises(ValueError, match="'text' would need"):
        gen._expand(batch, 2.0)


@pytest.mark.cuda
def test_expression_cases_on_the_card(cuda_device):
    """Every case of ``testing/exprcases.py`` (rand and the ids over four
    partitions included) on 50,000 rows: the card's answer equals the CPU
    session's, bit for bit where exact, within rtol 1e-13 where
    ``APPROX``."""
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.testing import exprcases as E
    df = E.frame(50_000)
    got, want = _card_and_cpu(
        lambda s: E.projection(F, s, df, num_partitions=4),
        **{"spark.rapids.sql.batchSizeRows": 8192})
    got = got.sort_values("id").reset_index(drop=True)
    want = want.sort_values("id").reset_index(drop=True)
    errs = [f"{n}: {e}" for n in E.CASES
            if (e := E.same_values(got[n], want[n], n in E.APPROX))]
    assert not errs, errs
    r = got.rand42.to_numpy(np.float64)
    assert np.array_equal(r.view(np.int64),
                          want.rand42.to_numpy(np.float64).view(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dct", "slb", "pln"])
def test_explode_on_the_card(cuda_device, form):
    """explode and posexplode of split over each source form on 100,000
    rows: the card's rows equal the CPU session's."""
    from spark_rapids_tpu_torch.sql import functions as F
    rng = np.random.default_rng(9)
    n = 100_000
    words = np.array(["a", "bb", "", "dé", "eeeee", "f" * 40], dtype=object)
    few = np.array(["a,b", "", ",c,", "dé"], dtype=object)
    if form == "dct":
        src = few[rng.integers(0, len(few), n)]
    else:
        k = rng.integers(0, 9, n)
        src = np.array([",".join(words[rng.integers(0, 6, j)]) for j in k],
                       dtype=object)
        if form == "pln":
            src[::5] = [v + "," + "x" * 70 for v in src[::5]]
    src[rng.random(n) < 0.1] = None
    df = pd.DataFrame({"id": np.arange(n), "t": src})
    for fn in (F.explode, F.posexplode):
        got, want = _card_and_cpu(lambda s: s.create_dataframe(df).with_column(
            "w", fn(F.split(F.col("t"), ","))))
        assert _sorted_rows(got) == _sorted_rows(want)


def _session_on(device, **conf):
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = (TpuSparkSession.builder().device(device)
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_write_from_card_batches_equals_cpu_path(cuda_device, tmp_path, fmt):
    """A write of card batches holding a dictionary, a char slab and a
    plain string column (and NULLs in each) gives the same files as the
    same write from CPU batches, read back by pyarrow."""
    import glob
    import pyarrow as pa
    import pyarrow.csv as pacsv
    import pyarrow.orc as paorc
    import pyarrow.parquet as pq
    rng = np.random.default_rng(6)
    n = 50_000
    df = pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "v": rng.standard_normal(n),
        "dct": rng.choice(["AIR", "RAIL", "SHIP", None], n),
        "slb": [None if i % 9 == 0 else f"comment {i} {'z' * (i % 30)}"
                for i in range(n)],
        "pln": [None if i % 7 == 0 else f"{i}" + "p" * (i % 200)
                for i in range(n)],
    })
    read = {"parquet": pq.read_table, "orc": paorc.read_table,
            "csv": pacsv.read_csv}[fmt]
    tables = []
    for device in ("cuda", "cpu"):
        s = _session_on(device)
        sdf = s.create_dataframe(df, 2)
        (batch, *_rest) = sdf.collect_batches()
        forms = [("dict" if c.dict_values is not None else
                  "slab" if c.has_slab else "plain" if c.is_plain else "")
                 for c in batch.columns[2:]]
        assert forms == ["dict", "slab", "plain"], forms
        out = str(tmp_path / device)
        getattr(sdf.write, fmt)(out)
        files = sorted(glob.glob(f"{out}/*.{fmt}"))
        tables.append(pa.concat_tables([read(f) for f in files]))
    assert tables[0].equals(tables[1], check_metadata=True)


@pytest.mark.cuda
def test_partition_columns_decode_as_device_constants(cuda_device,
                                                      tmp_path):
    """A hive layout read on the card: the partition keys (string, int,
    NULL) are device columns built without an upload (the scan's upload
    bytes are the data columns' plans alone), equal to the CPU scan's."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    from spark_rapids_tpu_torch.sql import functions as F
    rng = np.random.default_rng(2)
    n = 30_000
    df = pd.DataFrame({"x": np.arange(n, dtype=np.int64),
                       "v": rng.random(n),
                       "flag": rng.choice(["A", "N", "R"], n),
                       "yr": rng.choice([1994, 1995], n).astype(np.int64)})
    df.loc[df.index % 11 == 0, "flag"] = None
    _session_on("cpu").create_dataframe(df, 2).write.partition_by(
        "flag", "yr").parquet(str(tmp_path / "h"))

    def upload_bytes(s, cols):
        before = SYNCS.bytes.get("scan.upload", 0)
        batches = s.read.parquet(str(tmp_path / "h")).select(
            *cols).collect_batches()
        return SYNCS.bytes.get("scan.upload", 0) - before, batches

    outs = []
    for device in ("cuda", "cpu"):
        s = _session_on(device, **{
            "spark.rapids.sql.scan.pageCache.enabled": False})
        with_keys, batches = upload_bytes(s, ["x", "v", "flag", "yr"])
        data_only, _ = upload_bytes(s, ["x", "v"])
        assert with_keys == data_only > 0
        for b in batches:
            assert b.column("flag").dict_values is not None
            assert b.column("flag").validity.device.type == device
            assert b.column("yr").data.device.type == device
        outs.append(s.read.parquet(str(tmp_path / "h")).filter(
            F.col("yr") == 1995).collect())
    assert _sorted_rows(outs[0]) == _sorted_rows(outs[1])
    assert len(outs[0]) == int((df.yr == 1995).sum())


def _obs_session(**conf):
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = TpuSparkSession.builder().config("spark.rapids.sql.test.enabled",
                                         True)
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


@pytest.mark.cuda
def test_transfer_guard_catches_an_uncounted_wait(cuda_device, monkeypatch):
    """Under ``spark.rapids.tpu.debug.transferGuard=disallow`` (the sync
    debug mode "error" around the query body) a session Q1 completes with
    its counted syncs, and an aggregate that reads its input's row count
    with a bare ``.item()`` (no ``sync_scope``) raises; without the guard
    the same query completes. (Q1's filter fuses into its aggregate,
    ``spark.rapids.sql.agg.fuseFilter``: the leak sits in the aggregate,
    which runs either way.)"""
    from spark_rapids_tpu_torch.exec.tpu import TpuHashAggregateExec
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    li = G.gen_lineitem(0.01)
    s = _obs_session()

    def counted_q1():
        before = dict(SYNCS.syncs)
        got = tpch.q1(s, {"lineitem": s.create_dataframe(li)}).collect()
        assert len(got) == 6
        return {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                if v != before.get(k, 0)}
    plain = counted_q1()
    s.set_conf("spark.rapids.tpu.debug.transferGuard", "disallow")
    assert counted_q1() == plain and plain["scan.upload"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0  # restored
    orig = TpuHashAggregateExec.partitions

    def leaky(self, ctx):
        def wrap(part):
            def run():
                for b in part():
                    b.num_rows.item()  # an uncounted host wait
                    yield b
            return run
        return [wrap(p) for p in orig(self, ctx)]
    monkeypatch.setattr(TpuHashAggregateExec, "partitions", leaky)
    with pytest.raises(RuntimeError, match="synchroniz"):
        tpch.q1(s, {"lineitem": s.create_dataframe(li)}).collect()
    assert torch.cuda.get_sync_debug_mode() == 0
    s.set_conf("spark.rapids.tpu.debug.transferGuard", "off")
    assert len(tpch.q1(s, {"lineitem": s.create_dataframe(li)})
               .collect()) == 6


@pytest.mark.cuda
def test_nvtx_ranges_balance_across_a_raising_span(cuda_device,
                                                   monkeypatch):
    """Every NVTX range a span pushes is popped, an exception in the span
    (or in a nested one) included. The pushes and pops are counted around
    the real ``torch.cuda.nvtx`` calls (whose return value is no depth
    without a profiler attached)."""
    from spark_rapids_tpu_torch.obs.trace import Tracer
    open_ranges = []
    push, pop = torch.cuda.nvtx.range_push, torch.cuda.nvtx.range_pop

    def counted_push(msg):
        open_ranges.append(msg)
        return push(msg)

    def counted_pop():
        open_ranges.pop()
        return pop()
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", counted_push)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", counted_pop)
    tr = Tracer()
    tr.configure(True, nvtx=True)
    with pytest.raises(ValueError):
        with tr.span("outer"):
            with tr.span("inner"):
                assert open_ranges == ["outer", "inner"]
                raise ValueError("x")
    assert open_ranges == []
    with tr.span("ok"):
        assert open_ranges == ["ok"]
    assert open_ranges == []
    assert [e["name"] for e in tr.events()] == ["inner", "outer", "ok"]
    assert tr.events()[0]["args"]["error"] == "ValueError"


@pytest.mark.cuda
def test_session_nvtx_trace_on_the_card(cuda_device, tmp_path):
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.obs.trace import TRACER
    path = str(tmp_path / "q1.trace.json")
    s = _obs_session(**{"spark.rapids.tpu.trace.path": path,
                        "spark.rapids.tpu.trace.nvtx": True})
    try:
        got = tpch.q1(s, {"lineitem": s.create_dataframe(
            G.gen_lineitem(0.01))}).collect()
    finally:
        TRACER.configure(False)
    assert len(got) == 6
    import json
    names = {ev["name"] for ev in json.load(open(path))["traceEvents"]}
    assert {"Query", "TpuScanExec", "sync.batch.fetch"} <= names


@pytest.mark.cuda
def test_obs_phase_checks_at_a_small_size(cuda_device, tmp_path,
                                          monkeypatch):
    """``chip_smoke.obs_phase`` at SF 0.05: the three modes' answers and
    syncs agree, the traced Q3's spans, sync track, ledger and journal
    agree, the syncEachOp breakdown sums to each node's exclusive time,
    the guarded Q3 keeps its syncs, and Q9's trace summarizes."""
    import chip_smoke as cs
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    monkeypatch.setattr(cs, "OBS_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cs, "OBS_OUT", str(tmp_path / "out"))
    sf = 0.05
    frames = {"lineitem": G.gen_lineitem(sf), "orders": G.gen_orders(sf),
              "customer": G.gen_customer(sf)}
    sess = cs.session_of(1 << 16, **tpch.HASH_AGG_CONFS)
    tables = {n: sess.create_dataframe(f) for n, f in frames.items()}
    # the uploads, and the capacity speculation's learning runs (the
    # shrink counts speculate once two runs agree): the modes' runs are
    # then all warm, as the smoke's cell is
    for _ in range(3):
        tpch.q3(sess, tables).collect()
    framesh = dict(frames, supplier=G.gen_supplier(sf),
                   part=G.gen_part(sf), partsupp=G.gen_partsupp(sf),
                   nation=G.gen_nation())
    paths = G.write_parquet(str(tmp_path / "pq"), sf, tables=list(framesh),
                            frames=framesh)
    from spark_rapids_tpu_torch.testing import tpchcases
    report = {}
    cs.obs_phase((sess, tables, cs.q3_reference(
        frames["lineitem"], frames["orders"], frames["customer"])),
        paths, tpchcases.pandas_reference("q9", framesh),
        framesh["lineitem"], 1 << 16, 1, {}, report)
    rec = report["obs_phase"]
    assert rec["session_q3"]["syncs_before_collect"] == {
        "speculation.verify": 1}
    assert rec["q3_sync_each_op"]["worst_breakdown_gap_s"] <= 1e-3
    assert rec["q9_parquet"]["sync_by_site"]
    assert 0.0 <= rec["q9_parquet"]["occupancy_pct"] <= 100.0


@pytest.mark.cuda
def test_sync_scopes_on_two_threads_keep_the_debug_mode(cuda_device):
    """Under the sync debug mode "error", thread A's scope closes while
    thread B's is open: B's counted copy still passes, and "error" is in
    force again once both closed (each scope used to restore the mode it
    saw on entry)."""
    import threading
    from spark_rapids_tpu_torch.obs.syncledger import guard_context, sync_scope
    x = torch.arange(1 << 16, device=cuda_device)
    a_in, a_out, b_in = (threading.Event() for _ in range(3))
    errors = []

    def thread_a():
        with sync_scope("test.a"):
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        try:
            with sync_scope("test.b"):
                b_in.set()
                a_out.wait(10)
                assert int(x.sum().item()) == (1 << 16) * ((1 << 16) - 1) // 2
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    with guard_context("disallow", cuda_device):
        ts = [threading.Thread(target=f, daemon=True)
              for f in (thread_a, thread_b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert not errors, errors
        assert torch.cuda.get_sync_debug_mode() == 2
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.sum().item()  # an uncounted wait still raises
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_socket_manager_q3_under_the_transfer_guard(cuda_device):
    """Session Q3 at SF 0.05 over the socket shuffle manager with two
    executors under ``transferGuard=disallow``: the counted syncs before
    the collect are the smoke's stated ones, the answer equals pandas, and
    no shuffle block survives the query."""
    import chip_smoke as cs
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    sf = 0.05
    li, o, c = G.gen_lineitem(sf), G.gen_orders(sf), G.gen_customer(sf)
    # capacity speculation off, as in the smoke's manager cells: the
    # stated syncs are those of runs that read their sizes exactly
    s = cs.session_of(1 << 23, **dict(
        tpch.HASH_AGG_CONFS, **cs.SHUFFLE_MANAGER_CONFS, **cs.GUARD,
        **{"spark.rapids.shuffle.transport.class": "socket",
           "spark.rapids.sql.adaptiveCapacity.enabled": False}))
    try:
        t = {"lineitem": s.create_dataframe(li, cs.SHUFFLE_MAP_PARTS),
             "orders": s.create_dataframe(o, cs.SHUFFLE_MAP_PARTS),
             "customer": s.create_dataframe(c, cs.SHUFFLE_MAP_PARTS)}
        tpch.q3(s, t).collect()
        with cs._remote_blocks(s) as blocks:
            pre = cs._syncs_by_site(tpch.q3(s, t).collect_batches)
        assert pre == cs.q3_manager_syncs(cs.SHUFFLE_PARTS,
                                          cs.SHUFFLE_MAP_PARTS,
                                          blocks["blocks"])
        cs.check_q3(tpch.q3(s, t).collect(), cs.q3_reference(li, o, c))
        assert s.shuffle_envs[1].transport.stats["tagged_frames"] > 0
        assert not any(e.shuffle_catalog._blocks for e in s.shuffle_envs)
    finally:
        s.stop()


@pytest.mark.cuda
def test_shuffle_phase_checks_at_a_small_size(cuda_device, tmp_path,
                                              monkeypatch):
    """``chip_smoke.shuffle_phase`` at SF 0.05: the buckets route's stated
    syncs and launches, the range sort against a lexsort, the
    repartition(4) write, both manager transports with their stated syncs
    and the dropped connection's one retry."""
    import chip_smoke as cs
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    monkeypatch.setattr(cs, "SHUFFLE_DIR", str(tmp_path / "shuffle"))
    sf = 0.05
    li, o, c = G.gen_lineitem(sf), G.gen_orders(sf), G.gen_customer(sf)
    sess = cs.session_of(1 << 23, **dict(tpch.HASH_AGG_CONFS, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1}))
    tables = {"lineitem": sess.create_dataframe(li),
              "orders": sess.create_dataframe(o),
              "customer": sess.create_dataframe(c)}
    tpch.q3(sess, tables).collect()
    report = {}
    cs.shuffle_phase((sess, tables, cs.q3_reference(li, o, c)), li, o, c,
                     1 << 23, 1, {}, report, hash_joins=False)
    rec = report["shuffle_phase"]
    assert rec["q3_buckets_hash"]["syncs_before_collect"] == \
        cs.q3_bucket_syncs(cs.SHUFFLE_PARTS)
    assert rec["q3_buckets_speculated"]["reruns"] == 0
    assert rec["q3_buckets_speculated"]["warm_syncs"] == {
        "exchange.split": 6, "exchange.rangeBounds": 1,
        "limit.remaining": 1, "speculation.verify": 1}
    assert rec["repartition_write"]["files"] == 4
    assert rec["q3_manager_socket"]["drop_retry"]["retries"] == 1
    sess.stop()


def _card_syncs(fn):
    """(fn's result, its counted syncs by site), under the sync debug
    mode "error"."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    before = dict(SYNCS.syncs)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                 if v != before.get(k, 0)}


@pytest.mark.cuda
def test_speculative_warm_join_and_forced_miss_on_the_card(cuda_device):
    """Session Q3 on the card under the sync debug mode "error": warm runs
    defer both joins' totals to one ``speculation.verify`` (the pinned
    host copies read only after their events); a cut capacity re-runs the
    query once with the same answer."""
    import chip_smoke as cs
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    li, o, c = G.gen_lineitem(0.05), G.gen_orders(0.05), G.gen_customer(0.05)
    sess = cs.session_of(1 << 16, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1})
    t = {"lineitem": sess.create_dataframe(li),
         "orders": sess.create_dataframe(o),
         "customer": sess.create_dataframe(c)}
    q = tpch.q3(sess, t)
    want = q.collect()
    for _ in range(3):
        q.collect_batches()
    _out, syncs = _card_syncs(q.collect_batches)
    assert syncs == {"speculation.verify": 1}
    key = next(k for k, e in sess.capacity_cache.items() if e.get("sizes")
               and any(sz[0] > 4 for sz in e["sizes"]))
    sess.capacity_cache[key]["sizes"] = [
        [max(sz[0] // 4, 1)] + sz[1:]
        for sz in sess.capacity_cache[key]["sizes"]]
    got, syncs = _card_syncs(q.collect)
    assert sess.capacity_spec_reruns == 1
    assert syncs["speculation.verify"] == 1
    assert syncs["join.expandTotals"] == 2
    cs.check_q3(got, cs.q3_reference(li, o, c))
    cs.check_q3(want, cs.q3_reference(li, o, c))
    sess.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 300_000])
def test_dense_composite_on_the_card_equals_cpu(cuda_device, n):
    from spark_rapids_tpu_torch.columnar import dtypes
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
    from spark_rapids_tpu_torch.ops import aggregate
    rng = np.random.default_rng(n)
    frame = pd.DataFrame({
        "a": pd.Series(rng.integers(-50, 200, n)).astype("Int64")
               .mask(pd.Series(rng.random(n) < 0.1)),
        "b": rng.integers(0, 9000, n).astype(np.int32)})
    schema = Schema(["a", "b"], [dtypes.INT64, dtypes.INT32])
    cpu = DeviceBatch.from_pandas(frame, {}, device="cpu", schema=schema)
    card = DeviceBatch.from_pandas(frame, {}, device="cuda", schema=schema)
    for los, sizes in (([-50, 0], (256, 16384)), ([0, 100], (128, 4096))):
        pc, pok = aggregate.dense_composite(
            cpu, [0, 1], torch.tensor(los), sizes, cpu.row_mask())
        gc, gok = aggregate.dense_composite(
            card, [0, 1], torch.tensor(los, device="cuda"), sizes,
            card.row_mask())
        assert torch.equal(gc.cpu(), pc) and bool(gok) == bool(pok)


@pytest.mark.cuda
def test_fused_filter_aggregate_on_b2_equals_unfused(cuda_device):
    """A filter fused into a partial aggregate on the hash branch (B2):
    the same groups and sums as the filter compacting first, and B2
    launched."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.session import TpuSparkSession
    from spark_rapids_tpu_torch.sql import functions as F
    rng = np.random.default_rng(5)
    n = 200_000
    frame = pd.DataFrame({"k": rng.integers(0, 20000, n).astype(np.int64),
                          "v": rng.uniform(0, 1, n)})
    b = TpuSparkSession.builder().config("spark.rapids.sql.test.enabled",
                                         True)
    for k, v in tpch.HASH_AGG_CONFS.items():
        b.config(k, v)
    s = b.get_or_create()
    d = s.create_dataframe(frame)
    q = d.filter(F.col("v") > 0.25).group_by("k").agg(
        F.sum("v").alias("sv"), F.count("*").alias("n"))
    K.reset_launches()
    on = q.collect().sort_values("k").reset_index(drop=True)
    assert K.LAUNCHES["hash_grouped_aggregate"] > 0
    assert any(getattr(x, "pre_mask", None) is not None
               for x in s.last_plan.walk())
    s.set_conf("spark.rapids.sql.agg.fuseFilter", False)
    off = q.collect().sort_values("k").reset_index(drop=True)
    assert list(on.k) == list(off.k) and list(on.n) == list(off.n)
    np.testing.assert_allclose(on.sv, off.sv, rtol=F64_RTOL)
    s.stop()


@pytest.mark.cuda
def test_adaptive_phase_checks_at_a_small_size(cuda_device):
    """``chip_smoke.adaptive_phase`` at SF 0.05 with the skewed join at
    its own size: every stated sync count, the dense branch, the AQE
    decisions and the fused stage."""
    import chip_smoke as cs
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    sf = 0.05
    li, o, c = G.gen_lineitem(sf), G.gen_orders(sf), G.gen_customer(sf)
    sess = cs.session_of(1 << 16, **dict(tpch.HASH_AGG_CONFS, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1}))
    tables = {"lineitem": sess.create_dataframe(li),
              "orders": sess.create_dataframe(o),
              "customer": sess.create_dataframe(c)}
    tpch.q3(sess, tables).collect()
    qs = cs.session_of(1 << 16)
    qt = {"lineitem": qs.create_dataframe(li)}
    report = {}
    cs.fusion_cells(qs, qt, cs.q1_reference(li), cs.q6_reference(li),
                    -(-len(li) // (1 << 16)), 1, report)
    cs.adaptive_phase((sess, tables, cs.q3_reference(li, o, c)), li, o, c,
                      1 << 16, {}, report, shared=False)
    rec = report["adaptive"]
    assert rec["speculation"]["runs"][-1]["syncs"] == {
        "speculation.verify": 1}
    assert rec["dense"]["runs"][2]["branches"].get("dense", 0) > 0
    assert rec["aqe"]["q3"]["stages"] >= 1
    assert len(rec["whole_stage"]["members"]) >= 4
    for s in (sess, qs):
        s.stop()


@pytest.mark.cuda
def test_two_threads_serve_q3_on_the_card(cuda_device):
    """A two-worker scheduler serving Q3 six times on the card: every
    answer equals the single-threaded one, the launches are exactly six
    times one run's, and five of the six runs are plan-cache clones."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.session import TpuSparkSession
    sf = 0.05
    fr = {"lineitem": G.gen_lineitem(sf), "orders": G.gen_orders(sf),
          "customer": G.gen_customer(sf)}
    s = (TpuSparkSession.builder()
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .config("spark.rapids.sql.concurrentTpuTasks", 2)
         .get_or_create())
    try:
        t = {n: s.create_dataframe(f) for n, f in fr.items()}
        q = tpch.q3(s, t)
        want = q.collect()
        q.collect()
        K.reset_launches()
        one = q.collect()
        torch.cuda.synchronize()
        per_run = dict(K.LAUNCHES)
        assert per_run["hash_table_build"] > 0 \
            or per_run["compact_permutation"] > 0
        hits0 = sum(m.value for m in REGISTRY.metrics()
                    if m.name == "plancache.hits")
        sched = s.serving_scheduler(workers=2)
        K.reset_launches()
        try:
            jobs = [sched.submit(lambda ss: tpch.q3(ss, t), tenant=f"t{i % 2}")
                    for i in range(6)]
            outs = [j.get(300) for j in jobs]
        finally:
            sched.close()
        torch.cuda.synchronize()
        for out in outs + [one]:
            pd.testing.assert_frame_equal(out.reset_index(drop=True),
                                          want.reset_index(drop=True))
        assert K.LAUNCHES == {k: 6 * v for k, v in per_run.items()}
        hits = sum(m.value for m in REGISTRY.metrics()
                   if m.name == "plancache.hits") - hits0
        assert hits == 6
    finally:
        s.stop()


@pytest.mark.cuda
def test_prewarm_replays_b1_to_b4_on_the_card(cuda_device, tmp_path):
    """Launches recorded in a warm manifest on the card replay through the
    pre-warm on zero-filled inputs: no error, the launches counted apart
    from the main path's."""
    from spark_rapids_tpu_torch.obs.compilecache import SHARED
    from spark_rapids_tpu_torch.serving import prewarm
    path = str(tmp_path / "warm.jsonl")
    SHARED.configure_warm_manifest(path)
    try:
        n = 5000
        keep = torch.rand(n, device=cuda_device) < 0.5
        K.compact_permutation(keep)
        img = [torch.randint(0, 100, (n,), device=cuda_device)]
        valid = torch.ones(n, dtype=torch.bool, device=cuda_device)
        T = K.hash_table_size(n)
        jt = K.hash_join_build(img, valid, T)
        K.hash_join_lookup(jt, img, valid)
        K.hash_table_probe(jt.table, jt.counts, img, valid, T)
        jobs = [("sum", torch.rand(n, dtype=torch.float64,
                                   device=cuda_device), valid)]
        K.hash_grouped_aggregate(img, valid, jobs, T)
        torch.cuda.synchronize()
    finally:
        SHARED.configure_warm_manifest("")
    kernels = {e["kernel"] for e in prewarm.load_manifest(path)}
    assert {"compact_permutation", "hash_table_build", "hash_table_probe",
            "hash_grouped_aggregate"} <= kernels
    K.reset_launches()
    before = dict(K.PREWARM_LAUNCHES)
    p = prewarm.AotPrewarmer(path, budget_s=60.0, device="cuda").start()
    assert p.wait_idle(120)
    torch.cuda.synchronize()
    snap = p.snapshot()
    assert snap["failed"] == 0 and snap["warmed"] >= 5, snap
    assert snap["librariesLoaded"] == len(snap["libraries"])
    assert not any(K.LAUNCHES.values())
    for k in ("compact_permutation", "hash_table_build", "hash_table_probe",
              "hash_grouped_aggregate"):
        assert K.PREWARM_LAUNCHES[k] > before[k]


@pytest.mark.cuda
def test_monitor_status_reports_the_card(cuda_device):
    import json
    import urllib.request

    from spark_rapids_tpu_torch.obs import monitor
    from spark_rapids_tpu_torch.session import TpuSparkSession
    s = (TpuSparkSession.builder().config("spark.rapids.tpu.ui.enabled", True)
         .config("spark.rapids.tpu.ui.port", 0).get_or_create())
    try:
        s.create_dataframe(pd.DataFrame({"a": [1, 2, 3]})).collect()
        with urllib.request.urlopen(monitor.server().url + "/api/status",
                                    timeout=10) as r:
            status = json.loads(r.read())
        dev = status["device"]
        assert dev["platform"] == "gpu"
        assert dev["name"] == torch.cuda.get_device_name(0)
        assert 0 < dev["freeBytes"] <= dev["totalBytes"]
        assert status["memory"]["budgetBytes"] <= dev["totalBytes"]
    finally:
        monitor.stop()
        s.stop()


@pytest.mark.cuda
def test_columnar_rdd_export_on_the_card(cuda_device):
    """The ColumnarRdd export of a filtered frame (``ml/columnar_rdd.py``):
    batches whose columns are CUDA tensors, CUDA feature matrices, and no
    counted sync (a filter-only plan over cached uploads: the row counts
    stay on the card; an upload itself is one counted ``scan.upload``)."""
    from spark_rapids_tpu_torch.ml import ColumnarRdd
    from spark_rapids_tpu_torch.ml.columnar_rdd import to_feature_matrix
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    from spark_rapids_tpu_torch.session import TpuSparkSession
    from spark_rapids_tpu_torch.sql import functions as F
    s = (TpuSparkSession.builder()
         .config("spark.rapids.sql.exportColumnarRdd", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .config("spark.rapids.sql.test.enabled", True).get_or_create())
    try:
        pdf = pd.DataFrame({"f1": np.linspace(0, 1, 4096),
                            "f2": np.linspace(2, 3, 4096),
                            "label": (np.arange(4096) % 2).astype(float)})
        df = s.create_dataframe(pdf, 2).filter(F.col("f1") > 0.25)
        df.collect()  # the uploads, cached
        torch.cuda.synchronize()
        before = SYNCS.total()
        mats = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for part in ColumnarRdd.convert(df):
                for batch in part():
                    assert all(c.data.is_cuda for c in batch.columns)
                    mats.append(to_feature_matrix(batch, ["f1", "f2"],
                                                  "label"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert SYNCS.total() == before
        assert all(t.is_cuda for m in mats for t in m)
        rows = sum(int(m[2].sum()) for m in mats)
        assert rows == int((pdf.f1 > 0.25).sum())
        x = torch.cat([m[0][m[2]] for m in mats]).cpu().numpy()
        want = pdf[pdf.f1 > 0.25][["f1", "f2"]].to_numpy(np.float32)
        np.testing.assert_array_equal(np.sort(x, axis=0),
                                      np.sort(want, axis=0))
    finally:
        s.stop()


@pytest.mark.cuda
def test_shims_equal_the_direct_calls(cuda_device):
    from spark_rapids_tpu_torch.ops import cudalib
    from spark_rapids_tpu_torch.shims.loader import ShimLoader
    shims = ShimLoader.get_shims()
    free, total = shims.mem_get_info(cuda_device)
    assert total == torch.cuda.mem_get_info(cuda_device)[1]
    assert 0 < free <= total
    assert shims.device_count() == torch.cuda.device_count()
    assert shims.nvcc_arch_flags()[0] in cudalib.NVCC_FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in cudalib.NVCC_FLAGS
    buf = shims.empty_host(4096, pinned=True)
    assert buf.is_pinned() and buf.numel() == 4096
    shims.nvtx_push("srt-shim-test")
    shims.nvtx_pop()
