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
    kernels B1 (and B2 for the Q18 group-by)."""
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
    threshold) and shuffled: the card's answer equals the CPU session's,
    through kernels B3 and B4; the broadcast builds its table once."""
    from spark_rapids_tpu_torch.models import tpch
    conf = ({} if threshold is None else
            {"spark.rapids.sql.autoBroadcastJoinThreshold": threshold})
    outs = []
    for device in ("cuda", "cpu"):
        s = _session(device, **conf)
        t = {n: s.create_dataframe(f, 2) for n, f in tpch_frames.items()}
        K.reset_launches()
        outs.append(tpch.QUERIES[qname](s, t).collect())
        if device == "cuda":
            assert K.LAUNCHES["hash_table_probe"] > 0
            builds = 2 if qname == "q3" else 1
            assert K.LAUNCHES["hash_table_build"] == builds
    got, want = outs
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
    launched."""
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
    for k in ("hybrid_expand", "delta_unpack", "plain_fixed", "slab_pack",
              "hash_table_build", "hash_table_probe"):
        assert K.LAUNCHES[k] > 0, k


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
        outs.append(df.collect())
        if device == "cuda":
            assert K.LAUNCHES["compact_permutation"] > 0
            assert K.LAUNCHES["hash_table_probe"] > 0
    got, want = outs
    assert len(want) > 0
    order = tpchcases.ORDERS[qname]
    if order is not None:
        got = tpchcases.in_query_order(got, order)
        want = tpchcases.in_query_order(want, order)
    tpchcases.same_rows(got, want)
