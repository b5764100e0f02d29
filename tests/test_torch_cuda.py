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


def _join_case(case, rng, dev):
    """(build images, build valid, stream images, stream valid)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nb, ns = 30_000, 40_000
    if case == "empty":
        nb = ns = 0
    elif case == "skewed":  # one key: every hit expands to ~nb rows
        ns = 64
    k = {"k2": 2, "k3": 3}.get(case, 1)
    hi = {"skewed": 1, "k2": 40, "k3": 12}.get(case, 20_000)
    bimg = [t(rng.integers(0, hi, nb)) for _ in range(k)]
    simg = [t(rng.integers(0, hi + hi // 4 + 1, ns)) for _ in range(k)]
    bv = t(rng.random(nb) < (0.0 if case == "all_invalid" else 0.9))
    sv = t(rng.random(ns) < 0.95)
    return bimg, bv, simg, sv


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "skewed", "k2", "k3",
                                  "all_invalid", "empty"])
def test_hash_join_kernels_match_plain(cuda_device, case):
    rng = np.random.default_rng(7)
    bimg, bv, simg, sv = _join_case(case, rng, cuda_device)
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
    c, rows = hashcheck.join_matches(*K.hash_join_probe(bimg, bv, simg, sv,
                                                        T))
    c_p, rows_p = hashcheck.join_matches(*K.hash_join_probe_plain(
        bimg, bv, simg, sv, T))
    assert torch.equal(c, c_p) and torch.equal(rows, rows_p)
