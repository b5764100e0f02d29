"""The port's CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device. The file imports nothing of JAX, so it runs where JAX is not
installed: ``python3 -m pytest tests/test_torch_cuda.py -m cuda
--noconftest -q``. Exact equality for permutations, counts and integers;
float64 sums at rtol 1e-9 (atomics add in another order).
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import kernels as K

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
