"""Range bounds from samples (counterpart of one function of the JAX
package's ``parallel/distributed.py``).

Only ``pick_bounds_from_samples`` is ported, for the range partitioners
of one card: the external sort's (``exec/outofcore.external_sort``) and
the range exchange's buckets and shuffle-manager routes
(``exec/tpu.TpuShuffleExchangeExec``). The rest of the module, the device
mesh, its all_to_all exchanges and the distributed range exchange, needs
more than one card (ROADMAP A.9).
"""

from __future__ import annotations

import numpy as np


def pick_bounds_from_samples(samples, k: int, n: int):
    """n-1 lexicographic upper bounds from per-batch operand samples
    (GpuRangePartitioner.scala:42-120). ``samples``: list of (k, m) uint64
    operand matrices. Returns k uint64 vectors of n-1 bounds."""
    if samples:
        all_s = np.concatenate(samples, axis=1)
        order = np.lexsort(all_s[::-1])
        all_s = all_s[:, order]
        total = all_s.shape[1]
        picks = [max(int((i + 1) * total / n) - 1, 0) for i in range(n - 1)]
        return [all_s[j, picks].astype(np.uint64) for j in range(k)]
    return [np.zeros((n - 1,), np.uint64) for _ in range(k)]
