"""Shape buckets (counterpart of the JAX package's
``utils/kernelcache.py``; only ``bucket_dim`` is ported).

The JAX package pads secondary dimensions up a coarse ladder to bound the
number of XLA programs it compiles; the buckets are off by default there.
PyTorch runs eagerly and compiles nothing per shape, so ``bucket_dim`` is
the identity.
"""

from __future__ import annotations


def bucket_dim(n: int) -> int:
    return n
