"""Advisory scan-statistics resolution shared by the dense-key routes
(the join's direct-index probe, the bounded-int composite grouping key),
the counterpart of the JAX package's ``exec/statsutil.py``.

The session unions each scanned integer column's (min, max) into a
name-keyed registry (``session.column_stats``) and records rename
provenance from the logical plan (``session.column_aliases``). The bounds
are ADVISORY: every consumer verifies them on the device and has an exact
path for a miss, so resolution here only needs to hit usually."""

from __future__ import annotations

from typing import Optional, Tuple


def int_bounds_for_names(session, names) -> Optional[Tuple[int, int]]:
    """Union advisory (lo, hi) over every stats entry reachable from any
    of ``names`` through the rename-alias map (the walk is bounded: alias
    chains are shallow). None when nothing resolves."""
    if session is None:
        return None
    reg = session.column_stats
    amap = session.column_aliases
    names = set(names)
    frontier = set(names)
    for _ in range(8):
        nxt = set()
        for n in frontier:
            nxt |= amap.get(n, set()) - names
        if not nxt:
            break
        names |= nxt
        frontier = nxt
    bounds = [reg[n] for n in names if n in reg]
    if not bounds:
        return None
    return (min(b[0] for b in bounds), max(b[1] for b in bounds))


def _pow2_at_least(n: int) -> int:
    size = 1
    while size < n:
        size <<= 1
    return size


def dense_group_plan(session, key_names, key_dtypes,
                     max_bits: int = 62) -> Optional[Tuple[list, tuple]]:
    """(los, sizes) for a bounded-int composite grouping key
    (``ops/aggregate.dense_composite``), or None. ``key_names``: per key
    a SET of candidate registry names (output name + source name); the
    dtypes must all be fixed-width integers. Sizes bucket to powers of
    two, so the plan is stable under small data drift."""
    import numpy as np
    los, sizes = [], []
    total = 1
    for names, dt in zip(key_names, key_dtypes):
        npdt = np.dtype(dt.np_dtype)
        if dt.is_string or npdt.kind not in ("i", "u"):
            return None
        b = int_bounds_for_names(session, names)
        if b is None:
            return None
        lo, hi = int(b[0]), int(b[1])
        rng = hi - lo + 1
        if rng <= 0:
            return None
        size = _pow2_at_least(rng)
        total *= size + 1
        if total > (1 << max_bits):
            return None
        los.append(lo)
        sizes.append(size)
    # low-cardinality tuples take the dictionary branch anyway
    # (ops/aggregate._dict_path_info, DICT_SLOT_MAX): a dense plan would
    # speculate for nothing
    if total <= 4096:
        return None
    return los, tuple(sizes)
