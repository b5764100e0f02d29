"""Dictionary-column helpers (counterpart of the JAX package's
``columnar/dictionary.py``): the concat merge and the per-value tables.

Batches of one scan normally share one dictionary, and a concat then keeps
their codes as they are. Batches whose dictionaries differ merge by the
union of their value sets in canonical sorted order plus one O(cardinality)
int32 remap table per input.

Everything per value is computed on the host once per dictionary tuple
(memoized) and gathered by code on the device:

  * ``value_prefix_chunk_tables``: the 64-byte big-endian prefix images and
    the length of every value, bit-identical to
    ``ops/sortops._string_prefix_chunks`` on the decoded strings;
  * ``value_hash_tables``: the two polynomial hashes of every value,
    bit-identical to the JAX package's ``string_poly_hashes``.

Tables are int64 numpy arrays holding the uint64 patterns (the port's
64-bit convention, ``ops/hashing.py``). The JAX package's
``hash_values_enabled`` switch is not ported: every spelling gives the same
bits, so the port always takes the tables.

``wire_enabled()`` is the process-wide ``spark.rapids.sql.dict.wire``
flag the shuffle wire reads (``shuffle/wire.py``: dictionary columns as
codes and values, frame v2, or as chars and offsets, v1); the session
sets it from its conf at the start of each query
(``configure_from_conf``), as the JAX package's does.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

_M64 = (1 << 64) - 1
_PREFIX_CHUNKS = 8  # keep in sync with ops/sortops.STRING_PREFIX_CHUNKS

# process-wide, like the session conf it mirrors: concurrent queries of one
# session share one conf; every combination is correct (v1 and v2 frames
# both deserialize), only the representation on the wire changes
_FLAGS = {"wire": True}


def configure_from_conf(conf) -> None:
    _FLAGS["wire"] = conf.get_bool("spark.rapids.sql.dict.wire", True)


def wire_enabled() -> bool:
    return _FLAGS["wire"]


def union_dictionaries(dicts: Sequence[tuple]
                       ) -> Tuple[tuple, List[np.ndarray]]:
    """Union the value sets in canonical sorted order and build one int32
    remap table per input: ``remap[old_code] -> new_code`` with the NULL
    sentinel (old card) mapping to the union's NULL sentinel (union card)."""
    union = sorted({v for d in dicts for v in d})
    pos = {v: i for i, v in enumerate(union)}
    ucard = len(union)
    remaps = []
    for d in dicts:
        r = np.empty(len(d) + 1, np.int32)
        for i, v in enumerate(d):
            r[i] = pos[v]
        r[len(d)] = ucard
        remaps.append(r)
    return tuple(union), remaps


def _value_bytes(v) -> bytes:
    return (v if isinstance(v, str) else str(v)).encode("utf-8")


@functools.lru_cache(maxsize=512)
def value_prefix_chunk_tables(dict_values: tuple) -> Tuple[np.ndarray, ...]:
    """(card + 1,) tables, one per prefix-chunk image plus the trailing
    length; entry ``card`` is the NULL/padding sentinel (zero images,
    length 0)."""
    card = len(dict_values)
    out = [np.zeros(card + 1, np.uint64) for _ in range(_PREFIX_CHUNKS + 1)]
    for i, v in enumerate(dict_values):
        raw = _value_bytes(v)
        padded = raw[:8 * _PREFIX_CHUNKS].ljust(8 * _PREFIX_CHUNKS, b"\0")
        for c in range(_PREFIX_CHUNKS):
            out[c][i] = int.from_bytes(padded[8 * c:8 * c + 8], "big")
        out[_PREFIX_CHUNKS][i] = len(raw)
    return tuple(t.view(np.int64) for t in out)


def np_splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over uint64 numpy arrays (the host twin of
    ``ops/hashing.splitmix64``)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


@functools.lru_cache(maxsize=512)
def value_hash_tables(dict_values: tuple) -> Tuple[np.ndarray, np.ndarray]:
    """(h1, h2) tables of shape (card + 1,): the two polynomial hashes of
    each value; entry ``card`` (NULL) holds NULL_HASH, the hash every
    invalid row gets."""
    from spark_rapids_tpu_torch.ops.hashing import (
        NULL_HASH, P1, P2, SALT1, SALT2,
    )
    card = len(dict_values)
    acc1 = np.zeros(card + 1, np.uint64)
    acc2 = np.zeros(card + 1, np.uint64)
    lens = np.zeros(card + 1, np.uint64)
    for i, v in enumerate(dict_values):
        a1 = a2 = 0
        raw = _value_bytes(v)
        for b in raw:
            a1 = (a1 * P1 + b) & _M64
            a2 = (a2 * P2 + b) & _M64
        acc1[i], acc2[i], lens[i] = a1, a2, len(raw)
    with np.errstate(over="ignore"):
        h1 = np_splitmix64(acc1 + np.uint64(SALT1) + lens)
        h2 = np_splitmix64(acc2 + np.uint64(SALT2) + lens)
    h1[card] = NULL_HASH
    h2[card] = NULL_HASH
    return h1.view(np.int64), h2.view(np.int64)
