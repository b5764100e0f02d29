"""Dictionary-column merge for concatenation (counterpart of the JAX
package's ``columnar/dictionary.py``; only ``union_dictionaries`` is ported).

Batches of one scan normally share one dictionary, and a concat then keeps
their codes as they are. Batches whose dictionaries differ merge by the
union of their value sets in canonical sorted order plus one O(cardinality)
int32 remap table per input.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


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
