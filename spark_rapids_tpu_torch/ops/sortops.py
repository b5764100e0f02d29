"""Order-preserving key images (counterpart of the JAX package's
``ops/sortops.py``; only ``u64_key_image`` is ported, Sort waits for a
later slice).

Images are int64 tensors holding the JAX package's uint64 images bit for
bit (see ops/hashing.py for the int64 convention).
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, plain_strings_unsupported,
)

_SIGN = -(1 << 63)  # int64 holding the uint64 pattern 1 << 63


def u64_key_image(col: DeviceColumn,
                  allow_dict: bool = False) -> List[torch.Tensor]:
    """Order-preserving uint64 image(s) of a column (ascending order).

    ``allow_dict``: dictionary codes are assigned in canonical sorted value
    order, so within one batch (or batches sharing one dictionary) the code
    is an exact order-preserving and equality-exact image."""
    if col.dtype.is_string:
        if allow_dict and col.dict_values is not None:
            return [col.dict_codes.to(torch.int64)]
        raise plain_strings_unsupported("u64_key_image")
    d = col.data
    if d.dtype == torch.bool:
        return [d.to(torch.int64)]
    if d.dtype.is_floating_point:
        from spark_rapids_tpu_torch.ops.floatbits import f64_bits
        bits = f64_bits(d)
        # negatives: flip every bit; positives: set the sign bit
        return [torch.where(bits < 0, ~bits, bits | _SIGN)]
    # signed integers (incl. date/timestamp reps): flip the sign bit
    return [d.to(torch.int64) ^ _SIGN]
