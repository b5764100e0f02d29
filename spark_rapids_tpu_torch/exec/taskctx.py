"""Per-task execution context, thread-local (counterpart of the JAX
package's ``exec/taskctx.py``).

The analogue of Spark's ``TaskContext`` and ``InputFileBlockHolder``: the
nondeterministic expressions (``sql/exprs/nondet.py``) read the partition
index, the rows earlier batches of the partition emitted and the input
file from task-scoped state. A projection or filter that holds one sets
the partition index and its row base right before it evaluates a batch
(``exec/tpu.py``, ``exec/cpu.py``); a file scan publishes the file of the
batch it yields, on the consuming thread, right before the yield
(``sql/scan_pipeline.build_partitions``, ``exec/transitions``), so a
split planned ahead on a planning thread never relabels the rows of the
batch being consumed.
"""

from __future__ import annotations

import threading

_state = threading.local()


def set_partition(index: int) -> None:
    _state.part_id = index
    _state.row_base = 0


def partition_id() -> int:
    return getattr(_state, "part_id", 0)


def row_base() -> int:
    """Rows earlier batches of this partition emitted: the
    monotonically_increasing_id offset and rand's row index base. Each
    operator that evaluates nondeterministic expressions counts its own
    rows and publishes the count with ``set_row_base`` right before it
    evaluates, so stacked operators of one pipeline cannot disturb each
    other."""
    return getattr(_state, "row_base", 0)


def set_row_base(n: int) -> None:
    _state.row_base = n


def set_input_file(path: str) -> None:
    _state.input_file = path


def input_file() -> str:
    """The empty string outside a file scan, as Spark's
    input_file_name()."""
    return getattr(_state, "input_file", "")


def clear_input_file() -> None:
    _state.input_file = ""
