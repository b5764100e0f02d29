"""The Generate (explode) physical operators (counterpart of the JAX
package's ``exec/generate.py``; reference: GpuGenerateExec.scala).

The generator is ``explode(split(strcol, delim))`` and its ``posexplode``
twin. With a single-byte delimiter that is no regex metacharacter it runs
on the device (``ops/generate.py``): each batch reads its output row
count and char totals in one counted sync (``generate.totals``), then
expands at capacities sized from them. Other delimiters stay on the CPU
(``sql/overrides.py`` tags them with the JAX package's reasons), where
Spark's regex split runs on the host.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, Schema, bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.column import char_bucket, is_plain
from spark_rapids_tpu_torch.exec.base import (
    ExecContext, Partition, PhysicalPlan,
)
from spark_rapids_tpu_torch.obs.syncledger import sync_scope
from spark_rapids_tpu_torch.ops import generate as gen_ops


def generate_output_schema(child: Schema, with_pos: bool, pos_name: str,
                           out_name: str) -> Schema:
    """The child's columns [+ pos INT32] + the token STRING: the one
    definition the logical node and both operators share."""
    names = list(child.names)
    dts = list(child.dtypes)
    if with_pos:
        names.append(pos_name)
        dts.append(dtypes.INT32)
    names.append(out_name)
    dts.append(dtypes.STRING)
    return Schema(names, dts)


class _GenerateExec(PhysicalPlan):
    prefix = "?"

    def __init__(self, child: PhysicalPlan, col_idx: int, delim: str,
                 out_name: str, with_pos: bool, pos_name: str = "pos"):
        super().__init__([child])
        self.col_idx = col_idx
        self.delim = delim
        self.out_name = out_name
        self.with_pos = with_pos
        self.pos_name = pos_name

    def output_schema(self) -> Schema:
        return generate_output_schema(self.children[0].output_schema(),
                                      self.with_pos, self.pos_name,
                                      self.out_name)

    def describe(self) -> str:
        pos = "pos" if self.with_pos else ""
        return (f"{self.prefix}GenerateExec({pos}explode(split("
                f"c{self.col_idx}, {self.delim!r})) AS {self.out_name})")

    def fingerprint_extra(self) -> str:
        return repr((self.col_idx, self.delim, self.out_name, self.with_pos,
                     self.pos_name))


class CpuGenerateExec(_GenerateExec):
    """Explode on the host, row by row. A NULL string yields no row; an
    empty string yields one empty token (Spark's split)."""
    prefix = "Cpu"

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        child_parts = self.children[0].executed_partitions(ctx)
        splitter = _make_splitter(self.delim)

        def make(part: Partition) -> Partition:
            def run():
                for df in part():
                    rows: List[int] = []
                    toks: List[str] = []
                    poss: List[int] = []
                    for r, v in enumerate(df.iloc[:, self.col_idx]):
                        if pd.isna(v):
                            continue
                        for p, tok in enumerate(splitter(str(v))):
                            rows.append(r)
                            toks.append(tok)
                            poss.append(p)
                    out = df.iloc[rows].reset_index(drop=True)
                    if self.with_pos:
                        out[self.pos_name] = pd.Series(
                            np.asarray(poss, dtype=np.int32))
                    out[self.out_name] = pd.Series(toks, dtype="str")
                    yield out
            return run
        return [make(p) for p in child_parts]


class TpuGenerateExec(_GenerateExec):
    columnar_output = True
    prefix = "Tpu"

    def __init__(self, child: PhysicalPlan, col_idx: int, delim: str,
                 out_name: str, with_pos: bool, pos_name: str = "pos"):
        super().__init__(child, col_idx, delim, out_name, with_pos, pos_name)
        byte = delim.encode("utf-8")
        assert len(byte) == 1, "device split needs a single-byte delimiter"
        self._delim_byte = byte[0]

    def _expand(self, batch: DeviceBatch, growth: float):
        """The batch's output, or None where it has no token."""
        totals = gen_ops.explode_totals(batch, self.col_idx,
                                        self._delim_byte)
        with sync_scope("generate.totals", nbytes=8 * int(totals.numel())):
            sizes = [int(x) for x in totals.tolist()]
        total, char_totals = sizes[0], sizes[1:]
        if total == 0:
            return None
        gen_ops.check_char_totals(batch.schema, char_totals, self.out_name)
        caps, it = [], iter(char_totals[:-1])
        for c in batch.columns:
            chars = next(it) if c.dtype.is_string else None
            caps.append(char_bucket(chars) if chars is not None
                        and is_plain(c) else None)
        out = gen_ops.explode_split(
            batch, self.col_idx, self._delim_byte, self.out_name,
            bucket_capacity(total, growth), caps,
            char_bucket(char_totals[-1]), self.with_pos, self.pos_name)
        out.host_rows = total
        return out

    def partitions(self, ctx: ExecContext) -> List[Partition]:
        from spark_rapids_tpu_torch.exec.tpu import empty_batch
        child_parts = self.children[0].executed_partitions(ctx)
        growth = ctx.conf.capacity_growth
        schema = self.output_schema()

        def make(part: Partition) -> Partition:
            def run() -> Iterator[DeviceBatch]:
                emitted = False
                for batch in part():
                    out = self._expand(batch, growth)
                    if out is not None:
                        emitted = True
                        yield out
                if not emitted:
                    yield empty_batch(schema, ctx.device)
            return run
        return [make(p) for p in child_parts]


_REGEX_META = set("\\^$.|?*+()[]{}")


def _make_splitter(delim: str):
    """Spark's split() takes a regex: a pattern with a metacharacter goes
    through re.split on the host (and is tagged off the device)."""
    if any(ch in _REGEX_META for ch in delim):
        import re
        rx = re.compile(delim)
        return lambda s: rx.split(s)
    return lambda s: s.split(delim)
