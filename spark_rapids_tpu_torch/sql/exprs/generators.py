"""Generator expressions (counterpart of the JAX package's
``sql/exprs/generators.py``): ``split`` and the ``explode``/``posexplode``
marker. ``SplitStr`` makes an array value only ``ExplodeSplit`` consumes
(there are no array columns, as in the JAX package), so
``DataFrame.with_column`` lowers explode(split(...)) to one Generate plan
node (``sql/plan.LogicalGenerate``).
"""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.sql.exprs.core import Expression


class SplitStr(Expression):
    """split(str, delim) with a literal delimiter."""

    def __init__(self, child: Expression, delim: str):
        super().__init__([child])
        self.delim = delim

    def dtype(self, schema: Schema) -> DType:
        raise TypeError("split() produces an array; it can only be consumed "
                        "by explode()/posexplode()")

    def __repr__(self) -> str:
        return f"split({self.children[0]!r}, {self.delim!r})"


class ExplodeSplit(Expression):
    """explode(split(...)) / posexplode(split(...)), lowered to a Generate
    plan node by DataFrame.with_column."""

    def __init__(self, split: SplitStr, with_pos: bool):
        assert isinstance(split, SplitStr), \
            "explode() supports split(column, delimiter) input"
        super().__init__([split])
        self.with_pos = with_pos

    @property
    def split(self) -> SplitStr:
        return self.children[0]

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        fn = "posexplode" if self.with_pos else "explode"
        return f"{fn}({self.children[0]!r})"
