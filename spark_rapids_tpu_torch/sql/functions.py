"""User-facing column functions, pyspark.sql.functions-style (counterpart
of the JAX package's ``sql/functions.py``, cut to what TPC-H Q1, Q6 and the
Q18 group-by need, through the query runners and through the session)."""

from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.sql.exprs import aggregates as agg
from spark_rapids_tpu_torch.sql.exprs import arithmetic as ar
from spark_rapids_tpu_torch.sql.exprs import predicates as pred
from spark_rapids_tpu_torch.sql.exprs.core import Alias, Col, Expression, Literal

ColumnOrName = Union["Column", str]


class Column:
    """Thin user-facing wrapper over an Expression with operator overloads."""

    def __init__(self, expr: Expression):
        self.expr = expr

    # arithmetic
    def __add__(self, other): return Column(ar.Add(self.expr, _expr(other)))
    def __radd__(self, other): return Column(ar.Add(_expr(other), self.expr))
    def __sub__(self, other): return Column(ar.Subtract(self.expr, _expr(other)))
    def __rsub__(self, other): return Column(ar.Subtract(_expr(other), self.expr))
    def __mul__(self, other): return Column(ar.Multiply(self.expr, _expr(other)))
    def __rmul__(self, other): return Column(ar.Multiply(_expr(other), self.expr))
    def __truediv__(self, other): return Column(ar.Divide(self.expr, _expr(other)))
    def __rtruediv__(self, other): return Column(ar.Divide(_expr(other), self.expr))

    # comparisons
    def __eq__(self, other): return Column(pred.Eq(self.expr, _expr(other)))  # type: ignore[override]
    def __ne__(self, other): return Column(pred.Neq(self.expr, _expr(other)))  # type: ignore[override]
    def __lt__(self, other): return Column(pred.Lt(self.expr, _expr(other)))
    def __le__(self, other): return Column(pred.Le(self.expr, _expr(other)))
    def __gt__(self, other): return Column(pred.Gt(self.expr, _expr(other)))
    def __ge__(self, other): return Column(pred.Ge(self.expr, _expr(other)))

    # boolean
    def __and__(self, other): return Column(pred.And(self.expr, _expr(other)))

    def alias(self, name: str): return Column(Alias(self.expr, name))

    # ordering
    def asc(self): return SortOrder(self.expr, ascending=True)
    def desc(self): return SortOrder(self.expr, ascending=False)

    def __hash__(self):
        return id(self.expr)

    def __repr__(self):
        return f"Column<{self.expr!r}>"


class SortOrder:
    """Sort key with direction and null ordering (Spark's defaults: asc ->
    nulls first, desc -> nulls last)."""

    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: bool = None):
        self.expr = expr
        self.ascending = ascending
        self.nulls_first = ascending if nulls_first is None else nulls_first

    def __repr__(self):
        d = "ASC" if self.ascending else "DESC"
        n = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.expr!r} {d} {n}"


def _expr(x: Any) -> Expression:
    if isinstance(x, Column):
        return x.expr
    if isinstance(x, Expression):
        return x
    return Literal(x)


def _c(x: ColumnOrName) -> Expression:
    if isinstance(x, str):
        return Col(x)
    return _expr(x)


def col(name: str) -> Column:
    return Column(Col(name))


def lit(value: Any) -> Column:
    return Column(Literal(value))


def sum(c) -> Column: return Column(agg.Sum(_c(c)))  # noqa: A001
def avg(c) -> Column: return Column(agg.Average(_c(c)))
def min(c) -> Column: return Column(agg.Min(_c(c)))  # noqa: A001
def max(c) -> Column: return Column(agg.Max(_c(c)))  # noqa: A001


def count(c) -> Column:
    if isinstance(c, str) and c == "*":
        return Column(agg.Count(Literal(1)))
    return Column(agg.Count(_c(c)))


def first(c, ignorenulls: bool = False) -> Column:
    return Column(agg.First(_c(c), ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(agg.Last(_c(c), ignorenulls))
