"""User-facing column functions, pyspark.sql.functions-style (counterpart
of the JAX package's ``sql/functions.py``, cut to what the 22 TPC-H and
19 TPCxBB queries need: arithmetic, comparisons, AND/OR/NOT, ``isin``,
``isNull``/``isNotNull``, ``cast``, the string predicates and
``substring``, ``when``/``otherwise``, ``coalesce``, the date parts,
``to_date``, ``round``, ``bround``, ``floor``, ``ceil``, ``pmod``,
``hash``, ``hex``, the aggregates, ``count_distinct``, the variances and
``corr`` among them, and the window functions with ``Column.over``, which
the Mortgage queries add)."""

from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.sql.exprs import aggregates as agg
from spark_rapids_tpu_torch.sql.exprs import arithmetic as ar
from spark_rapids_tpu_torch.sql.exprs import mathexprs as m
from spark_rapids_tpu_torch.sql.exprs import conditional as cond
from spark_rapids_tpu_torch.sql.exprs import datetimeexprs as dt
from spark_rapids_tpu_torch.sql.exprs import predicates as pred
from spark_rapids_tpu_torch.sql.exprs import stringexprs as st
from spark_rapids_tpu_torch.sql.exprs.cast import Cast
from spark_rapids_tpu_torch.sql.exprs.core import Alias, Col, Expression, Literal
from spark_rapids_tpu_torch.columnar import dtype as dtypes

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
    def __mod__(self, other): return Column(ar.Remainder(self.expr, _expr(other)))

    # comparisons
    def __eq__(self, other): return Column(pred.Eq(self.expr, _expr(other)))  # type: ignore[override]
    def __ne__(self, other): return Column(pred.Neq(self.expr, _expr(other)))  # type: ignore[override]
    def __lt__(self, other): return Column(pred.Lt(self.expr, _expr(other)))
    def __le__(self, other): return Column(pred.Le(self.expr, _expr(other)))
    def __gt__(self, other): return Column(pred.Gt(self.expr, _expr(other)))
    def __ge__(self, other): return Column(pred.Ge(self.expr, _expr(other)))

    # boolean
    def __and__(self, other): return Column(pred.And(self.expr, _expr(other)))
    def __or__(self, other): return Column(pred.Or(self.expr, _expr(other)))
    def __invert__(self): return Column(pred.Not(self.expr))

    def alias(self, name: str): return Column(Alias(self.expr, name))
    def cast(self, to): return Column(Cast(self.expr, _dtype(to)))

    # null tests
    def isNull(self): return Column(pred.IsNull(self.expr))
    def isNotNull(self): return Column(pred.IsNotNull(self.expr))

    # membership and strings
    def isin(self, *values):
        vals = (values[0] if len(values) == 1
                and isinstance(values[0], (list, tuple)) else values)
        return Column(pred.In(self.expr, list(vals)))
    def startswith(self, p: str): return Column(st.StartsWith(self.expr, p))
    def endswith(self, p: str): return Column(st.EndsWith(self.expr, p))
    def contains(self, p: str): return Column(st.Contains(self.expr, p))
    def like(self, p: str): return Column(st.Like(self.expr, p))
    def substr(self, pos: int, length: int = -1):
        return Column(st.Substring(self.expr, pos, length))

    # ordering
    def asc(self): return SortOrder(self.expr, ascending=True)
    def desc(self): return SortOrder(self.expr, ascending=False)

    def over(self, spec) -> "Column":
        """Turn an aggregate or ranking function into a window expression
        (reference: GpuWindowExpression)."""
        from spark_rapids_tpu_torch.sql.window import WindowExpression
        return Column(WindowExpression(self.expr, spec))

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


def _dtype(t):
    if isinstance(t, str):
        aliases = {"long": "int64", "bigint": "int64", "int": "int32",
                   "integer": "int32", "short": "int16", "byte": "int8",
                   "double": "float64", "float": "float32",
                   "boolean": "bool", "date": "date32",
                   "timestamp": "timestamp_us"}
        return dtypes.by_name(aliases.get(t, t))
    return t


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


def count_distinct(c) -> Column: return Column(agg.CountDistinct(_c(c)))
def var_samp(c) -> Column: return Column(agg.VarSamp(_c(c)))
def var_pop(c) -> Column: return Column(agg.VarPop(_c(c)))
def stddev_samp(c) -> Column: return Column(agg.StddevSamp(_c(c)))
def stddev_pop(c) -> Column: return Column(agg.StddevPop(_c(c)))
def corr(a, b) -> Column: return Column(agg.Corr(_c(a), _c(b)))



def first(c, ignorenulls: bool = False) -> Column:
    return Column(agg.First(_c(c), ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(agg.Last(_c(c), ignorenulls))


def when(condition: Column, value) -> "WhenBuilder":
    return WhenBuilder([(condition.expr, _expr(value))])


class WhenBuilder(Column):
    """CASE WHEN under construction: ``.when(...)`` adds a branch,
    ``.otherwise(v)`` closes it with an ELSE (without: NULL)."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(cond.CaseWhen(branches))

    def when(self, condition: Column, value) -> "WhenBuilder":
        return WhenBuilder(self._branches + [(condition.expr, _expr(value))])

    def otherwise(self, value) -> Column:
        return Column(cond.CaseWhen(self._branches, _expr(value)))


def substring(c, pos: int, length_: int) -> Column:
    return Column(st.Substring(_c(c), pos, length_))


def year(c) -> Column: return Column(dt.Year(_c(c)))
def month(c) -> Column: return Column(dt.Month(_c(c)))
def dayofmonth(c) -> Column: return Column(dt.DayOfMonth(_c(c)))
def dayofweek(c) -> Column: return Column(dt.DayOfWeek(_c(c)))
def hour(c) -> Column: return Column(dt.Hour(_c(c)))
def minute(c) -> Column: return Column(dt.Minute(_c(c)))
def second(c) -> Column: return Column(dt.Second(_c(c)))
def quarter(c) -> Column: return Column(dt.Quarter(_c(c)))
def dayofyear(c) -> Column: return Column(dt.DayOfYear(_c(c)))
def weekofyear(c) -> Column: return Column(dt.WeekOfYear(_c(c)))


def to_date(c) -> Column:
    """to_date(timestamp): the day (a cast to date; string parsing is
    ROADMAP A.5's)."""
    return Column(Cast(_c(c), dtypes.DATE32))


def coalesce(*cs) -> Column: return Column(cond.Coalesce([_c(c) for c in cs]))
def pmod(a, b) -> Column: return Column(ar.Pmod(_c(a), _expr(b)))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return Column(m.Round(_c(c), scale))


def bround(c, scale: int = 0) -> Column:
    return Column(m.BRound(_c(c), scale))


def floor(c) -> Column: return Column(m.Floor(_c(c)))
def ceil(c) -> Column: return Column(m.Ceil(_c(c)))


def hash(*cs) -> Column:  # noqa: A001
    from spark_rapids_tpu_torch.sql.exprs.miscexprs import Hash
    return Column(Hash([_c(c) for c in cs]))


def hex(c) -> Column:  # noqa: A001
    from spark_rapids_tpu_torch.sql.exprs.miscexprs import Hex
    return Column(Hex(_c(c)))


# --- window functions ---------------------------------------------------------

def row_number() -> Column:
    from spark_rapids_tpu_torch.sql.window import RowNumber
    return Column(RowNumber())


def rank() -> Column:
    from spark_rapids_tpu_torch.sql.window import Rank
    return Column(Rank())


def dense_rank() -> Column:
    from spark_rapids_tpu_torch.sql.window import DenseRank
    return Column(DenseRank())


def lead(c, offset: int = 1, default=None) -> Column:
    from spark_rapids_tpu_torch.sql.window import LeadLag
    return Column(LeadLag(_c(c), offset, default, is_lead=True))


def lag(c, offset: int = 1, default=None) -> Column:
    from spark_rapids_tpu_torch.sql.window import LeadLag
    return Column(LeadLag(_c(c), offset, default, is_lead=False))

