"""User-facing column functions, pyspark.sql.functions-style (counterpart
of the JAX package's ``sql/functions.py``, every public name of which it
holds under the same signature): arithmetic and ``Column``'s operators,
comparisons with the null-safe ``eqNullSafe``, bitwise operators and
shifts, the math functions, null and NaN handling (``isnull``, ``isnan``,
``nvl``, ``nvl2``, ``nanvl``, ``coalesce``), ``cast``, the string
functions, the date parts, date arithmetic and unix time, ``hash`` and
``hex``, the nondeterministic ``rand`` and ids, ``split`` with
``explode``/``posexplode``, the aggregates and the window functions with
``Column.over``.
"""

from __future__ import annotations

from typing import Any, Union

from spark_rapids_tpu_torch.sql.exprs import aggregates as agg
from spark_rapids_tpu_torch.sql.exprs import arithmetic as ar
from spark_rapids_tpu_torch.sql.exprs import bitwise as bw
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
    def __neg__(self): return Column(ar.UnaryMinus(self.expr))

    # comparisons
    def __eq__(self, other): return Column(pred.Eq(self.expr, _expr(other)))  # type: ignore[override]
    def __ne__(self, other): return Column(pred.Neq(self.expr, _expr(other)))  # type: ignore[override]
    def __lt__(self, other): return Column(pred.Lt(self.expr, _expr(other)))
    def __le__(self, other): return Column(pred.Le(self.expr, _expr(other)))
    def __gt__(self, other): return Column(pred.Gt(self.expr, _expr(other)))
    def __ge__(self, other): return Column(pred.Ge(self.expr, _expr(other)))
    def eqNullSafe(self, other):
        return Column(pred.EqNullSafe(self.expr, _expr(other)))

    # boolean
    def __and__(self, other): return Column(pred.And(self.expr, _expr(other)))
    def __or__(self, other): return Column(pred.Or(self.expr, _expr(other)))
    def __invert__(self): return Column(pred.Not(self.expr))

    def alias(self, name: str): return Column(Alias(self.expr, name))
    def cast(self, to): return Column(Cast(self.expr, _dtype(to)))
    def bitwiseAND(self, other):
        return Column(bw.BitwiseAnd(self.expr, _expr(other)))
    def bitwiseOR(self, other):
        return Column(bw.BitwiseOr(self.expr, _expr(other)))
    def bitwiseXOR(self, other):
        return Column(bw.BitwiseXor(self.expr, _expr(other)))

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


def expr_col(e: Expression) -> Column:
    return Column(e)


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


mean = avg
countDistinct = count_distinct
variance = var_samp
stddev = stddev_samp



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


# --- string functions (A.5; the JAX package's spellings) ---------------------

def length(c) -> Column: return Column(st.StringLength(_c(c)))
def upper(c) -> Column: return Column(st.Upper(_c(c)))
def lower(c) -> Column: return Column(st.Lower(_c(c)))
def initcap(c) -> Column: return Column(st.InitCap(_c(c)))
def concat(*cs) -> Column:
    return Column(st.ConcatStrings([_c(c) for c in cs]))
def trim(c) -> Column: return Column(st.Trim(_c(c)))
def ltrim(c) -> Column: return Column(st.LTrim(_c(c)))
def rtrim(c) -> Column: return Column(st.RTrim(_c(c)))
def lpad(c, n: int, pad: str = " ") -> Column:
    return Column(st.LPad(_c(c), n, pad))
def rpad(c, n: int, pad: str = " ") -> Column:
    return Column(st.RPad(_c(c), n, pad))
def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(st.StringLocate(_c(c), substr, pos))
def instr(c, substr: str) -> Column:
    return Column(st.StringLocate(_c(c), substr, 1))
def replace(c, search: str, replacement: str) -> Column:
    return Column(st.StringReplace(_c(c), search, replacement))
def regexp_replace(c, pattern: str, replacement: str) -> Column:
    return Column(st.make_regexp_replace(_c(c), pattern, replacement))
def concat_ws(sep: str, *cs) -> Column:
    return Column(st.ConcatWs(sep, [_c(c) for c in cs]))
def translate(c, matching: str, replace: str) -> Column:
    return Column(st.Translate(_c(c), matching, replace))
def reverse(c) -> Column: return Column(st.StringReverse(_c(c)))
def repeat(c, n: int) -> Column: return Column(st.StringRepeat(_c(c), n))
def ascii(c) -> Column: return Column(st.Ascii(_c(c)))  # noqa: A001
def chr_(c) -> Column: return Column(st.Chr(_c(c)))
char = chr_
def left(c, n: int) -> Column:
    return Column(st.Substring(_c(c), 1, int(n)))
def right(c, n: int) -> Column:
    return Column(st.Substring(_c(c), -int(n), int(n)))


def greatest(*cs) -> Column:
    from spark_rapids_tpu_torch.sql.exprs.nullexprs import Greatest
    return Column(Greatest([_c(c) for c in cs]))


def least(*cs) -> Column:
    from spark_rapids_tpu_torch.sql.exprs.nullexprs import Least
    return Column(Least([_c(c) for c in cs]))


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


def unix_timestamp(c, fmt: str = None) -> Column:
    """Seconds since the epoch of a timestamp, or (with ``fmt``) of a
    string in that format (the device parses 'yyyy-MM-dd' and 'yyyy-MM-dd
    HH:mm:ss')."""
    if fmt is None:
        return Column(dt.UnixTimestampFromTs(_c(c)))
    return Column(dt.UnixTimestampFromString(_c(c), fmt))


def from_unixtime(c) -> Column: return Column(dt.FromUnixTime(_c(c)))
def date_add(c, days) -> Column: return Column(dt.DateAdd(_c(c), _expr(days)))
def date_sub(c, days) -> Column: return Column(dt.DateSub(_c(c), _expr(days)))
def datediff(end, start) -> Column:
    return Column(dt.DateDiff(_c(end), _c(start)))
def last_day(c) -> Column: return Column(dt.LastDay(_c(c)))
def add_months(c, n) -> Column: return Column(dt.AddMonths(_c(c), _expr(n)))
def months_between(end, start) -> Column:
    return Column(dt.MonthsBetween(_c(end), _c(start)))
def trunc(c, fmt: str) -> Column: return Column(dt.TruncDate(_c(c), fmt))
def next_day(c, day: str) -> Column: return Column(dt.NextDay(_c(c), day))


def to_date(c) -> Column:
    """to_date(x): the day of a timestamp, or a string's date (parsed on
    the device under spark.rapids.sql.castStringToDate.enabled)."""
    from spark_rapids_tpu_torch.sql.exprs.cast import ToDate
    return Column(ToDate(_c(c)))


def coalesce(*cs) -> Column: return Column(cond.Coalesce([_c(c) for c in cs]))
def pmod(a, b) -> Column: return Column(ar.Pmod(_c(a), _expr(b)))


# --- null and NaN handling ----------------------------------------------------

def isnan(c) -> Column: return Column(pred.IsNan(_c(c)))
def isnull(c) -> Column: return Column(pred.IsNull(_c(c)))
def nanvl(a, b) -> Column: return Column(cond.NaNvl(_c(a), _c(b)))
def nvl(a, b) -> Column: return coalesce(a, b)


ifnull = nvl


def nvl2(a, b, c) -> Column:
    return when(Column(_c(a)).isNotNull(), Column(_c(b))) \
        .otherwise(Column(_c(c)))


# --- math ---------------------------------------------------------------------

def abs(c) -> Column: return Column(ar.Abs(_c(c)))  # noqa: A001
def sqrt(c) -> Column: return Column(m.Sqrt(_c(c)))
def exp(c) -> Column: return Column(m.Exp(_c(c)))
def expm1(c) -> Column: return Column(m.Expm1(_c(c)))
def log(c) -> Column: return Column(m.Log(_c(c)))
def log2(c) -> Column: return Column(m.Log2(_c(c)))
def log10(c) -> Column: return Column(m.Log10(_c(c)))
def log1p(c) -> Column: return Column(m.Log1p(_c(c)))
def sin(c) -> Column: return Column(m.Sin(_c(c)))
def cos(c) -> Column: return Column(m.Cos(_c(c)))
def tan(c) -> Column: return Column(m.Tan(_c(c)))
def asin(c) -> Column: return Column(m.Asin(_c(c)))
def acos(c) -> Column: return Column(m.Acos(_c(c)))
def atan(c) -> Column: return Column(m.Atan(_c(c)))
def sinh(c) -> Column: return Column(m.Sinh(_c(c)))
def cosh(c) -> Column: return Column(m.Cosh(_c(c)))
def tanh(c) -> Column: return Column(m.Tanh(_c(c)))
def cbrt(c) -> Column: return Column(m.Cbrt(_c(c)))
def rint(c) -> Column: return Column(m.Rint(_c(c)))
def signum(c) -> Column: return Column(m.Signum(_c(c)))
def degrees(c) -> Column: return Column(m.ToDegrees(_c(c)))
def radians(c) -> Column: return Column(m.ToRadians(_c(c)))
def pow(b, e) -> Column: return Column(m.Pow(_c(b), _expr(e)))  # noqa: A001
def atan2(y, x) -> Column: return Column(m.Atan2(_c(y), _expr(x)))
def hypot(a, b) -> Column: return Column(m.Hypot(_c(a), _c(b)))


# --- bitwise ------------------------------------------------------------------

def shiftleft(c, n) -> Column: return Column(bw.ShiftLeft(_c(c), _expr(n)))
def shiftright(c, n) -> Column: return Column(bw.ShiftRight(_c(c), _expr(n)))
def shiftrightunsigned(c, n) -> Column:
    return Column(bw.ShiftRightUnsigned(_c(c), _expr(n)))
def bitwise_not(c) -> Column: return Column(bw.BitwiseNot(_c(c)))


bitwiseNOT = bitwise_not


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


# --- nondeterministic ---------------------------------------------------------

def rand(seed: int = 0) -> Column:
    from spark_rapids_tpu_torch.sql.exprs import nondet
    return Column(nondet.Rand(seed))


def spark_partition_id() -> Column:
    from spark_rapids_tpu_torch.sql.exprs import nondet
    return Column(nondet.SparkPartitionID())


def monotonically_increasing_id() -> Column:
    from spark_rapids_tpu_torch.sql.exprs import nondet
    return Column(nondet.MonotonicallyIncreasingID())


def input_file_name() -> Column:
    from spark_rapids_tpu_torch.sql.exprs import nondet
    return Column(nondet.InputFileName())


# --- generators ---------------------------------------------------------------

def split(c, delim: str) -> Column:
    """split(str, pattern): as in Spark, a pattern with a regex
    metacharacter is a regex (split on the host, tagged off the device); a
    plain single-byte literal splits on the device through explode()."""
    from spark_rapids_tpu_torch.sql.exprs.generators import SplitStr
    if not delim:
        raise ValueError("split() requires a non-empty delimiter")
    return Column(SplitStr(_c(c), delim))


def explode(c: Column) -> Column:
    from spark_rapids_tpu_torch.sql.exprs.generators import ExplodeSplit
    return Column(ExplodeSplit(_expr(c), with_pos=False))


def posexplode(c: Column) -> Column:
    from spark_rapids_tpu_torch.sql.exprs.generators import ExplodeSplit
    return Column(ExplodeSplit(_expr(c), with_pos=True))


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

