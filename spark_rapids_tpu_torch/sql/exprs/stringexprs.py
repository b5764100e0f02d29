"""String expressions (counterpart of the JAX package's
``sql/exprs/stringexprs.py``: ``Substring``, the literal-pattern predicates
``StartsWith``, ``EndsWith`` and ``Contains``, ``Like``, and the string
functions ``StringLength``, ``Upper``, ``Lower``, ``InitCap``,
``ConcatStrings``, ``Trim``/``LTrim``/``RTrim``, ``LPad``/``RPad``,
``StringLocate``, ``StringReplace``, ``RegexpReplace``, ``ConcatWs``,
``Translate``, ``StringReverse``, ``StringRepeat``, ``Ascii`` and ``Chr``,
with the JAX package's host twins and device tags). The device operations
are ``ops/strings.py``'s, over dictionary codes, char slabs and plain
chars.

``regexp_replace`` keeps the JAX package's split: a pattern without regex
metacharacters becomes a ``StringReplace`` (``make_regexp_replace``), any
other stays on the CPU with its reason.

As in the JAX package, a LIKE pattern that reduces to an exact match, a
prefix, a suffix or one contained needle runs on the device; a pattern
with ``_`` or an interior ``%`` needs general regex and is tagged off the
device with the JAX package's reason. The host evaluates every pattern
by regex.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import DType
from spark_rapids_tpu_torch.ops import strings as string_ops
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
)


class Substring(Expression):
    """substring(s, pos, length): 1-based ``pos``, negative from the end,
    ``length`` < 0 to the end; byte-oriented."""

    def __init__(self, child: Expression, pos: int, length: int = -1):
        super().__init__([child])
        self.pos = pos
        self.length = length

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"substring({self.children[0]!r}, {self.pos}, {self.length})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        assert isinstance(v, DevCol)
        return string_ops.substring(ctx, v, self.pos, self.length)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([string_ops.host_substring(x, self.pos, self.length)
                        if ok else None
                        for x, ok in zip(values, validity)], dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class _LiteralPatternPredicate(Expression):
    """Base of startswith/endswith/contains with a literal pattern."""
    fn_name = "?"

    def __init__(self, child: Expression, pattern: str):
        super().__init__([child])
        self.pattern = pattern

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"{self.fn_name}({self.children[0]!r}, {self.pattern!r})"

    def device_kernel(self, ctx, col):
        raise NotImplementedError

    def host_match(self, s: str) -> bool:
        raise NotImplementedError

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        assert isinstance(v, DevCol)
        data, validity = self.device_kernel(ctx, v)
        return DevCol(dtypes.BOOL, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = np.array([self.host_match(x) if ok else False
                         for x, ok in zip(values, validity)],
                        dtype=np.bool_)
        return rebuild_series(data, validity, dtypes.BOOL, index)


class StartsWith(_LiteralPatternPredicate):
    fn_name = "startswith"

    def device_kernel(self, ctx, col):
        return string_ops.starts_with(ctx, col, self.pattern)

    def host_match(self, s: str) -> bool:
        return s.startswith(self.pattern)


class EndsWith(_LiteralPatternPredicate):
    fn_name = "endswith"

    def device_kernel(self, ctx, col):
        return string_ops.ends_with(ctx, col, self.pattern)

    def host_match(self, s: str) -> bool:
        return s.endswith(self.pattern)


class Contains(_LiteralPatternPredicate):
    fn_name = "contains"

    def device_kernel(self, ctx, col):
        return string_ops.contains(ctx, col, self.pattern)

    def host_match(self, s: str) -> bool:
        return self.pattern in s


class Like(Expression):
    """SQL LIKE with a literal pattern: exact, prefix, suffix and
    contains patterns run on the device, any other is tagged off."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__([child])
        self.pattern = pattern
        self._kind, self._needle = _classify_like(pattern)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.BOOL

    def __repr__(self) -> str:
        return f"({self.children[0]!r} LIKE {self.pattern!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self._kind is None:
            return (f"LIKE pattern {self.pattern!r} needs general regex, "
                    "which is not supported on TPU")
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = self.children[0].eval_device(ctx)
        assert isinstance(v, DevCol)
        fn = {"exact": string_ops.string_equal_literal,
              "prefix": string_ops.starts_with,
              "suffix": string_ops.ends_with,
              "contains": string_ops.contains}[self._kind]
        data, validity = fn(ctx, v, self._needle)
        return DevCol(dtypes.BOOL, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        import re
        regex = re.compile(_like_to_regex(self.pattern), re.DOTALL)
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = np.array([bool(regex.fullmatch(x)) if ok else False
                         for x, ok in zip(values, validity)],
                        dtype=np.bool_)
        return rebuild_series(data, validity, dtypes.BOOL, index)


def _classify_like(p: str):
    """Map a LIKE pattern to (kind, needle) if it avoids general regex."""
    if "_" in p:
        return None, None
    body = p.strip("%")
    if "%" in body:
        return None, None  # interior wildcard
    starts = p.startswith("%")
    ends = p.endswith("%")
    if starts and ends:
        return "contains", body
    if ends:
        return "prefix", body
    if starts:
        return "suffix", body
    return "exact", body


def _like_to_regex(p: str) -> str:
    import re
    out = []
    for ch in p:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


# ---------------------------------------------------------------------------
# The string functions (the JAX package's classes, host twins and tags)
# ---------------------------------------------------------------------------

def _dev_string(ctx: EvalContext, e: Expression) -> DevCol:
    return ctx.broadcast(e.eval_device(ctx))


class StringLength(Expression):
    """length(s): the byte length (the JAX package's, equal to Spark's
    character count for ASCII)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def __repr__(self) -> str:
        return f"length({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = _dev_string(ctx, self.children[0])
        return DevCol(dtypes.INT32, string_ops.lengths_of(v), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = np.array([len(x.encode("utf-8")) if x is not None else 0
                         for x in values], dtype=np.int32)
        return rebuild_series(data, validity, dtypes.INT32, index)


def _ascii_case(s: str, upper: bool) -> str:
    out = []
    for ch in s:
        o = ord(ch)
        if upper and 97 <= o <= 122:
            out.append(chr(o - 32))
        elif not upper and 65 <= o <= 90:
            out.append(chr(o + 32))
        else:
            out.append(ch)
    return "".join(out)


class _CaseMap(Expression):
    upper = True

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        fn = "upper" if self.upper else "lower"
        return f"{fn}({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = _dev_string(ctx, self.children[0])
        return (string_ops.upper_ascii(v) if self.upper
                else string_ops.lower_ascii(v))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        data = np.array([_ascii_case(x, self.upper) if x is not None
                         else None for x in values], dtype=object)
        return rebuild_series(data, validity, dtypes.STRING, index)


class Upper(_CaseMap):
    upper = True


class Lower(_CaseMap):
    upper = False


class InitCap(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"initcap({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.initcap_ascii(_dev_string(ctx, self.children[0]))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))

        def one(s):
            out = []
            prev_space = True
            for ch in s:
                o = ord(ch)
                if prev_space and 97 <= o <= 122:
                    out.append(chr(o - 32))
                elif not prev_space and 65 <= o <= 90:
                    out.append(chr(o + 32))
                else:
                    out.append(ch)
                prev_space = ch == " "
            return "".join(out)
        out = np.array([one(x) if x is not None else None for x in values],
                       dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class ConcatStrings(Expression):
    """concat(s1, s2, ...): NULL if any input is NULL."""

    def __init__(self, children: List[Expression]):
        super().__init__(children)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"concat({', '.join(map(repr, self.children))})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.concat_columns(
            ctx, [_dev_string(ctx, c) for c in self.children])

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        parts = [host_unary_values(c.eval_host(df)) for c in self.children]
        validity = parts[0][1].copy()
        for _, v, _ in parts[1:]:
            validity &= v
        out = np.empty(len(df), dtype=object)
        for i in range(len(df)):
            out[i] = ("".join(p[0][i] for p in parts) if validity[i]
                      else None)
        return rebuild_series(out, validity, dtypes.STRING, parts[0][2])


class _TrimBase(Expression):
    """trim/ltrim/rtrim with an optional literal trim-char set."""
    fn_name = "trim"
    left = True
    right = True

    def __init__(self, child: Expression, chars: Optional[str] = None):
        super().__init__([child])
        # Spark's trim/ltrim/rtrim strip only the space character
        self.chars = chars if chars is not None else " "

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"{self.fn_name}({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.trim(ctx, _dev_string(ctx, self.children[0]),
                               self.chars, self.left, self.right)

    def _host_one(self, s: str) -> str:
        if self.left and self.right:
            return s.strip(self.chars)
        if self.left:
            return s.lstrip(self.chars)
        return s.rstrip(self.chars)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([self._host_one(x) if x is not None else None
                        for x in values], dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class Trim(_TrimBase):
    fn_name, left, right = "trim", True, True


class LTrim(_TrimBase):
    fn_name, left, right = "ltrim", True, False


class RTrim(_TrimBase):
    fn_name, left, right = "rtrim", False, True


class _PadBase(Expression):
    fn_name = "lpad"
    left = True

    def __init__(self, child: Expression, n: int, pad: str = " "):
        super().__init__([child])
        self.n = int(n)
        self.pad = pad or " "

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"{self.fn_name}({self.children[0]!r}, {self.n})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if len(self.pad.encode("utf-8")) != 1:
            return "only single-byte pad characters run on TPU"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.pad(ctx, _dev_string(ctx, self.children[0]),
                              self.n, self.pad, self.left)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.empty(len(values), dtype=object)
        for i, x in enumerate(values):
            if x is None:
                out[i] = None
            elif len(x) >= self.n:
                out[i] = x[:self.n]
            elif self.left:
                out[i] = self.pad * (self.n - len(x)) + x
            else:
                out[i] = x + self.pad * (self.n - len(x))
        return rebuild_series(out, validity, dtypes.STRING, index)


class LPad(_PadBase):
    fn_name, left = "lpad", True


class RPad(_PadBase):
    fn_name, left = "rpad", False


class StringLocate(Expression):
    """locate(substr, str, pos) / instr(str, substr): 1-based, 0 = absent."""

    def __init__(self, child: Expression, substr: str, start_pos: int = 1):
        super().__init__([child])
        self.substr = substr
        self.start_pos = int(start_pos)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def __repr__(self) -> str:
        return (f"locate({self.substr!r}, {self.children[0]!r}, "
                f"{self.start_pos})")

    def eval_device(self, ctx: EvalContext) -> DevValue:
        v = _dev_string(ctx, self.children[0])
        return DevCol(dtypes.INT32, string_ops.locate(
            ctx, v, self.substr, self.start_pos), v.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.zeros(len(values), dtype=np.int32)
        for i, x in enumerate(values):
            if x is not None:
                out[i] = x.find(self.substr, self.start_pos - 1) + 1
        return rebuild_series(out, validity, dtypes.INT32, index)


class StringReplace(Expression):
    """replace(str, search, replacement) with literal arguments."""

    def __init__(self, child: Expression, search: str, replacement: str):
        super().__init__([child])
        self.search = search
        self.replacement = replacement

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return (f"replace({self.children[0]!r}, {self.search!r}, "
                f"{self.replacement!r})")

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.replace_literal(
            ctx, _dev_string(ctx, self.children[0]), self.search,
            self.replacement)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([x.replace(self.search, self.replacement)
                        if x is not None else None for x in values],
                       dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class RegexpReplace(Expression):
    """regexp_replace with a general regex: stays on the CPU, as in the
    JAX package (a literal pattern is a StringReplace, make_regexp_replace)."""

    def __init__(self, child: Expression, pattern: str, replacement: str):
        super().__init__([child])
        self.pattern = pattern
        self.replacement = replacement

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"regexp_replace({self.children[0]!r}, {self.pattern!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        return (f"regular expression {self.pattern!r} is not supported on "
                "TPU (only literal patterns run on device)")

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        import re
        rx = re.compile(self.pattern)
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([rx.sub(self.replacement, x) if x is not None
                        else None for x in values], dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


_REGEX_META = set("\\^$.|?*+()[]{}")


def maybe_literal_regex(pattern: str) -> Optional[str]:
    """A regex pattern without metacharacters is a plain literal."""
    if any(ch in _REGEX_META for ch in pattern):
        return None
    return pattern


def make_regexp_replace(child: Expression, pattern: str,
                        replacement: str) -> Expression:
    lit = maybe_literal_regex(pattern)
    if lit is not None and "$" not in replacement:
        return StringReplace(child, lit, replacement)
    return RegexpReplace(child, pattern, replacement)


class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): joins the non-NULL parts; never NULL."""

    def __init__(self, sep: str, children: List[Expression]):
        super().__init__(children)
        self.sep = str(sep)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        parts = ", ".join(map(repr, self.children))
        return f"concat_ws({self.sep!r}, {parts})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if not self.children:
            return "concat_ws with no arguments"
        for c in self.children:
            if not c.dtype(schema).is_string:
                return "concat_ws over non-string inputs"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.concat_ws_columns(
            ctx, self.sep, [_dev_string(ctx, c) for c in self.children])

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        n = len(df)
        if not self.children:
            return rebuild_series(np.full(n, "", dtype=object),
                                  np.ones(n, np.bool_), dtypes.STRING,
                                  df.index)
        parts = [host_unary_values(c.eval_host(df)) for c in self.children]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = self.sep.join(str(p[0][i]) for p in parts if p[1][i])
        return rebuild_series(out, np.ones(n, np.bool_), dtypes.STRING,
                              parts[0][2])


class Translate(Expression):
    """translate(str, matching, replace) with literal maps."""

    def __init__(self, child: Expression, matching: str, replace: str):
        super().__init__([child])
        self.matching = str(matching)
        self.replace = str(replace)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return (f"translate({self.children[0]!r}, {self.matching!r}, "
                f"{self.replace!r})")

    def device_supported(self, schema: Schema) -> Optional[str]:
        if any(ord(c) > 127 for c in self.matching + self.replace):
            return "translate with non-ASCII map is not supported on TPU"
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.translate_string(
            ctx, _dev_string(ctx, self.children[0]), self.matching,
            self.replace)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        table = {ord(m): (self.replace[i] if i < len(self.replace) else None)
                 for i, m in enumerate(self.matching)}
        out = np.empty(len(values), dtype=object)
        for i, s in enumerate(values):
            out[i] = s.translate(table) if validity[i] else None
        return rebuild_series(out, validity, dtypes.STRING, index)


class StringReverse(Expression):
    """Byte-oriented reverse, exact for ASCII (the JAX package's; the host
    twin reverses bytes too, so both paths agree)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"reverse({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.reverse_string(ctx,
                                         _dev_string(ctx, self.children[0]))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array(
            [s.encode("utf-8")[::-1].decode("utf-8", errors="replace")
             if v else None for s, v in zip(values, validity)],
            dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class StringRepeat(Expression):
    def __init__(self, child: Expression, n: int):
        super().__init__([child])
        self.n = int(n)

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"repeat({self.children[0]!r}, {self.n})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.repeat_string(
            ctx, _dev_string(ctx, self.children[0]), self.n)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([s * max(self.n, 0) if v else None
                        for s, v in zip(values, validity)], dtype=object)
        return rebuild_series(out, validity, dtypes.STRING, index)


class Ascii(Expression):
    """The first byte of the UTF-8 encoding (Spark's code point for
    ASCII; the JAX package's byte semantics on both paths)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.INT32

    def __repr__(self) -> str:
        return f"ascii({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        return string_ops.ascii_first(ctx,
                                      _dev_string(ctx, self.children[0]))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.array([(s.encode("utf-8")[0] if s else 0) if v else 0
                        for s, v in zip(values, validity)], dtype=np.int32)
        return rebuild_series(out, validity, dtypes.INT32, index)


class Chr(Expression):
    """chr(n) over the byte range (n % 256; negative -> '')."""

    def __init__(self, child: Expression):
        super().__init__([child])

    def dtype(self, schema: Schema) -> DType:
        return dtypes.STRING

    def __repr__(self) -> str:
        return f"char({self.children[0]!r})"

    def eval_device(self, ctx: EvalContext) -> DevValue:
        col = ctx.broadcast(self.children[0].eval_device(ctx))
        return string_ops.chr_from_int(ctx, col.data, col.validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        values, validity, index = host_unary_values(
            self.children[0].eval_host(df))
        out = np.empty(len(values), dtype=object)
        for i, (x, v) in enumerate(zip(values, validity)):
            if not v:
                out[i] = None
            elif int(x) < 0:
                out[i] = ""
            else:
                out[i] = chr(int(x) % 256)
        return rebuild_series(out, validity, dtypes.STRING, index)
