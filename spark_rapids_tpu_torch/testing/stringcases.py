"""The string and expression cases shared by the port's CPU tests, its card
tests and ``chip_smoke.py``: one seeded frame and a table of named
expressions, each built from a ``functions`` module (the port's or the
JAX package's, whose APIs match), so that one case runs through both
sessions.

The frame holds a char-slab string column ``s`` and a second one ``s2``
(more distinct values than a dictionary takes), dictionary string columns
``d`` and ``d2`` (with different dictionaries), a plain offsets+chars
column ``p`` (the same kind of values, a fifth of them past the 64-byte
slab limit, some with surrounding spaces), nullable integers ``x``,
floats ``f`` and timestamps ``ts``. Its strings hold nulls, empty
strings, values with a common prefix of 8 and 9 bytes and values up to 64
bytes, the slab's stride; ``LONG`` (70 bytes) is longer, and shares its
first 64 bytes with a value.

The cases: the six comparisons against literals (either side) and
between columns (slab/slab, dictionary/dictionary, and mixed),
``startswith``, ``endswith``, ``contains``, the four device kinds of
LIKE, ``substring`` (and ``isin`` and ``==`` over it), IN (a NULL in the
list included), OR, NOT, CASE WHEN, ``if`` and ``year``; over ``p`` the
comparisons, predicates and the string functions of the string slice
(``FUNCTION_CASES``: length, case maps, trim, pad, locate, replace,
concat, ``concat_ws``, translate, reverse, repeat, ascii, left/right,
greatest/least, the renderings of integers, booleans and dates, chr).
``parse_cases`` holds the string parses, which run on the device only
under ``PARSE_CONF``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import pandas as pd

LONG = "q" * 70
OPS = {"eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
       "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
       "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b}
LITERALS = {"prefix8": "abcdefgh", "prefix9": "abcdefghi", "empty": "",
            "long": LONG, "mid": "m", "name": "name7"}
SPECIAL = ["", "abcdefgh", "abcdefghi", "abcdefgh1", "abcdefgz",
           "abcdefghij", "abcdefgg", "m", "name7", "x" * 40, "ab", "hi",
           "q" * 64]
# the string parses' confs (off by default, as in the JAX package)
PARSE_CONF = {"spark.rapids.sql.castStringToInteger.enabled": True,
              "spark.rapids.sql.castStringToDate.enabled": True}


def _words(rng, n: int, lo: int, hi: int) -> list:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, k))
            for k in rng.integers(lo, hi + 1, n)]


def _with_nulls(rng, values: np.ndarray, frac: float = 0.1) -> np.ndarray:
    out = np.array(values, dtype=object)
    out[rng.random(len(out)) < frac] = None
    return out


def string_frame(n: int, seed: int = 20261017) -> pd.DataFrame:
    """The cases' frame of ``n`` rows."""
    rng = np.random.default_rng(seed)
    pool = np.array(list(dict.fromkeys(SPECIAL + _words(rng, 500, 1, 24))),
                    dtype=object)
    dpool = np.array(SPECIAL[:9] + ["zeta", "alpha", "mango", "hi"],
                     dtype=object)
    d2pool = np.array(["abcdefgh", "m", "zeta", "beta", "", "omega",
                       "name7"], dtype=object)
    ts = pd.Series(np.datetime64("1992-01-01", "s")
                   + rng.integers(0, 7 * 365, n) * np.timedelta64(86400, "s"))
    ts[rng.random(n) < 0.1] = pd.NaT
    x = pd.array(rng.integers(0, 10, n), dtype="Int64")
    x[rng.random(n) < 0.1] = pd.NA
    # the plain column: past 64 bytes in a fifth of the rows, padded with
    # spaces in another fifth, numbers and dates among them
    ppool = np.array([v + " " + LONG + v if i % 5 == 1 else
                      f"  {v} " if i % 5 == 2 else
                      str(i - 250) if i % 5 == 3 and i % 2 else
                      f"20{i % 30:02d}-0{1 + i % 9}-{10 + i % 19}"
                      if i % 5 == 3 else v
                      for i, v in enumerate(pool)], dtype=object)
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "s": _with_nulls(rng, pool[rng.integers(0, len(pool), n)]),
        "s2": _with_nulls(rng, pool[rng.integers(0, len(pool), n)]),
        "d": _with_nulls(rng, dpool[rng.integers(0, len(dpool), n)]),
        "d2": _with_nulls(rng, d2pool[rng.integers(0, len(d2pool), n)]),
        "p": _with_nulls(rng, ppool[rng.integers(0, len(ppool), n)]),
        "x": x,
        "f": rng.uniform(-5, 5, n),
        "ts": ts,
    })


def cases(conditional) -> Dict[str, Callable]:
    """name -> f(functions module) -> Column. ``conditional`` is the
    conditional-expression module for the ``if`` case, called with the
    functions module (``if`` has no function of its own)."""
    out: Dict[str, Callable] = {}
    for col in ("s", "d"):
        for on, op in OPS.items():
            for ln, lit in LITERALS.items():
                out[f"{col}_{on}_{ln}"] = (
                    lambda M, c=col, op=op, lit=lit: op(M.col(c), lit))
            out[f"lit_{on}_{col}"] = (
                lambda M, c=col, op=op: op(M.lit("abcdefghi"), M.col(c)))
        for fn in ("startswith", "endswith", "contains"):
            for pat in ("ab", "abcdefghi", "", LONG, "e", "hi"):
                out[f"{col}_{fn}_{pat[:12]!r}"] = (
                    lambda M, c=col, fn=fn, pat=pat:
                    getattr(M.col(c), fn)(pat))
        for pat in ("abcdefgh", "ab%", "%hi", "%cd%", "%", "%" + LONG):
            out[f"{col}_like_{pat[:12]!r}"] = (
                lambda M, c=col, pat=pat: M.col(c).like(pat))
        for pos, ln in ((1, 2), (0, 3), (-3, 2), (3, -1), (2, 100),
                        (-100, 5), (5, 0), (50, 3)):
            out[f"{col}_substr_{pos}_{ln}"] = (
                lambda M, c=col, pos=pos, ln=ln: M.col(c).substr(pos, ln))
        out[f"{col}_substring_isin"] = (
            lambda M, c=col: M.substring(M.col(c), 1, 2).isin(
                ["ab", "hi", "na", ""]))
        out[f"{col}_substring_eq"] = (
            lambda M, c=col: M.substring(M.col(c), 2, 3) == "bcd")
        out[f"{col}_in"] = (
            lambda M, c=col: M.col(c).isin("abcdefgh", "m", "", "zz"))
        out[f"{col}_in_null"] = (
            lambda M, c=col: M.col(c).isin(["abcdefghi", None, "hi"]))
        out[f"{col}_not_startswith"] = (
            lambda M, c=col: ~M.col(c).startswith("ab"))
    for on, op in OPS.items():
        for a, b in (("s", "s2"), ("d", "d2"), ("s", "d"), ("d", "s"),
                     ("s", "s"), ("d", "d")):
            out[f"{a}_{on}_{b}"] = (
                lambda M, a=a, b=b, op=op: op(M.col(a), M.col(b)))
    out.update({
        "x_in": lambda M: M.col("x").isin(1, 3, 5),
        "x_in_null": lambda M: M.col("x").isin([2, None]),
        "or": lambda M: (M.col("x") > 5) | M.col("d").isin("m", "hi"),
        "or_nulls": lambda M: (M.col("x") > 5) | (M.col("s") < "m"),
        "not": lambda M: ~(M.col("x") > 3),
        "not_and_or": lambda M: ~((M.col("s") == M.col("s2"))
                                  | (M.col("d") != "abcdefgh")),
        "case_int": lambda M: M.when(M.col("d").isin("m", "hi"), 1)
        .otherwise(0),
        "case_float": lambda M: M.when(M.col("s").like("ab%"),
                                       M.col("f") * 2.0).otherwise(0.0),
        "case_multi": lambda M: M.when(M.col("x") > 6, M.col("f"))
        .when(M.col("x") > 2, 1.5),
        "case_bool": lambda M: M.when(M.col("x") > 4, M.col("f") > 0)
        .otherwise(M.col("s").contains("a")),
        "if": lambda M: M.Column(conditional(M).If(
            (M.col("x") > 4).expr, M.col("f").expr, M.lit(0.5).expr)),
        "year": lambda M: M.year(M.col("ts")),
        "year_case": lambda M: M.when(M.year(M.col("ts")) > 1995,
                                      M.col("x")).otherwise(-1),
    })
    out.update(FUNCTION_CASES)
    return out


def _p(M):
    return M.col("p")


# the string functions over the plain column, and the renderings
FUNCTION_CASES: Dict[str, Callable] = {
    "p_eq_lit": lambda M: _p(M) == "abcdefghi",
    "p_lt_s": lambda M: _p(M) < M.col("s"),
    "p_ge_d": lambda M: _p(M) >= M.col("d"),
    "p_eq_p": lambda M: _p(M) == _p(M),
    "p_startswith": lambda M: _p(M).startswith("ab"),
    "p_endswith": lambda M: _p(M).endswith(LONG[:5] + "ab"),
    "p_contains": lambda M: _p(M).contains("qqqq"),
    "p_like": lambda M: _p(M).like("%hi%"),
    "p_substr": lambda M: _p(M).substr(60, 12),
    "p_in": lambda M: _p(M).isin("abcdefgh", "  m ", ""),
    "p_length": lambda M: M.length(_p(M)),
    "p_upper": lambda M: M.upper(_p(M)),
    "p_lower": lambda M: M.lower(M.upper(_p(M))),
    "p_initcap": lambda M: M.initcap(_p(M)),
    "p_trim": lambda M: M.trim(_p(M)),
    "p_ltrim": lambda M: M.ltrim(_p(M)),
    "p_rtrim": lambda M: M.rtrim(_p(M)),
    "p_lpad": lambda M: M.lpad(_p(M), 20, "*"),
    "p_rpad": lambda M: M.rpad(_p(M), 70, "-"),
    "p_locate": lambda M: M.locate("q", _p(M), 3),
    "p_instr": lambda M: M.instr(_p(M), "ab"),
    "p_replace": lambda M: M.replace(_p(M), "qq", "Z"),
    "p_replace_grow": lambda M: M.replace(_p(M), "a", "<a>"),
    "p_regexp_literal": lambda M: M.regexp_replace(_p(M), "hi", "HI"),
    "p_concat": lambda M: M.concat(_p(M), M.lit("|"), M.col("s")),
    "p_concat_ws": lambda M: M.concat_ws(",", _p(M), M.col("d"),
                                         M.col("s")),
    "p_translate": lambda M: M.translate(_p(M), "abq", "ba"),
    "p_reverse": lambda M: M.reverse(_p(M)),
    "p_repeat": lambda M: M.repeat(_p(M), 2),
    "p_ascii": lambda M: M.ascii(_p(M)),
    "p_left": lambda M: M.left(_p(M), 5),
    "p_right": lambda M: M.right(_p(M), 66),
    "p_greatest": lambda M: M.greatest(_p(M), M.col("s"), M.col("d")),
    "p_least": lambda M: M.least(_p(M), M.col("s2")),
    "x_to_string": lambda M: M.col("x").cast("string"),
    "x_to_string_neg": lambda M: (M.col("x") * -123456789012).cast(
        "string"),
    "bool_to_string": lambda M: (M.col("x") > 4).cast("string"),
    "date_to_string": lambda M: M.col("ts").cast("date").cast("string"),
    "x_chr": lambda M: M.chr_(M.col("x") * 37 - 100),
}


def parse_cases() -> Dict[str, Callable]:
    """The string parses (on the device under ``PARSE_CONF`` only)."""
    return {
        "p_to_int": lambda M: _p(M).cast("int"),
        "p_trim_to_long": lambda M: M.trim(_p(M)).cast("long"),
        "p_to_date": lambda M: M.to_date(_p(M)),
        "p_cast_date": lambda M: _p(M).cast("date"),
    }


def port_conditional(M):
    from spark_rapids_tpu_torch.sql.exprs import conditional
    return conditional


def projection(M, session, df: pd.DataFrame, table: Dict[str, Callable],
               names=None):
    """``df`` as a DataFrame of ``session`` with ``id`` and one column per
    case of ``names`` (default: all of ``table``)."""
    names = list(table) if names is None else names
    return session.create_dataframe(df).select(
        M.col("id"), *[table[n](M).alias(n) for n in names])
