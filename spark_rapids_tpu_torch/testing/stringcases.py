"""The string and expression cases shared by the port's CPU tests, its card
tests and ``chip_smoke.py``: one seeded frame and a table of named
expressions, each built from a ``functions`` module (the port's or the
JAX package's, whose APIs match), so that one case runs through both
sessions.

The frame holds a char-slab string column ``s`` and a second one ``s2``
(more distinct values than a dictionary takes), dictionary string columns
``d`` and ``d2`` (with different dictionaries), nullable integers ``x``,
floats ``f`` and timestamps ``ts``. Its strings hold nulls, empty
strings, values with a common prefix of 8 and 9 bytes and values up to 64
bytes, the slab's stride; ``LONG`` (70 bytes) is longer, and shares its
first 64 bytes with a value.

The cases: the six comparisons against literals (either side) and
between columns (slab/slab, dictionary/dictionary, and mixed),
``startswith``, ``endswith``, ``contains``, the four device kinds of
LIKE, ``substring`` (and ``isin`` and ``==`` over it), IN (a NULL in the
list included), OR, NOT, CASE WHEN, ``if`` and ``year``.
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
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "s": _with_nulls(rng, pool[rng.integers(0, len(pool), n)]),
        "s2": _with_nulls(rng, pool[rng.integers(0, len(pool), n)]),
        "d": _with_nulls(rng, dpool[rng.integers(0, len(dpool), n)]),
        "d2": _with_nulls(rng, d2pool[rng.integers(0, len(d2pool), n)]),
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
    return out


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
