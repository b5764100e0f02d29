"""The string functions, the string casts and string greatest/least of the
port's session on the CPU, against the JAX package's session.

One frame holds the same kinds of values in three string columns, one per
device form: ``d`` a dictionary, ``s`` a char slab (values up to 64 bytes,
too many for a dictionary), ``p`` plain offsets and chars (some values
past 64 bytes); each with NULLs, empty strings, surrounding spaces, mixed
case, digits, dates and repeated substrings. Every case runs over each
form (``case x form``, a test each), in one device query a form under test
mode (string parses enabled by their confs), and its column is held to
the JAX session's, which runs the same query. The device tags of the
general regex, the float and timestamp renderings, the conf-gated parses
and the other off-device arms are held to the JAX package's, reason for
reason.
"""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from tests.querytest import with_tpu_session

N = 400
FORMS = {"d": "dict", "s": "slab", "p": "plain"}
# each form's partner column, of another form, for the two-column cases
PARTNER = {"d": "p", "s": "d", "p": "s"}
PARSE_CONF = {"spark.rapids.sql.castStringToInteger.enabled": True,
              "spark.rapids.sql.castStringToDate.enabled": True}
POOL = ["", " hello world ", "Abc", "ab cd EF", "aaaab", "  pad", "tail  ",
        "abcabc", "a.b", "12", "-7", " +42 ", "9223372036854775807",
        "-9223372036854775808", "9223372036854775808", "3.75", "1e5",
        "2024-02-29", "2023-02-29", " 1999-12-31 trailing", "x-y-z",
        "MiXeD cAsE wOrDs", "bababa"]


def frame(n: int = N, seed: int = 14) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    pick = np.asarray(POOL, dtype=object)[rng.integers(0, len(POOL), n)]

    def col(unique: bool, wide: bool):
        out = []
        for i, v in enumerate(pick):
            if unique and i % 3:  # enough distinct values for no dictionary
                v = f"{v}#{i}"
            if wide and i % 50 == 7:
                v = v + " " + "w" * 70 + "ab"
            out.append(v)
        vals = np.asarray(out, dtype=object)
        vals[rng.random(n) < 0.1] = None
        return vals
    x = pd.array(rng.integers(-300, 300, n), dtype="Int64")
    x[rng.random(n) < 0.1] = pd.NA
    ts = pd.Series(np.datetime64("1969-06-01", "s")
                   + rng.integers(0, 60 * 365, n)
                   * np.timedelta64(86400, "s"))
    ts[rng.random(n) < 0.1] = pd.NaT
    b = pd.array(rng.random(n) < 0.5, dtype="boolean")
    b[rng.random(n) < 0.1] = pd.NA
    return pd.DataFrame({"id": np.arange(n, dtype=np.int64),
                         "d": col(False, False), "s": col(True, False),
                         "p": col(True, True), "x": x, "b": b, "ts": ts})


def cases(c: str, o: str):
    """name -> f(functions module) -> Column, over string column ``c``
    (``o`` its partner of another form)."""
    def C(M):
        return M.col(c)
    return {
        "length": lambda M: M.length(C(M)),
        "upper": lambda M: M.upper(C(M)),
        "lower": lambda M: M.lower(C(M)),
        "initcap": lambda M: M.initcap(C(M)),
        "trim": lambda M: M.trim(C(M)),
        "ltrim": lambda M: M.ltrim(C(M)),
        "rtrim": lambda M: M.rtrim(C(M)),
        "lpad": lambda M: M.lpad(C(M), 12, "*"),
        "rpad": lambda M: M.rpad(C(M), 9, "-"),
        "lpad_zero": lambda M: M.lpad(C(M), 0),
        "locate": lambda M: M.locate("b", C(M), 2),
        "instr": lambda M: M.instr(C(M), "ab"),
        "replace": lambda M: M.replace(C(M), "ab", "XYZ"),
        "replace_delete": lambda M: M.replace(C(M), "a", ""),
        "replace_overlap": lambda M: M.replace(C(M), "aba", "_"),
        "regexp_literal": lambda M: M.regexp_replace(C(M), "cd", "Q"),
        "concat": lambda M: M.concat(C(M), M.lit("|"), M.col(o)),
        "concat_ws": lambda M: M.concat_ws("-", C(M), M.col(o), C(M)),
        "translate": lambda M: M.translate(C(M), "ab", "ba"),
        "translate_delete": lambda M: M.translate(C(M), "abc ", "X"),
        "reverse": lambda M: M.reverse(C(M)),
        "repeat": lambda M: M.repeat(C(M), 3),
        "repeat_zero": lambda M: M.repeat(C(M), 0),
        "ascii": lambda M: M.ascii(C(M)),
        "left": lambda M: M.left(C(M), 3),
        "right": lambda M: M.right(C(M), 4),
        "to_int": lambda M: C(M).cast("int"),
        "to_long": lambda M: C(M).cast("long"),
        "to_date": lambda M: M.to_date(C(M)),
        "cast_date": lambda M: C(M).cast("date"),
        "greatest": lambda M: M.greatest(C(M), M.col(o)),
        "least": lambda M: M.least(C(M), M.lit("b"), M.col(o)),
        "upper_eq": lambda M: M.upper(C(M)) == "ABC",
        "trim_len": lambda M: M.length(M.trim(C(M))),
    }


# string renderings of the other types (no string input): once, not by form
RENDERINGS = {
    "int_to_string": lambda M: M.col("x").cast("string"),
    "long_to_string": lambda M: (M.col("x") * 30000000000000).cast(
        "string"),
    "bool_to_string": lambda M: M.col("b").cast("string"),
    "date_to_string": lambda M: M.col("ts").cast("date").cast("string"),
    "chr": lambda M: M.chr_(M.col("x")),
}

CASE_NAMES = list(cases("d", "p"))


def _port(**conf):
    b = (TpuSparkSession.builder().device("cpu")
         .config("spark.rapids.sql.test.enabled", True))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def _select(M, session, df, table):
    return session.create_dataframe(df).select(
        M.col("id"), *[f(M).alias(n) for n, f in table.items()])


def _norm(v):
    if v is None or (isinstance(v, float) and np.isnan(v)) or v is pd.NA \
            or v is pd.NaT:
        return None
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return v


@pytest.fixture(scope="module")
def answers():
    """{table key: (port frame, JAX frame)}, sorted by id: one device query
    a form (and one for the renderings) on each side."""
    from spark_rapids_tpu.session import TpuSparkSession as RefSession
    RefSession.builder().app_name("test").get_or_create()
    df = frame()
    tables = {c: cases(c, PARTNER[c]) for c in FORMS}
    tables["render"] = RENDERINGS
    out = {}
    for key, table in tables.items():
        got = _select(F, _port(**PARSE_CONF), df, table).collect()
        want = with_tpu_session(lambda rs: _select(RF, rs, df, table),
                                conf=PARSE_CONF)
        out[key] = (got.sort_values("id").reset_index(drop=True),
                    want.sort_values("id").reset_index(drop=True))
    return out


def _same_column(pair, name):
    got, want = pair
    assert len(got) == len(want) == N
    g = [_norm(v) for v in got[name]]
    w = [_norm(v) for v in want[name]]
    assert g == w, next((i, a, b) for i, (a, b) in enumerate(zip(g, w))
                        if a != b)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", CASE_NAMES)
def test_string_function_over_each_form(answers, name, form):
    """One case over one form equals the JAX session, nulls and empty
    strings included."""
    _same_column(answers[form], name)


@pytest.mark.parametrize("name", list(RENDERINGS))
def test_string_renderings(answers, name):
    _same_column(answers["render"], name)


# char slots a block for the blocked run: odd and small, so matches,
# replacements, deletions and rows cross many block edges
SMALL_BLOCK = 37


@pytest.fixture(scope="module")
def blocked(answers):
    """The plain form's cases and the renderings with the char-space
    passes at SMALL_BLOCK slots a block, beside the JAX session's."""
    from spark_rapids_tpu_torch.columnar import column
    from spark_rapids_tpu_torch.ops import strings
    df = frame()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(column, "CHAR_BLOCK", SMALL_BLOCK)
        mp.setattr(strings, "CHAR_BLOCK", SMALL_BLOCK)
        for key, table in (("p", cases("p", PARTNER["p"])),
                           ("render", RENDERINGS)):
            got = _select(F, _port(**PARSE_CONF), df, table).collect()
            out[key] = (got.sort_values("id").reset_index(drop=True),
                        answers[key][1])
    return out


@pytest.mark.parametrize("name", CASE_NAMES + list(RENDERINGS))
def test_string_function_in_small_char_blocks(blocked, name):
    """Over plain chars, a case computed block by block equals the JAX
    session whatever the block's size."""
    _same_column(blocked["render" if name in RENDERINGS else "p"], name)


def test_frame_holds_every_form():
    """The frame's string columns upload as a dictionary, a slab and plain
    chars."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    b = DeviceBatch.from_pandas(frame(), {}, device="cpu",
                                slab_stride=upload_blocked_chars())
    cols = dict(zip(b.schema.names, b.columns))
    assert cols["d"].dict_values is not None
    assert cols["s"].has_slab
    assert cols["p"].is_plain


# ---------------------------------------------------------------------------
# Device tags: the JAX package's, reason for reason
# ---------------------------------------------------------------------------

TAGS = {
    "regexp_general": lambda M: M.regexp_replace(M.col("p"), "a.c", "x"),
    "regexp_literal": lambda M: M.regexp_replace(M.col("p"), "ab", "x"),
    "regexp_dollar": lambda M: M.regexp_replace(M.col("p"), "ab", "$1"),
    "float_to_string": lambda M: (M.col("x") * 1.5).cast("string"),
    "timestamp_to_string": lambda M: M.col("ts").cast("string"),
    "string_to_int": lambda M: M.col("s").cast("int"),
    "string_to_date": lambda M: M.col("d").cast("date"),
    "string_to_double": lambda M: M.col("p").cast("double"),
    "string_to_bool": lambda M: M.col("p").cast("boolean"),
    "to_date_string": lambda M: M.to_date(M.col("p")),
    "lpad_multibyte": lambda M: M.lpad(M.col("s"), 5, "é"),
    "translate_non_ascii": lambda M: M.translate(M.col("s"), "a", "é"),
    "concat_ws_non_string": lambda M: M.concat_ws("-", M.col("s"),
                                                  M.col("x")),
    "greatest_strings": lambda M: M.greatest(M.col("s"), M.col("d")),
    "length": lambda M: M.length(M.col("p")),
}


def _port_tag(expr, schema, conf):
    from spark_rapids_tpu_torch.sql.exprs.core import first_unsupported
    return first_unsupported(expr, schema, conf)


@pytest.mark.parametrize("parse_on", [False, True])
@pytest.mark.parametrize("name", list(TAGS))
def test_device_tag_matches_reference(session, name, parse_on):
    """Each expression's device tag (on, or off with its reason) equals the
    JAX package's, with the string parses' confs off (their default) and
    on."""
    from spark_rapids_tpu.columnar.batch import Schema as RSchema
    from spark_rapids_tpu.sql.exprs.core import Expression as RExpr
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.config.conf import TpuConf
    df = frame(40)
    conf = TpuConf()
    for k, v in (PARSE_CONF if parse_on else {}).items():
        conf.set(k, v)
    got = _port_tag(TAGS[name](F).expr, Schema.from_pandas(df), conf)
    saved = dict(session.conf._settings)
    try:
        for k, v in (PARSE_CONF if parse_on else {}).items():
            session.set_conf(k, v)
        rexpr = TAGS[name](RF).expr
        rschema = RSchema.from_pandas(df)
        want = None
        stack = [rexpr]
        while stack and want is None:
            node = stack.pop(0)
            assert isinstance(node, RExpr)
            want = node.device_supported(rschema)
            if want is not None:
                want = f"{type(node).__name__}: {want}"
            stack = list(node.children) + stack
    finally:
        session.conf._settings = saved
    assert got == want


OVERLAP_VALUES = ["aaaa", "aaa", "abaaab", "", "aaaaaaa", "baaaab", "aa",
                  None, "ababababa", "xaaaaaaaaay", "aab", "abab"]


@pytest.mark.parametrize("block", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("search,rep", [("aa", "b"), ("aba", "_"),
                                        ("aaa", "xyz"), ("aaa", ""),
                                        ("aab", "")])
def test_overlapping_replace_across_char_blocks(monkeypatch, block, search,
                                                rep):
    """Leftmost non-overlapping matches, chosen block by block with the
    last choice carried into the next block (a pattern that overlaps
    itself), and a match's bytes dropped across block edges (a shorter
    replacement), equal Python's ``str.replace`` at every block size."""
    import torch
    from spark_rapids_tpu_torch.columnar import column, dtypes
    from spark_rapids_tpu_torch.ops import strings
    from spark_rapids_tpu_torch.sql.exprs.core import DevCol
    monkeypatch.setattr(column, "CHAR_BLOCK", block)
    monkeypatch.setattr(strings, "CHAR_BLOCK", block)
    vals = np.asarray(OVERLAP_VALUES, dtype=object)
    valid = np.asarray([v is not None for v in vals])
    chars, offsets = column.host_string_packed(vals, valid, len(vals))
    col = DevCol(dtypes.STRING, None, torch.from_numpy(valid),
                 chars=torch.from_numpy(chars),
                 offsets=torch.from_numpy(offsets))
    out = strings.replace_literal(None, col, search, rep)
    o, c = out.offsets.numpy(), out.chars.numpy().tobytes()
    got = [c[o[i]:o[i + 1]].decode() if valid[i] else None
           for i in range(len(vals))]
    assert got == [v.replace(search, rep) if v is not None else None
                   for v in vals]
