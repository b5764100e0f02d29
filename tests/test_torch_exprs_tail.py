"""The rest of the expression set through the port's ``TpuSparkSession`` on
the CPU, against the JAX package's session on the same seeded frame
(``testing/exprcases.py``): abs, unary minus and ``div`` (Java's wrapping
at INT64_MIN), the bitwise operators and the three shifts (amounts
negative and past the width), ``eqNullSafe``, ``isnan``, ``isnull``,
``nanvl``, ``nvl``/``ifnull``/``nvl2``, AtLeastNNonNulls,
NormalizeNaNAndZero, the 21 double functions, ``pow``, ``atan2`` and
``hypot``. Each case runs in test mode through the port's device
operators and through its CPU operators.

The double functions (and the normalization) are held to the JAX
package's CPU operators, numpy: its device path under XLA on the CPU
flushes subnormals to zero. The transcendental ones within rtol 1e-13
(NaN, the infinities and the sign of zero in the same places), the rest
exact. A float column's NaN and NULL collect to the same pandas value in
the JAX package's sessions, so float results compare with the two
merged; the card tests and ``chip_smoke.py`` hold validity and values
apart.

Also: the function surface (every public name of the JAX package's
``sql/functions.py`` and its ``Column``), cbrt against ``np.cbrt``,
signum's zeros, the device tags reason for reason, and that the new
modules import neither jax nor the JAX package.
"""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing import exprcases as E
from tests.querytest import with_cpu_session, with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

N = 400
_DATE_WORDS = ("date", "add_months", "months", "trunc", "unix", "from_unixtime",
               "last_day", "datediff", "next_day")
NAMES = [n for n in E.CASES
         if n not in E.NONDET and not n.startswith(_DATE_WORDS)]
FRAME = E.frame(N)


def port_session(**conf) -> TpuSparkSession:
    b = TpuSparkSession.builder().device("cpu")
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def float_merged(s: pd.Series) -> pd.Series:
    """A float column with NaN and NULL as one value (NULL)."""
    if s.dtype.kind == "f" or str(s.dtype) in ("Float64", "Float32"):
        a = s.to_numpy(dtype=np.float64, na_value=np.nan)
        return pd.Series(a).where(~np.isnan(a))
    return s.reset_index(drop=True)


def run_all(names, df):
    """{jax, jax_cpu, device, cpu}: the projection of ``names`` by each,
    in ``id`` order."""
    def q(M):
        return lambda s: E.projection(M, s, df, names)
    out = {"jax": with_tpu_session(q(RF)), "jax_cpu": with_cpu_session(q(RF)),
           "device": q(F)(port_session(**{
               "spark.rapids.sql.test.enabled": True})).collect(),
           "cpu": q(F)(port_session(**{
               "spark.rapids.sql.enabled": False})).collect()}
    return {k: v.sort_values("id").reset_index(drop=True)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def results():
    return run_all(NAMES, FRAME)


@pytest.mark.parametrize("name", NAMES)
def test_case_matches_reference_session(name, results):
    want = results["jax_cpu" if name in E.NUMPY_HELD else "jax"][name]
    assert want.notna().sum() > N // 4
    for key in ("device", "cpu"):
        err = E.same_values(float_merged(results[key][name]),
                            float_merged(want), name in E.APPROX)
        assert not err, f"{key}: {err}"


def test_function_surface_matches_reference():
    """Every public top-level name of the JAX package's functions module,
    and every public method of its Column, exists in the port's."""
    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and getattr(
                    v, "__module__", mod.__name__) == mod.__name__}
    missing = public(RF) - set(dir(F))
    assert not missing, sorted(missing)
    cols = {n for n in vars(RF.Column) if not n.startswith("_")}
    cols |= {"__neg__"}
    assert not cols - set(dir(F.Column)), sorted(cols - set(dir(F.Column)))


def test_java_wrapping_at_int64_min():
    df = pd.DataFrame({"a": np.array([-(1 << 63), 5, -1], np.int64)})
    for s in (port_session(**{"spark.rapids.sql.test.enabled": True}),
              port_session(**{"spark.rapids.sql.enabled": False})):
        out = s.create_dataframe(df).select(
            (-F.col("a")).alias("neg"), F.abs("a").alias("abs")).collect()
        assert list(out.neg) == [-(1 << 63), -5, 1]
        assert list(out["abs"]) == [-(1 << 63), 5, 1]


def test_cbrt_and_signum_against_numpy():
    """cbrt within an ulp of np.cbrt over 600 decades and subnormals, exact
    on perfect cubes; signum NaN for NaN and +0.0 for either zero, as
    ``np.sign`` gives them."""
    from spark_rapids_tpu_torch.sql.exprs.mathexprs import cbrt, signum
    rng = np.random.default_rng(3)
    x = np.concatenate([[5e-324, -2.5e-310, 1.7976931348623157e308, 0.0,
                         -0.0, np.inf, -np.inf],
                        rng.standard_normal(5000)
                        * 10.0 ** rng.integers(-320, 308, 5000)])
    got, want = cbrt(torch.from_numpy(x)).numpy(), np.cbrt(x)
    fin = np.isfinite(want) & (want != 0)
    assert np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])) <= 4e-16
    assert np.array_equal(got[~fin], want[~fin])
    assert np.array_equal(np.signbit(got), np.signbit(want))
    ints = np.arange(-3000, 3000, dtype=np.float64)
    assert np.array_equal(cbrt(torch.from_numpy(ints ** 3)).numpy(), ints)
    z = np.array([-0.0, 0.0, np.nan, -3.0, 2.0])
    sg = signum(torch.from_numpy(z)).numpy()
    assert np.array_equal(sg, np.sign(z), equal_nan=True)
    assert not np.signbit(sg[:2]).any()


def test_sinh_cosh_past_exp_overflow():
    """cosh and sinh stay finite between 709.78 (exp's overflow) and
    710.47 (their own), as numpy's do."""
    from spark_rapids_tpu_torch.sql.exprs.mathexprs import cosh, sinh
    x = np.array([709.9, -710.3, 710.4, 711.0, -711.0, 1.5])
    for fn, ref in ((cosh, np.cosh), (sinh, np.sinh)):
        got = fn(torch.from_numpy(x)).numpy()
        with np.errstate(over="ignore"):
            want = ref(x)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert np.allclose(got[fin], want[fin], rtol=1e-13, atol=0)


def _fallback_lines(text: str):
    return sorted(ln.strip() for ln in text.splitlines()
                  if ln.strip().startswith("!"))


@pytest.mark.parametrize("case", ["bitwise_float", "shift_float",
                                  "not_float", "math_string"])
def test_device_tags_match_reference(case, session):
    """The expressions the JAX package keeps off the device stay off it
    here, with its reason word for word."""
    df = pd.DataFrame({"x": [1.5, 2.0], "s": ["a", "b"],
                       "i": np.array([1, 2], np.int64)})
    build = {
        "bitwise_float": lambda M: M.col("x").bitwiseAND(M.col("i")),
        "shift_float": lambda M: M.shiftleft(M.col("x"), 1),
        "not_float": lambda M: M.bitwise_not(M.col("x")),
        "math_string": lambda M: M.sin(M.col("s")),
    }[case]
    session.set_conf("spark.rapids.sql.enabled", True)
    want = session.create_dataframe(df).select(
        build(RF).alias("o")).explain()
    got = port_session().create_dataframe(df).select(
        build(F).alias("o")).explain()
    assert_same_reasons(got, want)


def assert_same_reasons(got: str, want: str) -> None:
    """Every fallback reason of the port's tag tree ``got`` is one of the
    JAX package's ``want`` (which may print a node's reason twice)."""
    def reasons(text):
        return {ln.split("<-- ")[1] for ln in _fallback_lines(text)
                if "<-- " in ln}
    assert reasons(got) and reasons(got) <= reasons(want), (got, want)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import spark_rapids_tpu_torch.exec.taskctx\n"
        "import spark_rapids_tpu_torch.exec.generate\n"
        "import spark_rapids_tpu_torch.ops.generate\n"
        "import spark_rapids_tpu_torch.sql.exprs.bitwise\n"
        "import spark_rapids_tpu_torch.sql.exprs.nondet\n"
        "import spark_rapids_tpu_torch.sql.exprs.generators\n"
        "import spark_rapids_tpu_torch.sql.exprs.datetimeexprs\n"
        "import spark_rapids_tpu_torch.testing.exprcases\n"
        "from spark_rapids_tpu_torch.sql import functions as F\n"
        "F.rand(1); F.explode(F.split('a', ','))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'spark_rapids_tpu' or m.startswith("
        "'spark_rapids_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
