"""The port's columnar data plane and row operations against the JAX
package, on the CPU: upload/download round trips, dictionary codes,
filter/gather/concat, and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.ops import rowops as ref_rowops
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, bucket_capacity
from spark_rapids_tpu_torch.ops import rowops
from spark_rapids_tpu_torch.testing.reference import (
    batch_from_reference, batch_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(rng, n=300):
    ints = pd.Series(rng.integers(-5, 5, n), dtype="Int64")
    ints[rng.random(n) < 0.2] = pd.NA
    floats = pd.Series(rng.standard_normal(n), dtype="Float64")
    floats[rng.random(n) < 0.1] = pd.NA
    raw = rng.standard_normal(n)
    raw[::17] = np.nan  # NaN is a value, not NULL
    strs = np.array(["x", "yy", "zzz", None], dtype=object)[
        rng.integers(0, 4, n)]
    ts = pd.Series(pd.to_datetime(rng.integers(0, 10 ** 9, n), unit="s"))
    ts[rng.random(n) < 0.1] = pd.NaT
    flags = pd.Series(rng.random(n) < 0.5, dtype="boolean")
    flags[rng.random(n) < 0.1] = pd.NA
    return pd.DataFrame({
        "i": ints, "f": floats, "raw": raw, "s": strs, "t": ts,
        "b": flags, "small": rng.integers(0, 4, n).astype(np.int32),
        "big": rng.integers(0, 10 ** 9, n)})


@pytest.mark.parametrize("dict_numerics", [True, False])
def test_round_trip_matches_reference(dict_numerics, rng):
    df = _frame(rng)
    port = DeviceBatch.from_pandas(df, dict_numerics=dict_numerics,
                                   device="cpu")
    ref = RefBatch.from_pandas(df, dict_numerics=dict_numerics)
    assert port.capacity == ref.capacity == bucket_capacity(len(df))
    pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas())
    for pc, rc in zip(port.columns, ref.columns):
        assert pc.dict_values == rc.dict_values
        if rc.dict_values is not None:
            np.testing.assert_array_equal(pc.dict_codes.numpy(),
                                          np.asarray(rc.dict_codes))
        np.testing.assert_array_equal(pc.validity.numpy(),
                                      np.asarray(rc.validity))
        if not pc.dtype.is_string:
            np.testing.assert_array_equal(pc.data.numpy(),
                                          np.asarray(rc.data))


def test_shared_scan_dictionary_matches_reference(rng):
    df = _frame(rng, 600)
    state_p, state_r = {}, {}
    for part in (df.iloc[:300], df.iloc[300:]):
        port = DeviceBatch.from_pandas(part, dict_state=state_p,
                                       device="cpu")
        ref = RefBatch.from_pandas(part, dict_state=state_r)
        for pc, rc in zip(port.columns, ref.columns):
            assert pc.dict_values == rc.dict_values
            if rc.dict_values is not None:
                np.testing.assert_array_equal(pc.dict_codes.numpy(),
                                              np.asarray(rc.dict_codes))


def test_batch_from_reference_round_trip(rng):
    ref = RefBatch.from_pandas(_frame(rng))
    port = batch_from_reference(ref)
    pd.testing.assert_frame_equal(port.to_pandas(), ref.to_pandas())
    host = batch_to_numpy(port)
    assert list(host) == list(ref.schema.names)
    assert host["s"][0].dtype == object


def test_plain_string_column_raises():
    df = pd.DataFrame({"s": [f"v{i}" for i in range(5000)]})  # no dictionary
    with pytest.raises(NotImplementedError, match="plain"):
        DeviceBatch.from_pandas(df, device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        DeviceBatch.from_pandas(pd.DataFrame({"a": [1, 2]}))


@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_filter_batch_matches_reference(density, rng):
    import jax.numpy as jnp
    ref = RefBatch.from_pandas(_frame(rng))
    port = batch_from_reference(ref)
    keep = rng.random(ref.capacity) < density
    got = rowops.filter_batch(port, torch.from_numpy(keep))
    want = ref_rowops.filter_batch(ref, jnp.asarray(keep))
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


def test_concat_shared_and_differing_dictionaries(rng):
    df = _frame(rng, 400)
    a = DeviceBatch.from_pandas(df.iloc[:150], device="cpu")
    b = DeviceBatch.from_pandas(df.iloc[150:], device="cpu")
    # a part whose string dictionary differs (a subset)
    c = DeviceBatch.from_pandas(df[df.s == "x"].iloc[:20], device="cpu")
    assert c.column("s").dict_values != a.column("s").dict_values
    out = rowops.concat_batches([a, b, c], 1024)
    want = pd.concat([df.iloc[:150], df.iloc[150:],
                      df[df.s == "x"].iloc[:20]], ignore_index=True)
    pd.testing.assert_frame_equal(
        out.to_pandas(), RefBatch.from_pandas(want).to_pandas())
    assert out.column("s").dict_values == ("x", "yy", "zzz")


def test_concat_with_keep_masks_matches_reference(rng):
    import jax.numpy as jnp
    df = _frame(rng, 400)
    refs = [RefBatch.from_pandas(df.iloc[:250]),
            RefBatch.from_pandas(df.iloc[250:])]
    ports = [batch_from_reference(r) for r in refs]
    masks = [rng.random(r.capacity) < 0.5 for r in refs]
    got = rowops.concat_batches(ports, 512,
                                keep_masks=[torch.from_numpy(m)
                                            for m in masks])
    want = ref_rowops.concat_batches(refs, 512,
                                     keep_masks=[jnp.asarray(m)
                                                 for m in masks])
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


def _slab_batch(strs, other, dict_values=None):
    """A port batch of a string column (a char slab, or dictionary codes
    when ``dict_values`` is given) and an int64 column, on the CPU."""
    from spark_rapids_tpu_torch.columnar import dtype as dtypes
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.columnar.column import (
        DeviceColumn, np_build_slab, slab_stride_for,
    )
    n = len(strs)
    cap = bucket_capacity(n)
    valid = np.zeros(cap, bool)
    valid[:n] = [v is not None for v in strs]
    if dict_values is None:
        raw = [(v or "").encode() for v in strs]
        offs = np.zeros(cap + 1, np.int32)
        offs[1:n + 1] = np.cumsum([len(v) for v in raw])
        offs[n + 1:] = offs[n]
        stride = slab_stride_for(max(map(len, raw), default=0), 64)
        slab, lens = np_build_slab(
            np.frombuffer(b"".join(raw) or b"\0", np.uint8), offs, cap,
            stride)
        col = DeviceColumn(dtypes.STRING, None, torch.from_numpy(valid),
                           slab64=torch.from_numpy(slab.view(np.int64)),
                           lens=torch.from_numpy(lens))
    else:
        codes = np.full(cap, len(dict_values), np.int32)
        codes[:n] = [dict_values.index(v) if v is not None
                     else len(dict_values) for v in strs]
        col = DeviceColumn(dtypes.STRING, None, torch.from_numpy(valid),
                           dict_codes=torch.from_numpy(codes),
                           dict_values=tuple(dict_values))
    data = np.zeros(cap, np.int64)
    data[:n] = other
    ints = DeviceColumn(dtypes.INT64, torch.from_numpy(data),
                        torch.from_numpy(np.arange(cap) < n))
    return DeviceBatch(Schema(["s", "k"], [dtypes.STRING, dtypes.INT64]),
                       [col, ints], torch.tensor(n, dtype=torch.int32))


def _strings(rng, n, width):
    pool = ["", "a", "bc", "x" * width, "Customer#" + "9" * (width - 9),
            None, "\u00e9t\u00e9"]
    return [pool[i] for i in rng.integers(0, len(pool), n)]


def test_slab_column_round_trip_and_filter(rng):
    strs = _strings(rng, 300, 24)
    b = _slab_batch(strs, np.arange(300))
    assert b.column("s").has_slab and b.column("s").char_stride == 32
    got = b.to_pandas()
    assert [None if pd.isna(v) else v for v in got.s] == strs
    keep = torch.from_numpy(rng.random(b.capacity) < 0.5)
    out = rowops.filter_batch(b, keep).to_pandas()
    sel = [i for i in range(300) if keep[i]]
    assert list(out.k) == sel
    assert [None if pd.isna(v) else v for v in out.s] == \
        [strs[i] for i in sel]
    sl = rowops.slice_batch(b, 10, 5).to_pandas()
    assert [None if pd.isna(v) else v for v in sl.s] == strs[10:15]


def test_slab_concat_widens_and_converts_dictionaries(rng):
    a = _strings(rng, 100, 12)   # stride 16
    c = _strings(rng, 70, 40)    # stride 64
    d = ["ab", None, "zz", "ab"]
    parts = [_slab_batch(a, np.arange(100)),
             _slab_batch(c, np.arange(70)),
             _slab_batch(d, np.arange(4), dict_values=["ab", "zz"])]
    out = rowops.concat_batches(parts, 256)
    assert out.column("s").has_slab and out.column("s").char_stride == 64
    got = [None if pd.isna(v) else v for v in out.to_pandas().s]
    assert got == a + c + d
    masks = [torch.from_numpy(rng.random(p.capacity) < 0.6) for p in parts]
    out = rowops.concat_batches(parts, 256, keep_masks=masks)
    want = [v for p, m, vals in zip(parts, masks, (a, c, d))
            for i, v in enumerate(vals) if m[i]]
    assert [None if pd.isna(v) else v for v in out.to_pandas().s] == want


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "from spark_rapids_tpu_torch.models import q1_step as Q\n"
        "from spark_rapids_tpu_torch.models import tpch_data as G\n"
        "from spark_rapids_tpu_torch.models import tpch_joins as J\n"
        "import spark_rapids_tpu_torch.exec.tpujoin\n"
        "import spark_rapids_tpu_torch.ops.joins\n"
        "import spark_rapids_tpu_torch.ops.strings\n"
        "import spark_rapids_tpu_torch.ops.sortops\n"
        "import spark_rapids_tpu_torch.testing.hashcheck\n"
        "import spark_rapids_tpu_torch.tools.profile_queries\n"
        "import spark_rapids_tpu_torch.exec.transitions\n"
        "import spark_rapids_tpu_torch.obs.metrics\n"
        "import spark_rapids_tpu_torch.ops.parquet_decode\n"
        "import spark_rapids_tpu_torch.sql.parquet_raw\n"
        "import spark_rapids_tpu_torch.sql.scan_pipeline\n"
        "import spark_rapids_tpu_torch.sql.sources\n"
        "from spark_rapids_tpu_torch.models import tpch as T\n"
        "from spark_rapids_tpu_torch.session import TpuSparkSession\n"
        "from spark_rapids_tpu_torch.models import tpch_scan as S\n"
        "import tempfile\n"
        "out = Q.run_q1(G.gen_lineitem(0.0005), 1024, device='cpu')\n"
        "assert len(out) == 6, out\n"
        "fr = {'lineitem': G.gen_lineitem(0.0005),\n"
        "      'orders': G.gen_orders(0.0005),\n"
        "      'customer': G.gen_customer(0.0005)}\n"
        "assert len(J.run_q3(fr, 1024, device='cpu')) == 10\n"
        "assert len(J.run_q4(fr, 1024, device='cpu')) > 0\n"
        "p = G.write_parquet(tempfile.mkdtemp(), 0.0005, frames=fr)\n"
        "assert len(S.run_q1_parquet(p['lineitem'], device='cpu')) == 6\n"
        "assert len(S.run_q3_parquet(p, device='cpu')) == 10\n"
        "assert len(S.customer_segment_collect(p['customer'],\n"
        "                                      device='cpu')) > 0\n"
        "ss = TpuSparkSession.builder().device('cpu').get_or_create()\n"
        "t = {'lineitem': ss.create_dataframe(fr['lineitem'])}\n"
        "assert len(T.q1(ss, t).collect()) == 6\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'spark_rapids_tpu'"
        " or m.startswith('spark_rapids_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")
