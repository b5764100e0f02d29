"""The port's shuffle wire format (``shuffle/wire.py``) against the JAX
package's, on the CPU.

Every batch is built once in the JAX package from a seeded frame (its
upload, or a char slab made from its packed chars) and carried into the
port buffer for buffer, in the same form (fixed width with nulls,
dictionary codes and values, a char slab, plain offsets and chars), so
both serialize the same rows. The frames are byte-identical: v1 for
fixed-width and plain or slab strings, v2 for a dictionary column, v1
again for a dictionary under ``spark.rapids.sql.dict.wire=false``; also
the empty batch and a 0-row upload. Each package deserializes the other's
frames to equal contents; a bad magic or version raises AssertionError in
both. A serialization is one counted ``exchange.wire`` wait.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.columnar import column as jcol
from spark_rapids_tpu.columnar import dictionary as jdict
from spark_rapids_tpu.columnar import dtype as jdt
from spark_rapids_tpu.columnar.batch import DeviceBatch as JBatch
from spark_rapids_tpu.columnar.batch import Schema as JSchema
from spark_rapids_tpu.shuffle import wire as jwire
from spark_rapids_tpu_torch.columnar import dictionary as pdict
from spark_rapids_tpu_torch.columnar import dtype as pdt
from spark_rapids_tpu_torch.columnar.batch import Schema as PSchema
from spark_rapids_tpu_torch.exec.tpu import empty_batch
from spark_rapids_tpu_torch.obs.syncledger import SYNCS
from spark_rapids_tpu_torch.shuffle import wire as pwire
from spark_rapids_tpu_torch.testing.reference import batch_same_forms


def with_slab(jb, name: str):
    """``jb`` with string column ``name`` rebuilt as a char slab."""
    i = list(jb.schema.names).index(name)
    c = jb.columns[i]
    chars = np.asarray(c.data)
    offsets = np.asarray(c.offsets)
    maxlen = int((offsets[1:] - offsets[:-1]).max())
    words, lens = jcol.np_build_slab(chars, offsets, jb.capacity,
                                     jcol.slab_stride_for(maxlen, 64))
    cols = list(jb.columns)
    cols[i] = jcol.DeviceColumn(jdt.STRING, None, c.validity,
                                slab64=jnp.asarray(words),
                                lens=jnp.asarray(lens))
    return JBatch(jb.schema, cols, jb.num_rows)


def fixed_frame(n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    null = pd.Series(rng.random(n) < 0.2)
    return pd.DataFrame({
        "i8": pd.Series(rng.integers(-100, 100, n).astype(np.int8))
        .astype("Int8").mask(null),
        "i16": pd.Series(rng.integers(-1000, 1000, n).astype(np.int16))
        .astype("Int16"),
        "i32": pd.Series(rng.integers(-10 ** 6, 10 ** 6, n)
                         .astype(np.int32)).astype("Int32").mask(~null),
        "i64": rng.integers(-2 ** 40, 2 ** 40, n),
        "f32": pd.Series(rng.uniform(-5, 5, n).astype(np.float32))
        .astype("Float32").mask(null),
        "f64": rng.uniform(-1e6, 1e6, n),
        "b": pd.Series(rng.random(n) < 0.5).astype("boolean").mask(null),
        "ts": pd.Series(np.datetime64("2020-01-01T00:00:00", "us")
                        + rng.integers(0, 10 ** 12, n)
                        .astype("timedelta64[us]")).mask(null),
    })


def with_date(jb, seed: int):
    """``jb`` with a date32 column ``d`` (days since the epoch, a fifth
    null) appended."""
    rng = np.random.default_rng(seed)
    cap, n = jb.capacity, int(np.asarray(jb.num_rows))
    days = np.zeros(cap, np.int32)
    days[:n] = rng.integers(0, 20000, n)
    valid = np.zeros(cap, np.bool_)
    valid[:n] = rng.random(n) < 0.8
    days[~valid] = 0
    col = jcol.DeviceColumn(jdt.DATE32, jnp.asarray(days),
                            jnp.asarray(valid))
    schema = JSchema(list(jb.schema.names) + ["d"],
                     list(jb.schema.dtypes) + [jdt.DATE32])
    return JBatch(schema, list(jb.columns) + [col], jb.num_rows)


def string_frame(n: int, seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    grp = np.array(["grp%dü" % g for g in rng.integers(0, 12, n)],
                   dtype=object)
    grp[rng.random(n) < 0.1] = None
    words = np.array(["w%d-%s" % (i, "x" * int(rng.integers(0, 90)))
                      for i in range(n)], dtype=object)
    words[rng.random(n) < 0.15] = None
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64),
                         "g": pd.Series(grp), "p": pd.Series(words)})


def cases():
    """(name, JAX batch) of every form the wire carries."""
    fixed = with_date(JBatch.from_pandas(fixed_frame(300, 1)), 4)
    strings = JBatch.from_pandas(string_frame(400, 2))
    assert strings.columns[1].dict_values is not None  # a dictionary
    assert strings.columns[2].dict_values is None  # plain chars
    slab = with_slab(JBatch.from_pandas(string_frame(200, 3)[["k", "p"]]
                                        .assign(p=lambda f: f.p.str[:30])),
                     "p")
    zero = JBatch.from_pandas(pd.DataFrame({
        "a": np.zeros(0, np.int64), "s": pd.Series([], dtype=object)}))
    empty = JBatch.empty(JSchema(["a", "s"], [jdt.INT64, jdt.STRING]))
    return [("fixed", fixed), ("strings", strings), ("slab", slab),
            ("zero_rows", zero), ("empty", empty)]


CASES = dict(cases())


@pytest.fixture
def dict_wire():
    """Sets both packages' ``dict.wire`` flag; restores it after."""
    saved = (jdict._FLAGS["wire"], pdict._FLAGS["wire"])

    def set_(on: bool):
        jdict._FLAGS["wire"] = on
        pdict._FLAGS["wire"] = on
    yield set_
    jdict._FLAGS["wire"], pdict._FLAGS["wire"] = saved


def same_contents(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.isna().tolist() == w.isna().tolist(), c
        gv = [v for v in g if not pd.isna(v)]
        wv = [v for v in w if not pd.isna(v)]
        assert gv == wv, c


@pytest.mark.parametrize("wire_on", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("name", list(CASES))
def test_frames_byte_identical(name, wire_on, dict_wire):
    dict_wire(wire_on)
    jb = CASES[name]
    want = jwire.serialize_batch(jb)
    got = pwire.serialize_batch(batch_same_forms(jb))
    assert got == want
    version = struct.unpack_from("<I", got, 4)[0]
    has_dict = any(dt.is_string and c.dict_values is not None
                   for dt, c in zip(jb.schema.dtypes, jb.columns))
    assert version == (2 if has_dict and wire_on else 1)


@pytest.mark.parametrize("name", list(CASES))
def test_each_package_reads_the_others_frames(name):
    jb = CASES[name]
    want = jb.to_pandas()
    from_port = jwire.deserialize_batch(
        pwire.serialize_batch(batch_same_forms(jb)))
    same_contents(from_port.to_pandas(), want)
    from_jax = pwire.deserialize_batch(jwire.serialize_batch(jb), "cpu")
    assert from_jax.host_rows == len(want)
    same_contents(from_jax.to_pandas(), want)
    # a dictionary arrives codes-only with the same values
    for dt, jc, pc in zip(jb.schema.dtypes, jb.columns, from_jax.columns):
        if dt.is_string and jc.dict_values is not None:
            assert pc.dict_values == jc.dict_values


def test_port_round_trip_of_its_empty_batch_and_a_dictionary_v1(dict_wire):
    """The port's own empty partition (a dictionary of no values) and a
    dictionary column under dict.wire=false come back equal."""
    schema = PSchema(["a", "s"], [pdt.INT64, pdt.STRING])
    out = pwire.deserialize_batch(pwire.serialize_batch(
        empty_batch(schema, "cpu")), "cpu")
    assert out.host_rows == 0 and out.to_pandas().shape == (0, 2)
    dict_wire(False)
    jb = CASES["strings"]
    back = pwire.deserialize_batch(pwire.serialize_batch(batch_same_forms(jb)),
                                   "cpu")
    assert back.columns[1].dict_values is None  # chars on the wire
    same_contents(back.to_pandas(), jb.to_pandas())


def test_header_validation_raises_as_the_jax_package():
    blob = bytearray(pwire.serialize_batch(batch_same_forms(CASES["fixed"])))
    for mod in (jwire, pwire):
        with pytest.raises(AssertionError):
            mod.deserialize_table(b"\x00" * 64)
        bad = bytearray(blob)
        struct.pack_into("<I", bad, 4, 3)
        with pytest.raises(AssertionError, match="unsupported wire version"):
            mod.deserialize_table(bytes(bad))


def test_serialize_is_one_counted_wait():
    pb = batch_same_forms(CASES["strings"])
    before = dict(SYNCS.syncs)
    pwire.serialize_batch(pb)
    delta = {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
             if v != before.get(k, 0)}
    assert delta == {"exchange.wire": 1}
