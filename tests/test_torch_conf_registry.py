"""The port's conf registry against the JAX package's, and the effects of
the keys this slice registered, on the CPU.

Every key of the JAX package's ``conf_entries()`` is registered in the
port (same default, same converter) or listed in ``IGNORED_KEYS`` with
its reason, which lists nothing else; ``help_text()`` prints both. Keys
with an effect in the JAX package have the same effect here:
``reuseSubtrees.enabled`` (TPC-H Q15 and Q17 plan no shared subtree with
it off, answers equal to the JAX session's under the same setting, also
under AQE), ``agg.runtimeSkip`` (the first-batch heuristic), ``hashAgg.
replaceMode`` and ``incompatibleOps.enabled`` (the tag reasons of the
JAX package), the ``dict.*`` keys (uploads without dictionaries; hashes
from chars; a concat of different dictionaries decoded), the scan
pipeline's keys and ``memory.tpu.debug``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.config import conf as ref_conf
from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.reuse import TpuReuseSubtreeExec
from spark_rapids_tpu_torch.models import tpch
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.testing.tpchcases import (
    ORDERS, in_query_order, same_rows,
)
from tests.querytest import with_tpu_session
from tests.test_torch_session_tpch_a import SF, _tables, query_frames
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

REUSE = "spark.rapids.sql.reuseSubtrees.enabled"


def _session(**conf):
    b = TpuSparkSession.builder().device("cpu")
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


# --- the registry ------------------------------------------------------------

def test_every_jax_key_is_registered_or_ignored():
    jax_keys = set(ref_conf.conf_entries())
    port = C.conf_entries()
    missing = sorted(k for k in jax_keys
                     if k not in port and k not in C.IGNORED_KEYS)
    assert missing == []
    assert set(C.IGNORED_KEYS) <= jax_keys
    assert not set(C.IGNORED_KEYS) & set(port)
    assert all(reason.strip() for reason in C.IGNORED_KEYS.values())


def test_registered_keys_keep_the_jax_defaults_and_types():
    jax_entries = ref_conf.conf_entries()
    for key, e in C.conf_entries().items():
        if key in jax_entries:
            j = jax_entries[key]
            assert e.default == j.default, key
            assert e.conv.__name__ == j.conv.__name__, key


def test_help_text_prints_registered_and_ignored_keys():
    text = C.help_text()
    assert text.startswith("Name | Description | Default")
    for key, e in C.conf_entries().items():
        assert f"{key} | {e.doc} | {e.default}" in text
    for key, reason in C.IGNORED_KEYS.items():
        assert f"{key} | {reason}" in text


def test_set_accepts_unregistered_keys_and_validates_registered_ones():
    conf = C.TpuConf()
    conf.set("spark.rapids.sql.smallQuery.enabled", "false")
    assert conf.get("spark.rapids.sql.smallQuery.enabled") == "false"
    conf.set("spark.rapids.sql.exec.SomeExec", "false")
    assert not conf.get_bool("spark.rapids.sql.exec.SomeExec", True)
    conf.set(REUSE, "false")
    assert conf.get(REUSE) is False
    for key in ("spark.rapids.sql.taskThreads",
                "spark.rapids.sql.reader.batchSizeRows"):
        with pytest.raises(ValueError, match="must be positive"):
            conf.set(key, 0)
        with pytest.raises(ValueError, match="must be positive"):
            ref_conf.TpuConf().set(key, 0)
    assert C.TpuConf().get(C.EXPORT_COLUMNAR_RDD.key) is False
    assert C.TpuConf().incompatible_ops_enabled is False


def test_conf_constants_carry_the_jax_names():
    for name in ("EXPORT_COLUMNAR_RDD", "REUSE_SUBTREES", "DICT_ENABLED",
                 "DICT_MERGE_EXCHANGE", "DICT_HASH_VALUES",
                 "AGG_RUNTIME_SKIP", "HAS_NANS", "INCOMPATIBLE_OPS",
                 "AGG_FUSE_COUNT_DISTINCT", "ENABLE_CAST_STRING_TO_NUMERIC",
                 "ENABLE_CAST_STRING_TO_DATE", "HASH_AGG_REPLACE_MODE"):
        assert getattr(C, name).key == getattr(ref_conf, name).key, name


# --- reuseSubtrees.enabled ------------------------------------------------------

def _reuse_nodes(s, df):
    return {id(n) for n in s.physical_plan(df._plan).walk()
            if isinstance(n, TpuReuseSubtreeExec)}


@pytest.mark.parametrize("qname", ["q15", "q17"])
def test_reuse_subtrees_switch(qname):
    fr = query_frames(qname, SF)
    on = _session(**{"spark.rapids.sql.test.enabled": True})
    assert len(_reuse_nodes(on, tpch.QUERIES[qname](on, _tables(on, fr)))) \
        == 1
    off = _session(**{"spark.rapids.sql.test.enabled": True, REUSE: False})
    df = tpch.QUERIES[qname](off, _tables(off, fr))
    assert _reuse_nodes(off, df) == set()
    got = df.collect()
    assert not any(isinstance(n, TpuReuseSubtreeExec)
                   for n in off.last_plan.walk())
    want = with_tpu_session(
        lambda rs: ref_tpch.QUERIES[qname](rs, _tables(rs, fr)),
        conf={REUSE: False})
    assert len(want) > 0
    if ORDERS.get(qname) is not None:
        got, want = (in_query_order(got, ORDERS[qname]),
                     in_query_order(want, ORDERS[qname]))
    same_rows(got, want)


def test_reuse_subtrees_switch_under_aqe():
    """AQE's executor converts each stage through the session's rewrite:
    with the switch off no stage plans a shared subtree."""
    fr = query_frames("q17", SF)
    confs = {"spark.rapids.sql.adaptive.enabled": True,
             "spark.rapids.sql.autoBroadcastJoinThreshold": -1}
    on = _session(**confs)
    want = tpch.QUERIES["q17"](on, _tables(on, fr)).collect()
    off = _session(**confs, **{REUSE: False})
    got = tpch.QUERIES["q17"](off, _tables(off, fr)).collect()
    assert off.last_aqe is not None and on.last_aqe is not None
    assert not any(isinstance(n, TpuReuseSubtreeExec)
                   for n in off.last_plan.walk())
    same_rows(got, want)


# --- agg.runtimeSkip, hashAgg.replaceMode, incompatibleOps ----------------------

def _groupby_frame(n=4096, groups=3000):
    rng = np.random.default_rng(7)
    return pd.DataFrame({"k": rng.integers(0, groups, n),
                         "v": rng.random(n)})


def test_runtime_skip_off_takes_the_first_batch_heuristic():
    from spark_rapids_tpu_torch.obs.events import EVENTS
    pdf = _groupby_frame()
    want = pdf.groupby("k").v.sum()
    for runtime in (True, False):
        s = _session(**{"spark.rapids.sql.batchSizeRows": 512,
                        "spark.rapids.sql.agg.runtimeSkip": runtime})
        seq = max((e["seq"] for e in EVENTS.flight_events()), default=-1)
        got = (s.create_dataframe(pdf).group_by("k")
               .agg(F.sum("v").alias("s")).collect()
               .sort_values("k").reset_index(drop=True))
        np.testing.assert_array_equal(got.k, want.index)
        np.testing.assert_allclose(got.s, want.values, rtol=1e-9)
        decisions = [e for e in EVENTS.flight_events()
                     if e["seq"] > seq and e["kind"] == "aggSkipDecision"]
        # the high-cardinality partial skips: journaled only at runtime
        assert bool(decisions) is runtime
        assert len(s.agg_ratio_cache) == 1


def test_hash_agg_replace_mode_tags_as_the_jax_package():
    pdf = _groupby_frame(64, 5)
    for mode, off in (("partial", "final"), ("final", "partial")):
        s = _session(**{"spark.rapids.sql.hashAgg.replaceMode": mode})
        df = s.create_dataframe(pdf).group_by("k").agg(F.sum("v"))
        text = df.explain("NOT_ON_TPU")
        reason = f"hashAgg replace mode {mode!r} excludes {off} aggregation"
        assert reason in text
        got = df.collect().sort_values("k").reset_index(drop=True)
        want = pdf.groupby("k").v.sum()
        np.testing.assert_allclose(got.iloc[:, 1], want.values, rtol=1e-9)


def test_incompatible_rule_needs_incompatible_ops():
    from spark_rapids_tpu.sql import overrides as RO
    from spark_rapids_tpu_torch.sql import overrides as O
    from spark_rapids_tpu_torch.exec import cpu
    rule = O._RULES[cpu.CpuFilterExec]
    ref_rule = RO._RULES[__import__(
        "spark_rapids_tpu.exec.cpu", fromlist=["x"]).CpuFilterExec]
    pdf = pd.DataFrame({"v": np.arange(8.0)})
    try:
        rule.incompat = ref_rule.incompat = "float compare order"
        for conf, on_device in (({}, False),
                                ({"spark.rapids.sql.incompatibleOps.enabled":
                                  True}, True),
                                ({rule.conf_key: True}, True)):
            s = _session(**conf)
            text = s.create_dataframe(pdf).filter(F.col("v") > 3).explain(
                "ALL")
            rs = ref_session_text(conf, pdf)
            filt = [ln for ln in text.splitlines() if "FilterExec" in ln]
            rfilt = [ln for ln in rs.splitlines() if "FilterExec" in ln]
            assert filt[0].lstrip().startswith("*" if on_device else "!")
            assert filt[0].split("<--")[1:] == rfilt[0].split("<--")[1:]
    finally:
        rule.incompat = ref_rule.incompat = None


def ref_session_text(conf, pdf):
    from spark_rapids_tpu.session import TpuSparkSession as RefSession
    rs = RefSession.active()
    saved = dict(rs.conf._settings)
    try:
        rs.set_conf("spark.rapids.sql.enabled", True)
        for k, v in conf.items():
            rs.set_conf(k, v)
        return rs.create_dataframe(pdf).filter(RF.col("v") > 3).explain(
            "ALL")
    finally:
        rs.conf._settings = saved


# --- the dict.* keys ---------------------------------------------------------

def test_dict_disabled_uploads_plain_strings():
    pdf = pd.DataFrame({"s": ["a", "bb", "a", None, "ccc"] * 20,
                        "n": [1, 2, 1, 2, 1] * 20})
    s = _session(**{"spark.rapids.sql.dict.enabled": False})
    (batch,) = s.create_dataframe(pdf).collect_batches()
    assert batch.column("s").is_plain
    assert batch.column("n").dict_values is None
    on = _session()
    (batch,) = on.create_dataframe(pdf).collect_batches()
    assert batch.column("s").dict_values is not None
    for sess in (s, on):
        got = (sess.create_dataframe(pdf, 2).group_by("s")
               .agg(F.sum("n").alias("t")).collect())
        got = got.sort_values("s", na_position="first").reset_index(drop=True)
        want = (pdf.groupby("s", dropna=False).n.sum().reset_index()
                .sort_values("s", na_position="first")
                .reset_index(drop=True))
        assert [None if pd.isna(v) else v for v in got.s] == \
            [None if pd.isna(v) else v for v in want.s]
        assert list(got.t) == list(want.n)


def _dict_batch(values):
    b = DeviceBatch.from_pandas(pd.DataFrame({"s": values}), {},
                                device="cpu", slab_stride=64)
    assert b.column("s").dict_values is not None
    return b


def test_dict_hash_values_off_hashes_the_same_bits():
    from spark_rapids_tpu_torch.columnar import dictionary
    from spark_rapids_tpu_torch.ops.hashing import hash_string_col
    col = _dict_batch(["x", "yy", None, "x", "zzz"] * 3).column("s")
    on = hash_string_col(col)
    try:
        dictionary.configure_from_conf(C.TpuConf(
            {"spark.rapids.sql.dict.hashValues": False}))
        assert not dictionary.hash_values_enabled()
        off = hash_string_col(col)
    finally:
        dictionary.configure_from_conf(C.TpuConf())
    assert torch.equal(on, off)


def test_dict_merge_on_exchange_off_decodes_at_the_concat():
    from spark_rapids_tpu_torch.columnar import dictionary
    from spark_rapids_tpu_torch.ops.rowops import concat_batches
    a, b = _dict_batch(["x", "y", "x"]), _dict_batch(["z", "x", None])
    merged = concat_batches([a, b], 16)
    assert merged.column("s").dict_values == ("x", "y", "z")
    assert dictionary.mergeable([a.column("s"), b.column("s")])
    try:
        dictionary.configure_from_conf(C.TpuConf(
            {"spark.rapids.sql.dict.mergeOnExchange": False}))
        plain = concat_batches([a, b], 16)
    finally:
        dictionary.configure_from_conf(C.TpuConf())
    assert plain.column("s").dict_values is None
    want = ["x", "y", "x", "z", "x", None]
    for out in (merged, plain):
        assert [None if pd.isna(v) else v
                for v in out.to_pandas().s] == want
    vals, remaps = dictionary.union_dictionaries_cached([("x", "y"),
                                                         ("x", "z")])
    assert vals == ("x", "y", "z")
    assert [list(r) for r in remaps] == [[0, 1, 3], [0, 2, 3]]


# --- the scan pipeline and memory.tpu.debug ----------------------------------

def test_scan_pipeline_config_matches_the_jax_package():
    from spark_rapids_tpu.sql import scan_pipeline as ref_pipeline
    from spark_rapids_tpu_torch.sql import scan_pipeline
    for settings in ({}, {"spark.rapids.sql.scan.prefetchDepth": 0},
                     {"spark.rapids.sql.scan.decodeThreads": 3,
                      "spark.rapids.sql.scan.prefetchMaxBytes": "1g",
                      "spark.rapids.memory.host.spillStorageSize": "64m"}):
        assert scan_pipeline.pipeline_config(C.TpuConf(settings)) == \
            ref_pipeline.pipeline_config(ref_conf.TpuConf(settings))


def test_serial_reader_under_prefetch_depth_zero(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.sql import scan_pipeline
    pdf = pd.DataFrame({"k": np.arange(4000) % 7, "v": np.arange(4000.0)})
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.Table.from_pandas(pdf), path, row_group_size=1000)
    want = pdf.groupby("k").v.sum()
    for depth in (0, 2):
        s = _session(**{"spark.rapids.sql.scan.prefetchDepth": depth})
        got = (s.read.parquet(path).group_by("k").agg(F.sum("v").alias("t"))
               .collect().sort_values("k").reset_index(drop=True))
        assert scan_pipeline._CONFIG["depth"] == depth
        np.testing.assert_allclose(got.t, want.values, rtol=1e-12)
    scan_pipeline.configure_from_conf(C.TpuConf())


def test_memory_debug_keeps_creation_stacks():
    from spark_rapids_tpu_torch.memory.leak import TRACKER
    saved = TRACKER.capture_stacks
    try:
        TRACKER.capture_stacks = False
        _session()
        assert TRACKER.capture_stacks is False
        _session(**{"spark.rapids.memory.tpu.debug": True})
        assert TRACKER.capture_stacks is True
    finally:
        TRACKER.capture_stacks = saved
