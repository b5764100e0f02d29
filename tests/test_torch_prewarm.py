"""The pre-warm substrate (``utils/argspec.py``, ``serving/prewarm.py``,
the warm manifest of ``obs/compilecache.py``) on the CPU, against the
JAX package's ``load_manifest``.

  * an argspec round trip keeps every column form (dictionary with its
    values, char slab, plain offsets and chars, fixed width), tensors'
    shapes, dtypes and devices, static scalars and nested trees, and
    rebuilds them zero-filled and all-invalid; an argument the walk
    cannot rebuild, or a dictionary past its budget, is not replayable;
  * ``load_manifest`` reads a JSONL file with a torn last line, an
    ``{"entries": [...]}`` document, a bare list and a one-record file
    as the JAX package's does;
  * a wrapper's first launch of a signature appends one record to the
    warm manifest (a launch of another shape another; a decode wrapper
    one record with no argspec);
  * the pre-warm pass replays B1-B4 and B8 from such a manifest on the
    CPU (their plain versions), counts the decode entry skipped, stops
    at its budget with entries pending, and is cancelled with its
    session.
"""

import json

import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtype as dtypes
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.obs.compilecache import SHARED
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.serving import prewarm
from spark_rapids_tpu_torch.utils import argspec


def _batch(n=6):
    valid = torch.ones(n, dtype=torch.bool)
    dictc = DeviceColumn(dtypes.STRING, None, valid,
                         dict_codes=torch.arange(n, dtype=torch.int32) % 2,
                         dict_values=("east", "west"))
    slab = DeviceColumn(dtypes.STRING, None, valid,
                        slab64=torch.ones((n, 2), dtype=torch.int64),
                        lens=torch.full((n,), 9, dtype=torch.int32))
    plain = DeviceColumn(dtypes.STRING, None, valid,
                         chars=torch.ones(40, dtype=torch.uint8),
                         offsets=torch.arange(n + 1, dtype=torch.int32) * 5)
    fixed = DeviceColumn(dtypes.INT64, torch.arange(n, dtype=torch.int64),
                         valid)
    cols = [dictc, slab, plain, fixed]
    return DeviceBatch(Schema(["d", "s", "p", "x"],
                              [c.dtype for c in cols]),
                       cols, torch.tensor(n, dtype=torch.int32))


def test_argspec_round_trip_keeps_every_form():
    b = _batch()
    keep = torch.ones(7, dtype=torch.bool)
    spec = argspec.capture(
        (b, [keep, torch.zeros((3, 2), dtype=torch.float64)],
         ("sum", 4, 2.5, None)), {"table_size": 64, "m": {"k": "v"}})
    spec = json.loads(json.dumps(spec))  # it is JSON as it stands
    (b2, lst, tup), kw = argspec.build(spec)
    assert kw == {"table_size": 64, "m": {"k": "v"}}
    assert tup == ("sum", 4, 2.5, None)
    assert lst[0].dtype == torch.bool and lst[0].shape == (7,) \
        and not lst[0].any()
    assert lst[1].dtype == torch.float64 and lst[1].shape == (3, 2)
    assert list(b2.schema.names) == ["d", "s", "p", "x"]
    assert int(b2.num_rows) == 0
    d, s, p, x = b2.columns
    assert d.dict_values == ("east", "west")
    assert d.dict_codes.tolist() == [2] * 6  # the NULL sentinel
    assert s.has_slab and s.slab64.shape == (6, 2) and not s.lens.any()
    assert p.is_plain and p.chars.shape == (40,) and p.offsets.shape == (7,)
    assert x.data.dtype == torch.int64 and not x.data.any()
    for c in b2.columns:
        assert c.dtype == b.columns[b2.columns.index(c)].dtype
        assert not c.validity.any()
    assert "bool[7]" in argspec.avals(spec)
    # on another device than recorded
    (k2,), _ = argspec.build(argspec.capture((keep,), {}), device="cpu")
    assert k2.device.type == "cpu"


def test_argspec_refuses_what_it_cannot_rebuild():
    assert argspec.capture((object(),), {}) is None
    assert argspec.capture(({1: 2},), {}) is None
    big = DeviceColumn(dtypes.STRING, None, torch.ones(2, dtype=torch.bool),
                       dict_codes=torch.zeros(2, dtype=torch.int32),
                       dict_values=tuple("x" * 100 + str(i)
                                         for i in range(100)))
    assert argspec.capture((big,), {}) is None


def test_load_manifest_reads_like_the_jax_package(tmp_path):
    from spark_rapids_tpu.serving import prewarm as ref
    recs = [{"kernel": "compact_permutation", "kernelKey": "a",
             "argspec": None}, {"kernel": "hash_table_build",
                                "kernelKey": "b", "argspec": {"args": []}}]
    docs = {
        "torn.jsonl": "\n".join(json.dumps(r) for r in recs)
        + '\n{"kernel": "hal',
        "doc.json": json.dumps({"entries": recs + ["junk"]}),
        "list.json": json.dumps(recs),
        "one.jsonl": json.dumps(recs[0]) + "\n",
    }
    for name, text in docs.items():
        path = tmp_path / name
        path.write_text(text)
        assert prewarm.load_manifest(str(path)) == \
            ref.load_manifest(str(path)), name
    bad = tmp_path / "bad.json"
    bad.write_text("not json\n")
    for mod in (prewarm, ref):
        with pytest.raises(ValueError):
            mod.load_manifest(str(bad))


def _manifest_from_launches(path: str) -> None:
    """Record B1-B4 and B8 launches (and a decode launch) the way a
    card's wrappers do (``kernels._launched``), from CPU tensors."""
    SHARED.configure_warm_manifest(path)
    try:
        keep = torch.zeros(64, dtype=torch.bool)
        images = [torch.zeros(64, dtype=torch.int64)]
        valid = torch.zeros(64, dtype=torch.bool)
        K._launched("compact_permutation", "compact_permutation",
                    "compact", (keep,))
        K._launched("compact_permutation", "compact_permutation",
                    "compact", (keep,))  # the same signature: no record
        K._launched("compact_permutation", "compact_permutation",
                    "compact", (torch.zeros(32, dtype=torch.bool),))
        K._launched("hash_table_build", "hash_table_build", "hash_join",
                    (images, valid, 128))
        table = torch.zeros((1, 128), dtype=torch.int64)
        counts = torch.zeros(128, dtype=torch.int32)
        K._launched("hash_table_probe", "hash_table_lookup", "hash_join",
                    (table, counts, None, images, valid, 128))
        jobs = [("sum", torch.zeros(64, dtype=torch.float64), valid)]
        K._launched("hash_grouped_aggregate", "hash_grouped_aggregate",
                    "hash_agg", (images, valid, jobs, 128))
        K._launched("slab_pack", "slab_pack", "parquet_decode",
                    (torch.zeros(16, dtype=torch.uint8),
                     torch.zeros(4, dtype=torch.int64),
                     torch.zeros(4, dtype=torch.int32), 4, 16))
        K._launched("hybrid_expand", "hybrid_expand_many",
                    "parquet_decode", None)
        K._launched("hybrid_expand", "hybrid_expand_many",
                    "parquet_decode", None)
    finally:
        SHARED.configure_warm_manifest("")
        K.reset_launches()


def test_first_launches_are_recorded_once(tmp_path):
    path = str(tmp_path / "warm.jsonl")
    _manifest_from_launches(path)
    recs = prewarm.load_manifest(path)
    assert [r["kernel"] for r in recs] == [
        "compact_permutation", "compact_permutation", "hash_table_build",
        "hash_table_probe", "hash_grouped_aggregate", "slab_pack",
        "hybrid_expand"]
    assert recs[-1]["argspec"] is None
    assert {r["library"] for r in recs} == {
        "compact", "hash_join", "hash_agg", "parquet_decode"}
    assert all(r["pid"] and r["kernelKey"] for r in recs)


def test_prewarm_replays_the_manifest_on_the_cpu(tmp_path):
    path = str(tmp_path / "warm.jsonl")
    _manifest_from_launches(path)
    p = prewarm.AotPrewarmer(path, budget_s=60.0, device="cpu").start()
    assert p.wait_idle(60)
    snap = p.snapshot()
    assert (snap["warmed"], snap["skipped"], snap["failed"],
            snap["pending"]) == (6, 1, 0, 0), snap["errors"]
    assert snap["libraries"] == ["compact", "hash_join", "hash_agg",
                                 "parquet_decode"]
    assert snap["librariesLoaded"] == 0  # no card: nothing to load
    assert not any(K.LAUNCHES.values())  # plain versions count nothing
    # a spent budget leaves the rest pending
    p = prewarm.AotPrewarmer(path, budget_s=1e-9, device="cpu").start()
    assert p.wait_idle(60)
    snap = p.snapshot()
    assert snap["budgetExhausted"] and snap["pending"] >= 5


def test_session_starts_and_stop_cancels_the_pass(tmp_path):
    from spark_rapids_tpu_torch.session import TpuSparkSession
    path = str(tmp_path / "warm.jsonl")
    _manifest_from_launches(path)
    s = TpuSparkSession.builder().device("cpu").config(
        "spark.rapids.tpu.compile.aot.manifest", path).get_or_create()
    try:
        p = prewarm.active()
        assert p is not None and p.manifest_path == path
        assert p.wait_idle(60) and p.snapshot()["warmed"] == 6
        # the same manifest at the next query: the same pass
        s.create_dataframe(__import__("pandas").DataFrame(
            {"a": [1]})).collect()
        assert prewarm.active() is p
    finally:
        s.stop()
    assert prewarm.active() is None and p.snapshot()["cancelled"]
