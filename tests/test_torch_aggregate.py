"""The port's aggregation against the JAX package, on the CPU: the update
and merge steps on the dictionary, hash, sorted-payload and keyless
branches, and the dense per-slot reductions (every branch alone:
``tests/test_torch_groupby.py``). Same batches on both sides (the port's batches
are built from the JAX package's buffers); counts, keys and integers must
match exactly, float64 results at rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.exec import aggutil as ref_aggutil
from spark_rapids_tpu.ops import aggregate as ref_agg
from spark_rapids_tpu.ops import densered as ref_densered
from spark_rapids_tpu.ops import rowops as ref_rowops
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu.sql import planner as ref_planner
from spark_rapids_tpu.sql.exprs import core as ref_core
from spark_rapids_tpu.sql.exprs import evalbridge as ref_evalbridge
from spark_rapids_tpu_torch.exec import aggutil
from spark_rapids_tpu_torch.ops import aggregate, densered, rowops
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.exprs import core, evalbridge
from spark_rapids_tpu_torch.testing.reference import batch_from_reference

F64_RTOL = 1e-9

REF = dict(F=RF, AggPlan=ref_aggutil.AggPlan, bind=ref_core.bind_references,
           bind_non_agg=ref_planner._bind_non_agg,
           update=ref_agg.aggregate_update, merge=ref_agg.aggregate_merge,
           concat=ref_rowops.concat_batches,
           project=ref_evalbridge.eval_projection)
PORT = dict(F=PF, AggPlan=aggutil.AggPlan, bind=core.bind_references,
            bind_non_agg=aggutil.bind_non_agg,
            update=aggregate.aggregate_update,
            merge=aggregate.aggregate_merge, concat=rowops.concat_batches,
            project=evalbridge.eval_projection)


def _frame(rng, n):
    ints = pd.Series(rng.integers(-100, 100, n), dtype="Int64")
    ints[rng.random(n) < 0.15] = pd.NA
    vals = pd.Series(rng.standard_normal(n) * 1e3, dtype="Float64")
    vals[rng.random(n) < 0.15] = pd.NA
    okey = pd.Series(rng.integers(0, n // 3, n), dtype="Int64")
    okey[rng.random(n) < 0.05] = pd.NA  # null keys form their own group
    return pd.DataFrame({
        "flag": np.array(["A", "N", "R", None], dtype=object)[
            rng.integers(0, 4, n)],
        "status": np.array(["F", "O"], dtype=object)[rng.integers(0, 2, n)],
        "okey": okey,
        "i": ints, "v": vals, "small": rng.integers(0, 9, n).astype(np.int32),
        "raw": rng.standard_normal(n)})


def _plan(pkg, schema, keys):
    F = pkg["F"]
    results = [(k, F.col(k)) for k in keys] + [
        ("sum_i", F.sum("i")), ("sum_v", F.sum("v")), ("avg_v", F.avg("v")),
        ("sum_expr", F.sum(F.col("raw") * (1 - F.col("v")))),
        ("cnt", F.count("*")), ("cnt_i", F.count("i")),
        ("min_i", F.min("i")), ("max_v", F.max("v")),
        ("min_small", F.min("small")), ("max_raw", F.max("raw")),
        ("first_i", F.first("i")), ("last_v", F.last("v", True))]
    grouping = [(k, pkg["bind"](F.col(k).expr, schema)) for k in keys]
    return pkg["AggPlan"](schema, grouping,
                          [(n, pkg["bind_non_agg"](c.expr, schema))
                           for n, c in results])


def _run(pkg, batches, keys, hash_table):
    plan = _plan(pkg, batches[0].schema, keys)
    red = [op for ops in plan.update_plan for op in ops]
    mred = [op for ops in plan.merge_plan for op in ops]
    kx = [e for _, e in plan.grouping]
    parts = [pkg["update"](b, kx, plan.update_inputs, red,
                           plan.partial_schema, hash_table=hash_table)
             for b in batches]
    cat = pkg["concat"](parts, 2 * max(p.capacity for p in parts))
    merged = pkg["merge"](cat, plan.num_keys, mred, plan.partial_schema,
                          hash_table=hash_table)
    fin = plan.finalize_exprs()
    out = pkg["project"](merged, [e for _, e in fin], [n for n, _ in fin])
    return parts, out


def _assert_same(got: pd.DataFrame, want: pd.DataFrame, keys):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if keys:
        got = got.sort_values(keys, na_position="first").reset_index(
            drop=True)
        want = want.sort_values(keys, na_position="first").reset_index(
            drop=True)
    for c in got.columns:
        g, w = got[c], want[c]
        pd.testing.assert_series_equal(g.isna(), w.isna(), check_names=False)
        live = ~w.isna().to_numpy()
        gv = g.to_numpy(dtype=object)[live]
        wv = w.to_numpy(dtype=object)[live]
        if pd.api.types.is_float_dtype(w.dtype):
            np.testing.assert_allclose(gv.astype(np.float64),
                                       wv.astype(np.float64),
                                       rtol=F64_RTOL, err_msg=c)
        else:
            assert list(gv) == list(wv), c


@pytest.mark.parametrize("branch", ["dict", "hash", "keyless"])
def test_update_and_merge_match_reference(branch, rng):
    df = _frame(rng, 900)
    keys = {"dict": ["flag", "status"], "hash": ["okey", "flag"],
            "keyless": []}[branch]
    refs = [RefBatch.from_pandas(df.iloc[:500]),
            RefBatch.from_pandas(df.iloc[500:])]
    ports = [batch_from_reference(r) for r in refs]
    hash_table = 1 << 12 if branch == "hash" else None
    ref_parts, ref_out = _run(REF, refs, keys, hash_table)
    parts, out = _run(PORT, ports, keys, hash_table)
    for p, r in zip(parts, ref_parts):
        assert p.capacity == r.capacity
        _assert_same(p.to_pandas(), r.to_pandas(), keys)
    _assert_same(out.to_pandas(), ref_out.to_pandas(), keys)
    if branch == "dict":
        # output capacity shrinks to the slot-table bucket: (4+1) x (2+1)
        assert parts[0].capacity == 16


def test_hash_branch_declines_over_budget_and_unported_branches_raise(rng):
    """Over its slot budget the hash branch declines and the sorted-payload
    branch takes the batch, as in the JAX package; without a hash table the
    same key takes that branch too (the JAX package's default). Both equal
    the JAX package's results, update and merge."""
    df = _frame(rng, 2000)  # okey too many values for a dictionary
    ref = RefBatch.from_pandas(df)
    port = batch_from_reference(ref)
    assert port.column("okey").dict_values is None
    for hash_table in (16, None):  # a table of 16 slots; the batch needs 4096
        aggregate.reset_branches()
        ref_parts, ref_out = _run(REF, [ref], ["okey"], hash_table)
        parts, out = _run(PORT, [port], ["okey"], hash_table)
        assert set(aggregate.BRANCHES) == {"sorted_payload"}
        _assert_same(parts[0].to_pandas(), ref_parts[0].to_pandas(),
                     ["okey"])
        _assert_same(out.to_pandas(), ref_out.to_pandas(), ["okey"])


def test_slot_reduce_dense_matches_reference(rng):
    n, T = 700, 6
    slot = rng.integers(0, T + 1, n)  # T parks rows
    live = rng.random(n) < 0.9
    ints = rng.integers(-(1 << 62), 1 << 62, n)  # sums wrap mod 2^64
    floats = rng.standard_normal(n) * 1e4
    floats[slot == 1] = np.nan  # NaN poisons its group only
    floats[(slot == 2) & (rng.random(n) < 0.2)] = np.inf
    floats[(slot == 3) & (rng.random(n) < 0.2)] = -np.inf
    floats[(slot == 4) & (rng.random(n) < 0.3)] = np.inf
    floats[(slot == 4) & (rng.random(n) < 0.3)] = -np.inf
    valid = rng.random(n) < 0.8
    jobs = [("sum", ints, valid, np.int64), ("sum", floats, valid, np.float64),
            ("count_valid", valid, valid, np.int64)]
    want, want_rows = ref_densered.slot_reduce_dense(
        jnp.asarray(slot.astype(np.int32)), jnp.asarray(live), T,
        [(k, jnp.asarray(v), jnp.asarray(m), d) for k, v, m, d in jobs])
    got, got_rows = densered.slot_reduce_dense(
        torch.from_numpy(slot), torch.from_numpy(live), T,
        [(k, torch.from_numpy(v), torch.from_numpy(m), t) for (k, v, m, _d), t
         in zip(jobs, (torch.int64, torch.float64, torch.int64))])
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    for (gd, gv), (wd, wv) in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        wd = np.asarray(wd)
        if wd.dtype == np.float64:
            np.testing.assert_allclose(gd.numpy(), wd, rtol=F64_RTOL)
        else:
            np.testing.assert_array_equal(gd.numpy(), wd)
