"""TPC-H Q1, Q6 and the Q18 group-by through the port against the JAX
package, on the CPU, at a few thousand rows.

Both sides upload the same generated lineitem rows in the same batches.
The JAX side runs its own ``q1_partial_step`` and the same composition for
Q6 and Q18 (partial step per batch -> concat -> merge -> finalize) with its
default jnp spellings; the port runs its query runners. Keys, counts and integers
must match exactly, float64 results at rtol 1e-9; rows compare by key,
since Sort is not in the slice."""

import datetime

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu.columnar.batch import DeviceBatch as RefBatch
from spark_rapids_tpu.columnar.batch import bucket_capacity as ref_bucket
from spark_rapids_tpu.exec.aggutil import AggPlan as RefAggPlan
from spark_rapids_tpu.models import q1_step as ref_q1
from spark_rapids_tpu.models.tpch_data import gen_lineitem as ref_gen
from spark_rapids_tpu.ops import aggregate as ref_agg
from spark_rapids_tpu.ops import rowops as ref_rowops
from spark_rapids_tpu.sql import functions as RF
from spark_rapids_tpu.sql.exprs.core import bind_references as ref_bind
from spark_rapids_tpu.sql.exprs.evalbridge import (
    eval_projection as ref_project, make_context as ref_ctx,
    to_device_column as ref_to_col,
)
from spark_rapids_tpu.sql.planner import _bind_non_agg as ref_bind_non_agg
from spark_rapids_tpu_torch.models import q1_step as Q
from spark_rapids_tpu_torch.models.tpch_data import gen_lineitem
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

F64_RTOL = 1e-9
SF = 8000 / 6_000_000
BATCH = 4096
HASH_SLOTS = Q.Q18_HASH_SLOTS


@pytest.fixture(scope="module")
def lineitem():
    df = gen_lineitem(SF, seed=11)
    pd.testing.assert_frame_equal(df, ref_gen(SF, seed=11))
    return df


def _ref_batches(df, columns):
    df = df[list(columns)]
    return [RefBatch.from_pandas(df.iloc[s:s + BATCH], dict_numerics=False)
            for s in range(0, len(df), BATCH)]


def _ref_filter(batch, cond):
    ctx = ref_ctx(batch)
    pred = ref_to_col(ctx, ref_bind(cond.expr, batch.schema).eval_device(ctx))
    return ref_rowops.filter_batch(batch, pred.data & pred.validity)


def _ref_two_phase(batches, step, plan, hash_table=None):
    parts = [step(b) for b in batches]
    cat = ref_rowops.concat_batches(
        parts, ref_bucket(sum(p.capacity for p in parts)))
    merged = ref_agg.aggregate_merge(
        cat, plan.num_keys, [op for ops in plan.merge_plan for op in ops],
        plan.partial_schema, hash_table=hash_table)
    fin = plan.finalize_exprs()
    return ref_project(merged, [e for _, e in fin], [n for n, _ in fin])


def _ref_plan(schema, keys, results):
    grouping = [(k, ref_bind(RF.col(k).expr, schema)) for k in keys]
    return RefAggPlan(schema, grouping,
                      [(n, ref_bind_non_agg(c.expr, schema))
                       for n, c in results])


def _ref_step(plan, cond=None, hash_table=None):
    red = [op for ops in plan.update_plan for op in ops]
    kx = [e for _, e in plan.grouping]

    def step(batch):
        if cond is not None:
            batch = _ref_filter(batch, cond)
        return ref_agg.aggregate_update(batch, kx, plan.update_inputs, red,
                                        plan.partial_schema,
                                        hash_table=hash_table)
    return step


def _assert_same(got: pd.DataFrame, want: pd.DataFrame, keys):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    got = got.sort_values(keys).reset_index(drop=True) if keys else got
    want = want.sort_values(keys).reset_index(drop=True) if keys else want
    for c in got.columns:
        g, w = got[c], want[c]
        pd.testing.assert_series_equal(g.isna(), w.isna(), check_names=False)
        if pd.api.types.is_float_dtype(w.dtype):
            np.testing.assert_allclose(g.to_numpy(np.float64),
                                       w.to_numpy(np.float64),
                                       rtol=F64_RTOL, err_msg=c)
        else:
            assert list(g) == list(w), c


def test_q1_matches_reference(lineitem):
    refs = _ref_batches(lineitem, Q.Q1_COLUMNS)
    step, plan = ref_q1.q1_partial_step(refs[0].schema)
    want = _ref_two_phase(refs, step, plan).to_pandas()
    batches = Q.upload_batches(lineitem, Q.Q1_COLUMNS, BATCH, device="cpu")
    got = Q.q1_from_batches(batches).to_pandas()
    assert len(got) == 6
    _assert_same(got, want, ["l_returnflag", "l_linestatus"])


def test_q6_matches_reference(lineitem):
    refs = _ref_batches(lineitem, Q.Q6_COLUMNS)
    plan = _ref_plan(refs[0].schema, [], [
        ("revenue", RF.sum(RF.col("l_extendedprice") * RF.col("l_discount")))])
    cond = ((RF.col("l_shipdate") >= datetime.date(1994, 1, 1))
            & (RF.col("l_shipdate") < datetime.date(1995, 1, 1))
            & (RF.col("l_discount") >= 0.05) & (RF.col("l_discount") <= 0.07)
            & (RF.col("l_quantity") < 24.0))
    want = _ref_two_phase(refs, _ref_step(plan, cond), plan).to_pandas()
    got = Q.run_q6(lineitem, BATCH, device="cpu")
    _assert_same(got, want, [])
    assert got.revenue[0] > 0


def test_q18_groupby_matches_reference(lineitem):
    refs = _ref_batches(lineitem, Q.Q18_COLUMNS)
    plan = _ref_plan(refs[0].schema, ["l_orderkey"], [
        ("l_orderkey", RF.col("l_orderkey")),
        ("sum_qty", RF.sum("l_quantity"))])
    want = _ref_two_phase(refs, _ref_step(plan, hash_table=HASH_SLOTS),
                          plan, hash_table=HASH_SLOTS)
    want_having = _ref_filter(want, RF.col("sum_qty") > 300).to_pandas()
    batches = Q.upload_batches(lineitem, Q.Q18_COLUMNS, BATCH, device="cpu")
    grouped, having = Q.q18_agg_from_batches(batches)
    _assert_same(grouped.to_pandas(), want.to_pandas(), ["l_orderkey"])
    _assert_same(having.to_pandas(), want_having, ["l_orderkey"])


def test_entry_fn_matches_reference():
    step, (batch,) = Q.entry_fn(device="cpu")
    ref_step, (ref_batch,) = ref_q1.entry_fn()
    _assert_same(step(batch).to_pandas(), ref_step(ref_batch).to_pandas(),
                 ["l_returnflag", "l_linestatus"])


def test_query_runners_match_pandas(lineitem):
    df = lineitem
    q1 = Q.run_q1(df, BATCH, device="cpu")
    f = df[df.l_shipdate <= np.datetime64("1998-09-02")]
    want = f.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"), count_order=("l_quantity", "size"))
    got = q1.set_index(["l_returnflag", "l_linestatus"]).sort_index()
    np.testing.assert_allclose(got.sum_qty, want.sum_qty, rtol=F64_RTOL)
    assert list(got.count_order) == list(want.count_order)
    grouped = df.groupby("l_orderkey").l_quantity.sum()
    # scale the quantities up so that the having filter keeps some groups
    big = df.assign(l_quantity=df.l_quantity * 20)
    having = Q.run_q18_agg(big, BATCH, device="cpu")
    want_h = (grouped * 20)[grouped * 20 > 300]
    assert len(want_h) > 0
    got_h = having.set_index("l_orderkey").sum_qty.sort_index()
    assert list(got_h.index) == list(want_h.index)
    np.testing.assert_allclose(got_h, want_h, rtol=F64_RTOL)
