"""Where a query's time goes on the card: TPC-H Q1, Q6, Q3, Q4 and the Q18
group-by through the port's query runners under ``torch.profiler``, on
the pandas upload path and on the device Parquet scan, and the session's
cells: Q3 and Q4 through ``TpuSparkSession`` over cached uploads
(``session_q3``, ``session_q4``), the Parquet queries through its
``read.parquet`` with the device decode (``session_*_parquet``), and the
cells of the sorted grouping branches at the JAX package's default confs
over cached uploads (``DEFAULT_CONFS``: Q3, Q10, Q17, Q18, Q21, the
row-space lineitem group-by, the customer string group-by and the Q18
group-by), and the 14 queries of the expression and cross-join slice at
the same confs (``TPCH_NEW``: Q2, Q5, Q7, Q8, Q9, Q11, Q12, Q13, Q14, Q15,
Q16, Q19, Q20 and Q22 at SF10, Q20's and Q22's frames changed as
``testing/tpchcases.py`` changes them, the scan cache cleared after each;
``session_q9_parquet``: Q9 from SF1 files), the four Mortgage queries at
SF 500 at the same confs in 2^20-row batches (``MORTGAGE``), and the
window stage over 2^23 rows (``WINDOW``: ``testing/windowcases.py``'s
row_number, cumulative_sum and bounded_range_frame cases).

For each query: upload its columns (or, for a ``*_parquet`` query, nothing:
the scan is part of the profiled run; a session query uploads into its
scan cache in the warm-up run), run it once to warm up, then
profile one run that ends in ``torch.cuda.synchronize()``. Prints, per
query, the wall seconds, the device busy seconds (the sum of the
device-side kernel and copy times), the idle share, and the top
device-side events by time, as one JSON line; writes a Chrome trace per
query under ``chiprun_out/``.

    python3 -m spark_rapids_tpu_torch.tools.profile_queries
    python3 spark_rapids_tpu_torch/tools/profile_queries.py --root CHECKOUT \
        --queries q3 q4 q18_groupby --tag _x

``--queries`` profiles those alone; ``--root`` imports the port from
another checkout (run the file by its path), so that two checkouts compare
on one card; ``--tag`` adds to the trace and output names, and the records
also go to ``chiprun_out/profile_queries<tag>.json`` with the card's name
and power limit.

Sizes are chip_smoke.py's: Q1, Q6, Q3 and Q4 at SF10 in 2^23-row batches,
the Q18 group-by at SF1 in 2^22-row batches (2^23 through the session);
the Parquet files are
``models/tpch_data.write_parquet``'s, in
``spark_rapids_tpu_torch/build/tpch_parquet/`` (written when missing),
one batch per row group of 2^20 rows for the runners, row groups packed
and concatenated into 2^23-row batches through the session.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

TOP = 12  # device-side events listed per query
UPLOAD = ("q1", "q6", "q3", "q4", "q18_groupby")
PARQUET = ("q1_parquet", "q6_parquet", "q3_parquet", "q4_parquet",
           "customer_parquet", "q18_groupby_parquet")
SESSION = ("session_q3", "session_q4", "session_q1_parquet",
           "session_q6_parquet", "session_q3_parquet", "session_q4_parquet",
           "session_customer_parquet", "session_q18_groupby_parquet")
# the session at the JAX package's default confs (the sorted grouping
# branches): cached uploads, SF10 but the Q18 group-by (SF1)
DEFAULT_CONFS = ("session_q3_default", "session_q10", "session_q17",
                 "session_q18", "session_q21", "session_rowspace_groupby",
                 "session_strings_groupby", "session_q18_groupby_default")
# the 14 queries of the expression and cross-join slice at the same confs
TPCH_NEW = tuple(f"session_{q}" for q in (
    "q2", "q5", "q7", "q8", "q9", "q11", "q12", "q13", "q14", "q15", "q16",
    "q19", "q20", "q22")) + ("session_q9_parquet",)
# the Mortgage queries at SF 500 and the window stage over 2^23 rows
MORTGAGE = tuple(f"session_mortgage_{q}" for q in (
    "etl", "simple_aggregates", "aggregates_with_join",
    "aggregates_with_percentiles"))
WINDOW = tuple(f"session_window_{c}" for c in (
    "row_number", "cumulative_sum", "bounded_range_frame"))
ALL = UPLOAD + PARQUET + SESSION + DEFAULT_CONFS + TPCH_NEW + MORTGAGE \
    + WINDOW


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(name: str, fn, top: int, out_dir: str) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()  # warm-up: kernel libraries load, the allocator fills
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    # device-side events only (kernels, copies): the host-side operator
    # that launched a kernel reports the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    events.sort(key=_device_us, reverse=True)
    return {"query": name, "wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"op": e.key[:100], "calls": e.count,
                     "device_ms": _device_us(e) / 1e3} for e in events[:top]]}


# the session cells' confs beside the hash-aggregation ones: no scan
# cache (every run decodes the files)
PARQUET_SESSION = {"spark.rapids.sql.cacheDeviceScans": False}


def session(batch_rows: int, conf: dict, hash_agg: bool = True):
    """The port's session on the card as ``chip_smoke.py`` runs it: test
    mode, the hash-aggregation confs (unless ``hash_agg`` is False: the
    JAX package's defaults), ``batch_rows``-row batches."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = (TpuSparkSession.builder()
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.batchSizeRows", batch_rows))
    for k, v in dict(T.HASH_AGG_CONFS if hash_agg else {}, **conf).items():
        b.config(k, v)
    return b.get_or_create()


def _q18_lineitem(df, orders):
    """Q18's lineitem as ``chip_smoke.py`` makes it: l_orderkey and
    l_quantity with ten 45-unit lines for each of four orders."""
    import numpy as np
    import pandas as pd
    keys = orders.o_orderkey.to_numpy()[[3, 77, 500, 1234]]
    return pd.concat([df[["l_orderkey", "l_quantity"]], pd.DataFrame({
        "l_orderkey": np.repeat(keys, 10),
        "l_quantity": np.full(40, 45.0)})], ignore_index=True)


def _parquet_files(G, tag: str, sf: float, frames: dict, tables=None):
    """{table: path} of the scale factor's Parquet files, written from
    ``frames`` unless a file is there already."""
    d = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build",
                     "tpch_parquet", tag)
    names = tables or list(G.GENERATORS)
    paths = {t: os.path.join(d, f"{t}.parquet") for t in names}
    missing = [t for t in names if not os.path.exists(paths[t])]
    if missing:
        G.write_parquet(d, sf, tables=missing, frames=frames)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", nargs="+",
                    choices=ALL,
                    help="profile these queries alone (default: all)")
    ap.add_argument("--root", help="checkout whose port to import")
    ap.add_argument("--tag", default="", help="suffix of the output names")
    args = ap.parse_args()
    if args.root:
        if "spark_rapids_tpu_torch" in sys.modules:
            raise SystemExit("profile_queries: run this file by its path "
                             "to choose --root")
        sys.path.insert(0, os.path.abspath(args.root))
    elif "spark_rapids_tpu_torch" not in sys.modules:
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    if not torch.cuda.is_available():
        raise SystemExit("profile_queries: no CUDA device")
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.models import tpch_joins as J
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_scan as S
    from spark_rapids_tpu_torch.models.tpch_data import (
        gen_customer, gen_lineitem, gen_orders,
    )
    want = set(args.queries or ALL)
    tag = args.tag
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    results = []

    def run(name, fn):
        if name in want:
            results.append(profile(name + tag, fn, TOP, out_dir))

    q18 = {"q18_groupby", "q18_groupby_parquet",
           "session_q18_groupby_parquet", "session_q18_groupby_default",
           "session_q9_parquet"}
    sf10 = want - q18 - set(MORTGAGE) - set(WINDOW)
    if sf10:
        df = gen_lineitem(10)
        for name, cols, query in (("q1", Q.Q1_COLUMNS, Q.q1_from_batches),
                                  ("q6", Q.Q6_COLUMNS, Q.q6_from_batches)):
            if name in want:
                batches = Q.upload_batches(df, cols, 1 << 23)
                run(name, lambda: query(batches).to_pandas())
                del batches
        frames = {"lineitem": df, "orders": gen_orders(10),
                  "customer": gen_customer(10)}
        if "q3" in want:
            tables = J.upload_q3(frames)
            run("q3", lambda: J.q3_from_batches(tables).to_pandas())
        if "q4" in want:
            tables = J.upload_q4(frames)
            run("q4", lambda: J.q4_from_batches(tables).to_pandas())
        tables = None
        if want & {"session_q3", "session_q4"}:
            sess = session(1 << 23, {"spark.rapids.sql.cacheDeviceScans":
                                     True})
            t = {n: sess.create_dataframe(f) for n, f in frames.items()}
            run("session_q3", T.q3(sess, t).collect)
            run("session_q4", T.q4(sess, t).collect)
            del sess, t
        if want & set(DEFAULT_CONFS):
            from spark_rapids_tpu_torch.sql import functions as F
            sess = session(1 << 23, {"spark.rapids.sql.cacheDeviceScans":
                                     True}, hash_agg=False)
            t = {n: sess.create_dataframe(f) for n, f in frames.items()}
            t.update({"supplier": sess.create_dataframe(G.gen_supplier(10)),
                      "part": sess.create_dataframe(G.gen_part(10)),
                      "nation": sess.create_dataframe(G.gen_nation())})
            t18 = dict(t, lineitem=sess.create_dataframe(
                _q18_lineitem(df, frames["orders"])))
            run("session_q3_default", T.q3(sess, t).collect)
            for name in ("q10", "q17", "q21"):
                run(f"session_{name}", T.QUERIES[name](sess, t).collect)
            run("session_q18", T.q18(sess, t18).collect)
            run("session_rowspace_groupby", t["lineitem"].group_by(
                "l_returnflag", "l_linestatus", "l_quantity", "l_discount")
                .agg(F.sum("l_extendedprice").alias("sum_price"),
                     F.count("*").alias("n")).collect)
            run("session_strings_groupby", t["customer"]
                .group_by("c_nationkey")
                .agg(F.min("c_name").alias("min_name"),
                     F.max("c_phone").alias("max_phone"),
                     F.first("c_mktsegment").alias("first_seg"),
                     F.count("c_phone").alias("n")).collect)
            del sess, t, t18
        if want & set(TPCH_NEW[:-1]):
            from spark_rapids_tpu_torch.testing import tpchcases
            sess = session(1 << 23, {"spark.rapids.sql.cacheDeviceScans":
                                     True}, hash_agg=False)
            everything = dict(frames, **{
                n: f(10) for n, f in G.ALL_TABLES.items()
                if n not in frames})
            for name in TPCH_NEW[:-1]:
                if name not in want:
                    continue
                qname = name.removeprefix("session_")
                fr = tpchcases.query_frames(qname, everything)
                t = {n: sess.create_dataframe(f) for n, f in fr.items()}
                run(name, T.QUERIES[qname](sess, t).collect)
                sess.clear_device_cache()
                torch.cuda.empty_cache()
            del sess, t, everything
        if sf10 & {n for n in PARQUET + SESSION if n.endswith("_parquet")}:
            paths = _parquet_files(G, "sf10", 10, frames)
            run("q1_parquet", lambda: Q.q1_from_batches(
                S.scan_table(paths["lineitem"], Q.Q1_COLUMNS)).to_pandas())
            run("q6_parquet", lambda: Q.q6_from_batches(
                S.scan_table(paths["lineitem"], Q.Q6_COLUMNS)).to_pandas())
            run("q3_parquet", lambda: J.q3_from_batches(
                S.scan_tables(paths, J.Q3_COLUMNS)).to_pandas())
            run("q4_parquet", lambda: J.q4_from_batches(
                S.scan_tables(paths, J.Q4_COLUMNS)).to_pandas())
            run("customer_parquet", lambda: (
                S.customer_segment_collect(paths["customer"])))
            sess = session(1 << 23, PARQUET_SESSION)
            t = {n: sess.read.parquet(p) for n, p in paths.items()}
            for name, query in (("q1", T.q1), ("q6", T.q6), ("q3", T.q3),
                                ("q4", T.q4),
                                ("customer", T.customer_segment)):
                run(f"session_{name}_parquet", query(sess, t).collect)
            del sess, t
        del frames, df
    if want & q18:
        df = gen_lineitem(1)
        if "q18_groupby" in want:
            batches = Q.upload_batches(df, Q.Q18_COLUMNS, 1 << 22)
            run("q18_groupby", lambda: [
                b.to_pandas() for b in Q.q18_agg_from_batches(batches)])
            del batches
        if "q18_groupby_parquet" in want:
            path18 = _parquet_files(G, "sf1", 1, {"lineitem": df},
                                    ["lineitem"])["lineitem"]
            run("q18_groupby_parquet", lambda: [
                b.to_pandas() for b in Q.q18_agg_from_batches(
                    S.scan_table(path18, Q.Q18_COLUMNS))])
        if "session_q18_groupby_default" in want:
            sess = session(1 << 22, {"spark.rapids.sql.cacheDeviceScans":
                                     True}, hash_agg=False)
            run("session_q18_groupby_default", T.q18_groupby(
                sess, {"lineitem": sess.create_dataframe(df)}).collect)
            del sess
        if "session_q18_groupby_parquet" in want:
            path18 = _parquet_files(G, "sf1", 1, {"lineitem": df},
                                    ["lineitem"])["lineitem"]
            sess = session(1 << 23, PARQUET_SESSION)
            run("session_q18_groupby_parquet", T.q18_groupby(
                sess, {"lineitem": sess.read.parquet(path18)}).collect)
        if "session_q9_parquet" in want:
            names = ["lineitem", "orders", "part", "partsupp", "supplier",
                     "nation"]
            frames = {n: df if n == "lineitem" else G.ALL_TABLES[n](1)
                      for n in names}
            paths = _parquet_files(G, "sf1", 1, frames, names)
            sess = session(1 << 23, PARQUET_SESSION, hash_agg=False)
            run("session_q9_parquet", T.q9(
                sess, {n: sess.read.parquet(p)
                       for n, p in paths.items()}).collect)
    if want & set(MORTGAGE):
        from spark_rapids_tpu_torch.models import mortgage as M
        from spark_rapids_tpu_torch.models import mortgage_data as MD
        perf, acq = MD.gen_performance(500), MD.gen_acquisition(500)
        sess = session(1 << 20, dict(M.ETL_CONFS, **{
            "spark.rapids.sql.cacheDeviceScans": True}), hash_agg=False)
        p, a = sess.create_dataframe(perf), sess.create_dataframe(acq)
        for name in MORTGAGE:
            run(name, M.run_query(name.removeprefix("session_mortgage_"),
                                  sess, p, a).collect)
        del sess, p, a, perf, acq
        torch.cuda.empty_cache()
    if want & set(WINDOW):
        from spark_rapids_tpu_torch.sql import functions as F
        from spark_rapids_tpu_torch.sql.window import Window
        from spark_rapids_tpu_torch.testing import windowcases as WC
        sess = session(1 << 23, {"spark.rapids.sql.cacheDeviceScans": True},
                       hash_agg=False)
        for name in WINDOW:
            extra, query, _approx = WC.CASES[name.removeprefix(
                "session_window_")]
            d = sess.create_dataframe(WC.frame(extra, n=1 << 23))
            run(name, query(F, Window, d).collect_batches)
        del sess
    for r in results:
        print(json.dumps(r))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    with open(os.path.join(out_dir, f"profile_queries{tag}.json"), "w") as f:
        json.dump({"card": card, "root": args.root or "",
                   "records": results}, f, indent=1)


if __name__ == "__main__":
    main()
