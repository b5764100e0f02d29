"""Where a query's time goes on the card: TPC-H Q1, Q6, Q3, Q4 and the Q18
group-by through the port's query runners under ``torch.profiler``, on
the pandas upload path and on the device Parquet scan.

For each query: upload its columns (or, for a ``*_parquet`` query, nothing:
the scan is part of the profiled run), run it once to warm up, then
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
the Q18 group-by at SF1 in 2^22-row batches; the Parquet files are
``models/tpch_data.write_parquet``'s, in
``spark_rapids_tpu_torch/build/tpch_parquet/`` (written when missing),
one batch per row group of 2^20 rows.
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
    ap.add_argument("--queries", nargs="+", choices=UPLOAD + PARQUET,
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
    from spark_rapids_tpu_torch.models import tpch_scan as S
    from spark_rapids_tpu_torch.models.tpch_data import (
        gen_customer, gen_lineitem, gen_orders,
    )
    want = set(args.queries or UPLOAD + PARQUET)
    tag = args.tag
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    results = []

    def run(name, fn):
        if name in want:
            results.append(profile(name + tag, fn, TOP, out_dir))

    sf10 = want - {"q18_groupby", "q18_groupby_parquet"}
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
        if sf10 & set(PARQUET):
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
        del frames, df
    if want & {"q18_groupby", "q18_groupby_parquet"}:
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
