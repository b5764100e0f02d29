"""Scan + query wall seconds of chip_smoke.py's Parquet queries, for the
port of a given checkout, so that two checkouts compare on one card.

Runs Q1, Q6, Q3 and Q4 at SF10, the customer filter-and-collect at SF10
and the Q18 group-by at SF1 from the Parquet files of
``models/tpch_data.write_parquet`` (as ``chip_smoke.py`` writes them):
each query once to warm up, then ``--runs`` times, each run from the files
to the collect, synchronized. Prints one JSON line with each query's
median and runs, the scan's seconds apart, and each kernel's launches in
one run.

    python3 spark_rapids_tpu_torch/tools/scan_walls.py --data DIR --write
    python3 spark_rapids_tpu_torch/tools/scan_walls.py --data DIR [--root CHECKOUT]

``--write`` generates the tables and writes the files into ``--data``
(with the port of this checkout) and exits. ``--root`` imports the port
from another checkout (default: the one holding this file); run the file
by its path, not with ``-m``, so that nothing of the port is imported
before the root is chosen.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _wall(scan, query, runs: int) -> dict:
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.obs.metrics import REGISTRY, delta
    from spark_rapids_tpu_torch.ops import kernels as K
    walls, scans = [], []
    for i in range(runs + 1):
        if i == 1:
            before = REGISTRY.values()
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = scan()
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        query(tables)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del tables
        if i:
            walls.append(wall)
            scans.append(t_scan)
    # the scan's timers over the timed runs, per run: planning
    # thread-seconds, and the consumer's seconds in the device decode
    timers = {k.split(".")[-1]: v / runs for k, v in delta(
        before, REGISTRY.values()).items() if k.endswith("Time")}
    return {"wall_s": float(np.median(walls)), "wall_runs_s": walls,
            "scan_s": float(np.median(scans)), "timers_s": timers,
            "launches": dict(K.LAUNCHES)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="directory of the Parquet files")
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose port to import")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--write", action="store_true",
                    help="write the files and exit")
    ap.add_argument("--queries", default="",
                    help="comma-separated subset of the queries")
    args = ap.parse_args()
    if "spark_rapids_tpu_torch" in sys.modules:
        raise SystemExit("scan_walls: run this file by its path")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_walls: no CUDA device")
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.models import tpch_joins as J
    from spark_rapids_tpu_torch.models import tpch_scan as S
    sf10, sf1 = os.path.join(args.data, "sf10"), os.path.join(args.data, "sf1")
    if args.write:
        frames = {"lineitem": G.gen_lineitem(10), "orders": G.gen_orders(10),
                  "customer": G.gen_customer(10)}
        G.write_parquet(sf10, 10, frames=frames)
        del frames
        G.write_parquet(sf1, 1, tables=["lineitem"],
                        frames={"lineitem": G.gen_lineitem(1)})
        return
    paths = {t: os.path.join(sf10, f"{t}.parquet")
             for t in ("lineitem", "orders", "customer")}
    li1 = os.path.join(sf1, "lineitem.parquet")
    cases = {
        "q1_parquet": (lambda: S.scan_table(paths["lineitem"], Q.Q1_COLUMNS),
                       lambda t: Q.q1_from_batches(t).to_pandas()),
        "q6_parquet": (lambda: S.scan_table(paths["lineitem"], Q.Q6_COLUMNS),
                       lambda t: Q.q6_from_batches(t).to_pandas()),
        "q3_parquet": (lambda: S.scan_tables(paths, J.Q3_COLUMNS),
                       lambda t: J.q3_from_batches(t).to_pandas()),
        "q4_parquet": (lambda: S.scan_tables(paths, J.Q4_COLUMNS),
                       lambda t: J.q4_from_batches(t).to_pandas()),
        "customer_parquet": (
            lambda: S.scan_table(paths["customer"]),
            lambda t: S.customer_segment_batches(t).to_pandas()),
        "q18_groupby_parquet": (
            lambda: S.scan_table(li1, Q.Q18_COLUMNS),
            lambda t: [b.to_pandas() for b in Q.q18_agg_from_batches(t)]),
    }
    out = {"root": root}
    for name, (scan, query) in cases.items():
        if args.queries and name not in args.queries.split(","):
            continue
        out[name] = _wall(scan, query, args.runs)
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
