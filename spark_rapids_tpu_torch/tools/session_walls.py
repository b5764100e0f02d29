"""Warm walls of the session's upload-path queries, for comparing two
checkouts on one card: Q1 and Q6 at SF10 (2^23-row batches), Q4 at SF10
(2^23-row batches, ``tpch.HASH_AGG_CONFS``, shuffled joins), the Q18
group-by at SF1 (2^22-row batches, ``tpch.HASH_AGG_CONFS``) and the
Mortgage ``aggregates_with_join`` at SF 500 (2^20-row batches,
``mortgage.ETL_CONFS``), each through ``TpuSparkSession`` in test mode
with cached device scans, as ``chip_smoke.py`` runs them. Each query runs
once cold (the upload), then ``--runs`` times, synchronized; prints one
JSON line per query with the median, every run, and the warm runs' peak
device bytes past what was allocated before them, then the card's name
and power limit.

    python3 spark_rapids_tpu_torch/tools/session_walls.py --root CHECKOUT \
        [--queries q1 q6 q4 q18_groupby mortgage_aggregates_with_join]

``--root`` imports the port from another checkout (run this file by its
path); alternate the checkouts in one call (parent, tree, tree, parent):
walls move with the host between processes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


QUERIES = ("q1", "q6", "q4", "q18_groupby",
           "mortgage_aggregates_with_join")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose port to import")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", nargs="+", choices=QUERIES,
                    default=list(QUERIES))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root) if args.root
                    else str(Path(__file__).resolve().parents[2]))
    if not torch.cuda.is_available():
        raise SystemExit("session_walls: no CUDA device")
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.session import TpuSparkSession

    def session(batch_rows: int, **conf):
        b = (TpuSparkSession.builder()
             .config("spark.rapids.sql.test.enabled", True)
             .config("spark.rapids.sql.cacheDeviceScans", True)
             .config("spark.rapids.sql.batchSizeRows", batch_rows))
        for k, v in conf.items():
            b.config(k, v)
        return b.get_or_create()

    def timed(name: str, df, sf) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(args.runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df.collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls = walls[1:]
        print(json.dumps({"query": name, "sf": sf, "root": args.root or "",
                          "wall_s": float(np.median(walls)),
                          "wall_runs_s": walls, "cold_s": cold,
                          "peak_bytes": torch.cuda.max_memory_allocated()
                          - base}),
              flush=True)

    want = set(args.queries)
    if want & {"q1", "q6", "q4"}:
        df = G.gen_lineitem(10)
        if want & {"q1", "q6"}:
            s = session(1 << 23)
            t = {"lineitem": s.create_dataframe(df)}
            for q in ("q1", "q6"):
                if q in want:
                    timed(f"session_{q}", getattr(T, q)(s, t), 10)
            del s, t
            torch.cuda.empty_cache()
        if "q4" in want:
            s = session(1 << 23, **T.HASH_AGG_CONFS)
            t = {"lineitem": s.create_dataframe(df),
                 "orders": s.create_dataframe(G.gen_orders(10))}
            timed("session_q4", T.q4(s, t), 10)
            del s, t
            torch.cuda.empty_cache()
        del df
    if "q18_groupby" in want:
        df = G.gen_lineitem(1)
        s = session(1 << 22, **T.HASH_AGG_CONFS)
        timed("session_q18_groupby",
              T.q18_groupby(s, {"lineitem": s.create_dataframe(df)}), 1)
        del s, df
        torch.cuda.empty_cache()
    if "mortgage_aggregates_with_join" in want:
        from spark_rapids_tpu_torch.models import mortgage as M
        from spark_rapids_tpu_torch.models import mortgage_data as MD
        perf, acq = MD.gen_performance(500), MD.gen_acquisition(500)
        s = session(1 << 20, **M.ETL_CONFS)
        timed("session_mortgage_aggregates_with_join",
              M.run_query("aggregates_with_join", s,
                          s.create_dataframe(perf),
                          s.create_dataframe(acq)), 500)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
