"""Where a query's time goes on the card: TPC-H Q1, Q6, Q3, Q4 and the Q18
group-by through the port's query runners under ``torch.profiler``.

For each query: upload its columns, run it once to warm up, then profile
one run that ends in ``torch.cuda.synchronize()``. Prints, per query, the
wall seconds, the device busy seconds (the sum of the device-side kernel
and copy times), the idle share, and the top device-side events by time,
as one JSON line; writes a Chrome trace per query under ``chiprun_out/``.

    python3 -m spark_rapids_tpu_torch.tools.profile_queries

Sizes are chip_smoke.py's: Q1, Q6, Q3 and Q4 at SF10 in 2^23-row batches,
the Q18 group-by at SF1 in 2^22-row batches.
"""

from __future__ import annotations

import json
import os
import time

import torch

TOP = 12  # device-side events listed per query


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_queries: no CUDA device")
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch_joins as J
    from spark_rapids_tpu_torch.models.tpch_data import (
        gen_customer, gen_lineitem, gen_orders,
    )
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    results = []
    df = gen_lineitem(10)
    batches = Q.upload_batches(df, Q.Q1_COLUMNS, 1 << 23)
    results.append(profile("q1", lambda: Q.q1_from_batches(
        batches).to_pandas(), TOP, out_dir))
    batches = Q.upload_batches(df, Q.Q6_COLUMNS, 1 << 23)
    results.append(profile("q6", lambda: Q.q6_from_batches(
        batches).to_pandas(), TOP, out_dir))
    del batches
    frames = {"lineitem": df, "orders": gen_orders(10),
              "customer": gen_customer(10)}
    tables = J.upload_q3(frames)
    results.append(profile("q3", lambda: J.q3_from_batches(
        tables).to_pandas(), TOP, out_dir))
    tables = J.upload_q4(frames)
    results.append(profile("q4", lambda: J.q4_from_batches(
        tables).to_pandas(), TOP, out_dir))
    del tables, frames, df
    df = gen_lineitem(1)
    batches = Q.upload_batches(df, Q.Q18_COLUMNS, 1 << 22)
    results.append(profile("q18_groupby", lambda: [
        b.to_pandas() for b in Q.q18_agg_from_batches(batches)],
        TOP, out_dir))
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
