"""Where the time of one B1 or B7 call goes on the card.

For B1 ``compact_permutation`` at 2^23 and 2^20 rows (density 0.5) and at
its floor (8 rows), and for B7 ``plain_fixed`` (one float64 stream of 2^20
values, and its floor at 8) and, where the port has it,
``plain_fixed_many`` (five streams shaped as a lineitem row group's in Q1):

  * the wrapper's mean milliseconds over back-to-back calls (CUDA events);
  * the host's enqueue microseconds per call (host clock, no sync);
  * under ``torch.profiler``, each kernel a call launches, in order, with
    its mean device microseconds, the mean gap before the next kernel of
    the same call, and the mean gap from one call's last kernel to the
    next call's first (the Chrome trace's ``kernel`` events);
  * the PyTorch calls that compute the same function or a part of it:
    ``torch.cumsum`` of the mask (the scan alone) and the stable argsort
    of the negated mask (the whole permutation) for B1; a clone of the
    words viewed as the values for B7.

Prints one JSON object per shape and writes them, with the card's name and
power limit, to ``chiprun_out/profile_kernels.json`` (``--tag`` adds to the
name); the traces go to ``chiprun_out/trace_kernels_*.json``.

    python3 -m spark_rapids_tpu_torch.tools.profile_kernels
    python3 spark_rapids_tpu_torch/tools/profile_kernels.py --root CHECKOUT

``--root`` imports the port from another checkout (run the file by its
path, so that nothing of the port is imported before the root is chosen),
so that two checkouts compare on one card.
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

OUT_DIR = "chiprun_out"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _kernel_split(tag: str, fn, iters: int) -> dict:
    """Kernels of ``iters`` back-to-back calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, f"trace_kernels_{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    kern = sorted((e["ts"], e["dur"], e["name"])
                  for e in trace.get("traceEvents", [])
                  if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not kern or len(kern) % iters:
        return {"kernel_events": len(kern), "calls": iters,
                "split": "not measured: events do not divide into calls"}
    per = len(kern) // iters
    calls = [kern[i * per:(i + 1) * per] for i in range(iters)]
    steps = []
    for j in range(per):
        step = {"kernel": calls[0][j][2][:80],
                "device_us": float(np.mean([c[j][1] for c in calls]))}
        if j + 1 < per:
            step["gap_after_us"] = float(np.mean(
                [c[j + 1][0] - (c[j][0] + c[j][1]) for c in calls]))
        steps.append(step)
    between = [calls[i + 1][0][0] - (calls[i][-1][0] + calls[i][-1][1])
               for i in range(iters - 1)]
    span = [c[-1][0] + c[-1][1] - c[0][0] for c in calls]
    return {"kernels_per_call": per, "steps": steps,
            "call_span_us": float(np.mean(span)),
            "gap_between_calls_us": float(np.mean(between)) if between
            else None}


def profile_b1(n: int, gen: torch.Generator) -> dict:
    from spark_rapids_tpu_torch.ops import kernels as K
    keep = torch.rand(n, generator=gen, device="cuda") < 0.5
    perm, total = K.compact_permutation(keep)
    perm_p, total_p = K.compact_permutation_plain(keep)
    torch.cuda.synchronize()
    if not (torch.equal(perm, perm_p) and int(total) == int(total_p)):
        raise AssertionError(f"compact_permutation differs from plain, "
                             f"n={n}")
    iters = 200 if n <= 1 << 20 else 50
    rec = {"kernel": "compact_permutation", "rows": n, "density": 0.5,
           "ms": _event_ms(lambda: K.compact_permutation(keep), iters),
           "host_us": _host_us(lambda: K.compact_permutation(keep), iters),
           "cumsum_ms": _event_ms(
               lambda: torch.cumsum(keep, 0, dtype=torch.int32), iters),
           "argsort_ms": _event_ms(
               lambda: torch.argsort((~keep).to(torch.uint8), stable=True),
               iters),
           # read the mask once (1 B a row), write perm once (4 B a row)
           "bound_ms": (n * 5 + 4) / 3.35e12 * 1e3}
    rec.update(_kernel_split(f"b1_{n}",
                             lambda: K.compact_permutation(keep), 20))
    return rec


def profile_b7(gen: torch.Generator) -> list:
    from spark_rapids_tpu_torch.ops import kernels as K
    n = 1 << 20
    words = torch.randint(-(1 << 31), 1 << 31, (2 * n + 2,), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    out = []
    for m in (n, 8):
        rec = {"kernel": "plain_fixed", "kind": "f64", "values": m,
               "ms": _event_ms(lambda: K.plain_fixed(words, "f64", m), 200),
               "host_us": _host_us(lambda: K.plain_fixed(words, "f64", m),
                                   200),
               "clone_ms": _event_ms(
                   lambda: words.view(torch.float64)[:m].clone(), 200),
               "bound_ms": 16 * m / 3.35e12 * 1e3}
        rec.update(_kernel_split(f"b7_{m}",
                                 lambda: K.plain_fixed(words, "f64", m), 20))
        out.append(rec)
    if hasattr(K, "plain_fixed_many"):
        # a Q1 row group's PLAIN fixed streams: l_extendedprice's values
        # and the dictionary pages of l_quantity, l_discount, l_tax and
        # l_shipdate
        streams = [(words, "f64", n), (words[:102], "f64", 50),
                   (words[:24], "f64", 11), (words[:20], "f64", 9),
                   (words[:2530], "i32", 2526)]
        rec = {"kernel": "plain_fixed_many", "segments": len(streams),
               "ms": _event_ms(lambda: K.plain_fixed_many(streams), 200),
               "host_us": _host_us(lambda: K.plain_fixed_many(streams), 200),
               "clones_ms": _event_ms(lambda: [
                   w.view(torch.float64 if k == "f64" else torch.int32)[:m]
                   .clone() for w, k, m in streams], 200)}
        rec.update(_kernel_split("b7_many",
                                 lambda: K.plain_fixed_many(streams), 20))
        out.append(rec)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose port to import")
    ap.add_argument("--tag", default="", help="suffix of the output name")
    args = ap.parse_args()
    if args.root:
        if "spark_rapids_tpu_torch" in sys.modules:
            raise SystemExit("profile_kernels: run this file by its path "
                             "to choose --root")
        sys.path.insert(0, os.path.abspath(args.root))
    elif "spark_rapids_tpu_torch" not in sys.modules:
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    from spark_rapids_tpu_torch.ops import cudalib
    os.makedirs(OUT_DIR, exist_ok=True)
    cudalib.build(["compact", "parquet_decode"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    records = [profile_b1(n, gen) for n in (1 << 23, 1 << 20, 8)]
    records += profile_b7(gen)
    for r in records:
        print(json.dumps(r))
    card = _card()
    print(card)
    name = f"profile_kernels{args.tag}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump({"card": card, "root": args.root or "", "records": records},
                  f, indent=1)


if __name__ == "__main__":
    main()
