"""Where the time of one kernel call goes on the card.

For B1 ``compact_permutation`` at 2^23 and 2^20 rows (density 0.5) and at
its floor (8 rows); for B7 ``plain_fixed`` (one float64 stream of 2^20
values, and its floor at 8) and ``plain_fixed_many`` (five streams shaped
as a lineitem row group's in Q1); for B3 ``hash_table_build`` at Q3's
lineitem build shape (2^26 rows of capacity, the first 60M live, 53.7% of
those valid, l_orderkey-like keys, T = 2^27) with k = 1 and k = 3 key
words (the claim on the key word and on a state word); for B2
``hash_grouped_aggregate`` at the Q18 partial shape (2^22 rows, k = 2,
one float64 sum, T = 2^23); for B4 ``hash_table_probe`` and
``hash_join_lookup`` (B4 with each probe row's match count and first
``bperm`` position) at Q3's probe shape (2^23 o_orderkey-like probes,
multiples of 4, against the k = 1 table of that build); and for B5
``hybrid_expand`` on
the level and dictionary-code streams of a Q1 lineitem row group (2^20
rows, written as Parquet with ``tpch_data.PARQUET_SPEC`` into the ignored
``build/profile_parquet/`` and uploaded as the scan uploads it), one
stream a call and, where the port has it, all in one ``hybrid_expand_many``
call; and for B6 ``delta_unpack`` on the l_orderkey chunk of a lineitem
row group (2^20 values) and on the two DELTA chunks of an orders row group
(o_orderkey, o_custkey), one call a chunk and, where the port has it, both
in one ``delta_unpack_many`` call, beside the host microseconds of the
wrapper's scratch and output allocations alone:

  * the wrapper's mean milliseconds over back-to-back calls (CUDA events);
  * the host's enqueue microseconds per call (host clock, no sync);
  * under ``torch.profiler``, each kernel, copy and fill a call runs on
    the card, in order, with its mean device microseconds, the mean gap
    before the next one of the same call, and the mean gap from one call's
    last to the next call's first (the Chrome trace's ``kernel``,
    ``gpu_memcpy`` and ``gpu_memset`` events);
  * the PyTorch calls that compute the same function or a part of it:
    ``torch.cumsum`` of the mask (the scan alone) and the stable argsort
    of the negated mask (the whole permutation) for B1; a clone of the
    words viewed as the values for B7. B2-B5 have none.

Prints one JSON object per shape and writes them, with the card's name and
power limit, to ``chiprun_out/profile_kernels.json`` (``--tag`` adds to the
name); the traces go to ``chiprun_out/trace_kernels_*.json`` (with the
tag too).

    python3 -m spark_rapids_tpu_torch.tools.profile_kernels
    python3 spark_rapids_tpu_torch/tools/profile_kernels.py --root CHECKOUT
    python3 -m spark_rapids_tpu_torch.tools.profile_kernels --only b2 b4
    python3 -m spark_rapids_tpu_torch.tools.profile_kernels --only b6

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
PROFILES = ("b1", "b7", "b3", "b2", "b4", "b5", "b6")
# the --tag of this run, which its trace files carry too
_trace_tag = ""
# the Chrome trace's device events: kernels, and copies and fills, which
# run on the card between kernels without being kernels
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)


def bound_ms(nbytes: float) -> float:
    """The least milliseconds the card takes to move ``nbytes`` (also the
    bound of ``chip_smoke.py``)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


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
    """Device events of ``iters`` back-to-back calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, f"trace_kernels_{tag}{_trace_tag}.json")
    prof.export_chrome_trace(path)
    return trace_split(path, iters)


def trace_split(path: str, iters: int) -> dict:
    """The per-call split of a Chrome trace of ``iters`` calls: its device
    events (kernels, copies and fills) in order."""
    with open(path) as f:
        trace = json.load(f)
    kern = sorted((e["ts"], e["dur"], e["name"])
                  for e in trace.get("traceEvents", [])
                  if e.get("cat") in DEVICE_EVENTS and e.get("ph") == "X")
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
           "bound_ms": bound_ms(n * 5 + 4)}
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
               "bound_ms": bound_ms(16 * m)}
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


def _timed(tag: str, fn, iters: int) -> dict:
    """Wrapper ms (CUDA events), host enqueue µs and the kernel split of
    ``fn``."""
    rec = {"ms": _event_ms(fn, iters), "host_us": _host_us(fn, iters)}
    rec.update(_kernel_split(tag, fn, min(iters, 20)))
    return rec


def b3_inputs(gen: torch.Generator, k: int, cap: int = 1 << 26,
              live: int = 60_000_000):
    """Q3's lineitem build: ``cap`` rows of capacity, the first ``live``
    live, 53.7% of those valid (l_shipdate > 1995-03-15), l_orderkey-like
    keys in [1, 4 * live / 4); k > 1 adds words derived from the key, so
    the distinct keys stay the same."""
    key = torch.randint(1, live, (cap,), generator=gen, device="cuda")
    valid = ((torch.arange(cap, device="cuda") < live)
             & (torch.rand(cap, generator=gen, device="cuda") < 0.537))
    images = [key ^ -(1 << 63), key >> 2, key & 3][:k]
    return images, valid


def profile_b3(gen: torch.Generator) -> list:
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.testing import hashcheck
    out = []
    for k in (1, 3):
        images, valid = b3_inputs(gen, k)
        cap = valid.shape[0]
        T = K.hash_table_size(cap)
        slot, _r, table, counts = K.hash_table_build(images, valid, T)
        hashcheck.check_build(images, valid, slot, table, counts)
        nvalid = int(valid.sum())
        rec = {"kernel": "hash_table_build", "k": k, "rows": cap,
               "valid_rows": nvalid, "keys": int((counts > 0).sum()),
               "table": T,
               # keys and the valid byte read once, the slot written once,
               # the table words and counts initialised once, two random
               # 32 B sectors per valid row (its key word and its count)
               "bound_ms": bound_ms(cap * (8 * k + 1) + cap * 4
                                     + T * (8 * k + 4) + nvalid * 2 * 32)}
        del slot, table, counts
        rec.update(_timed(f"b3_k{k}", lambda: K.hash_table_build(
            images, valid, T), 5))
        out.append(rec)
        del images, valid
        torch.cuda.empty_cache()
    return out


def b2_bound_bytes(rows: int, live: int, k: int, job_bytes, T: int) -> dict:
    """Bytes B2 must move for ``rows`` rows (``live`` of them live), k key
    words and jobs whose values are ``job_bytes`` wide: each input read once
    (the key words and the live byte, each job's value and eligible byte),
    each T-wide output written once (count, rep, each job's accumulator and
    eligible count), and per live row the random 32 B sectors of one record
    holding everything the row updates (its key words, count, rep, each
    job's accumulator and eligible count). ``old``: the earlier count, one
    sector for the claim state with the key words, then one each for
    count, rep and each job's accumulator and eligible count, as when each
    lay in an array of its own."""
    nj = len(job_bytes)
    once = (rows * (8 * k + 1) + sum(rows * (b + 1) for b in job_bytes)
            + T * (4 + 4 + sum(b + 4 for b in job_bytes)))
    record = 8 * k + 4 + 4 + sum(b + 4 for b in job_bytes)
    return {"bytes": once + live * -(-record // 32) * 32,
            "old": once + live * (1 + 2 + 2 * nj) * 32}


def profile_b2(gen: torch.Generator) -> dict:
    """B2 at the Q18 partial shape of ``chip_smoke.py``."""
    from spark_rapids_tpu_torch.ops import kernels as K
    m = 1 << 22
    T = K.hash_table_size(m)
    okey = torch.randint(1, 6_000_000, (m,), generator=gen, device="cuda")
    images = [okey ^ -(1 << 63), torch.ones(m, dtype=torch.int64,
                                            device="cuda")]
    live = torch.ones(m, dtype=torch.bool, device="cuda")
    qty = torch.randint(1, 51, (m,), generator=gen,
                        device="cuda").to(torch.float64)
    jobs = [("sum", qty, live)]
    nbytes = b2_bound_bytes(m, m, 2, [8], T)
    rec = {"kernel": "hash_grouped_aggregate", "rows": m, "k": 2,
           "table": T, "bound_ms": bound_ms(nbytes["bytes"]),
           "old_bound_ms": bound_ms(nbytes["old"])}
    rec.update(_timed("b2", lambda: K.hash_grouped_aggregate(
        images, live, jobs, T), 20))
    return rec


def probe_inputs(gen: torch.Generator, n: int = 1 << 23,
                 orders: int = 15_000_000):
    """Q3's probe: ``n`` o_orderkey-like keys (multiples of 4 up to 4 *
    ``orders``), all valid."""
    skey = 4 * torch.randint(1, orders + 1, (n,), generator=gen,
                             device="cuda")
    return [skey ^ -(1 << 63)], torch.ones(n, dtype=torch.bool,
                                           device="cuda")


def lookup_bound_bytes(n: int, nvalid: int, hits: int, k: int = 1) -> int:
    """Bytes ``hash_join_lookup`` must move: the keys and the valid byte
    read once, two int32 outputs written once, one random 32 B sector per
    valid row (its key word), and per hit its count and its start, each a
    random sector."""
    return n * (8 * k + 1) + n * 8 + nvalid * 32 + hits * 2 * 32


def profile_b4(gen: torch.Generator) -> list:
    """B4 ``hash_table_probe`` and ``hash_join_lookup`` at Q3's probe shape:
    ``probe_inputs`` against the B3 table of Q3's lineitem build
    (``b3_inputs`` with k = 1, as ``chip_smoke.check_hash_join`` builds
    it)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    images, valid = b3_inputs(gen, 1)
    T = K.hash_table_size(valid.shape[0])
    jt = K.hash_join_build(images, valid, T)
    del images, valid
    simg, sv = probe_inputs(gen)
    n = sv.shape[0]
    slot = K.hash_table_probe(jt.table, jt.counts, simg, sv, T)
    want = K.hash_table_probe_plain(jt.table, jt.counts, simg, sv, T)
    hit = slot < T
    if not (torch.equal(hit, want < T) and torch.equal(
            jt.table[0][slot[hit].long()], simg[0][hit])):
        raise AssertionError("hash_table_probe differs from plain")
    got = K.hash_join_lookup(jt, simg, sv)
    for g, w in zip(got, K._lookup(want, jt.counts, jt.starts)):
        if not torch.equal(g, w):
            raise AssertionError("hash_join_lookup differs from plain")
    hits = int(hit.sum())
    del slot, want, got
    # keys and valid read once, the slot written once, one random 32 B
    # sector per valid row
    b4 = {"kernel": "hash_table_probe", "rows": n, "hits": hits, "table": T,
          "bound_ms": bound_ms(n * (8 + 1) + n * 4 + n * 32)}
    b4.update(_timed("b4", lambda: K.hash_table_probe(
        jt.table, jt.counts, simg, sv, T), 20))
    nbytes = lookup_bound_bytes(n, n, hits)
    lookup = {"kernel": "hash_join_lookup", "rows": n, "hits": hits,
              "table": T, "bound_bytes": nbytes, "bound_ms": bound_ms(nbytes)}
    lookup.update(_timed("lookup", lambda: K.hash_join_lookup(jt, simg, sv),
                         20))
    return [b4, lookup]


def q1_hybrid_streams(out_dir: Path) -> list:
    """[(name, (words, out_start, kind, value, bit_start, bw, n))] of row
    group 0 of a Q1 lineitem file, the streams ``decode_rowgroup`` expands
    (``parquet_decode.hybrid_streams``), on the card in one
    ``upload_arrays`` buffer."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    from spark_rapids_tpu_torch.sql.sources import ParquetSource
    path = G.write_parquet(str(out_dir), 0.18, tables=["lineitem"],
                           frames={"lineitem": G.gen_lineitem(0.18)}
                           )["lineitem"]
    dts = {c: ParquetSource(path).schema.dtype_of(c) for c in Q.Q1_COLUMNS}
    raw = PD.prepare_rowgroup(path, 0, Q.Q1_COLUMNS, dts,
                              upload_blocked_chars())
    tree = {name: PD._device_upload(p) for name, p in raw.plans.items()}
    dev_tree = PD.upload_arrays(tree, "cuda")
    cap = bucket_capacity(max(raw.n, 1))
    if hasattr(PD, "hybrid_streams"):
        return [(f"{col}.{'levels' if part == 'lv' else 'codes'}", args)
                for (col, part), args in PD.hybrid_streams(raw.plans,
                                                           dev_tree, cap)]
    # a checkout from before hybrid_streams (--root): the same selection
    fields = ("words", "out_start", "kind", "value", "bit_start", "bw")
    streams = []
    for name, plan in raw.plans.items():
        up, meta = dev_tree[name], plan["meta"]
        if meta["max_def"] > 0 and "lv_words" in up:
            streams.append((f"{name}.levels",
                            tuple(up[f"lv_{f}"] for f in fields) + (cap,)))
        if plan["kind"] in ("bool", "fixed_dict", "str_dict"):
            nv = bucket_capacity(max(meta["nn"], 1))
            streams.append((f"{name}.codes",
                            tuple(up[f"cd_{f}"] for f in fields) + (nv,)))
    return streams


def profile_b5(out_dir: Path) -> list:
    from spark_rapids_tpu_torch.ops import kernels as K
    streams = q1_hybrid_streams(out_dir)
    out, nbytes = [], 0
    for name, args in streams:
        got = K.hybrid_expand(*args)
        if not torch.equal(got, K.hybrid_expand_plain(*args)):
            raise AssertionError(f"hybrid_expand differs from plain: {name}")
        # the stream's words and run table read once, n int32 written
        b = sum(t.numel() * t.element_size() for t in args[:6]) + 4 * args[6]
        nbytes += b
        rec = {"kernel": "hybrid_expand", "stream": name, "values": args[6],
               "runs": int(args[2].shape[0]), "bound_ms": bound_ms(b)}
        rec.update(_timed(f"b5_{name}", lambda: K.hybrid_expand(*args), 200))
        out.append(rec)
    out.append({"kernel": "hybrid_expand", "stream": "sum of the streams",
                "streams": len(streams),
                "ms": sum(r["ms"] for r in out),
                "host_us": sum(r["host_us"] for r in out),
                "device_us": sum(s["device_us"] for r in out
                                 for s in r.get("steps", [])),
                "bound_ms": bound_ms(nbytes)})
    if hasattr(K, "hybrid_expand_many"):
        many = [args for _name, args in streams]
        for got, want in zip(K.hybrid_expand_many(many),
                             K.hybrid_expand_many_plain(many)):
            if not torch.equal(got, want):
                raise AssertionError("hybrid_expand_many differs from plain")
        rec = {"kernel": "hybrid_expand_many", "streams": len(many),
               "bound_ms": bound_ms(nbytes)}
        rec.update(_timed("b5_many", lambda: K.hybrid_expand_many(many),
                          200))
        out.append(rec)
    return out


def delta_chunks(path: str, columns: list) -> list:
    """[(column, (words, mstart, bwid, min_delta, bit_start, page_start,
    first, n))] of row group 0's DELTA chunks of ``columns``, uploaded in
    one ``upload_arrays`` buffer as ``decode_rowgroup`` uploads them."""
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    from spark_rapids_tpu_torch.sql.sources import ParquetSource
    schema = ParquetSource(path).schema
    raw = PD.prepare_rowgroup(path, 0, columns,
                              {c: schema.dtype_of(c) for c in columns},
                              upload_blocked_chars())
    tree = {name: PD._device_upload(p) for name, p in raw.plans.items()}
    dev_tree = PD.upload_arrays(tree, "cuda")
    fields = ("dl_words", "dc_mstart", "dc_bw", "dc_min_delta",
              "dc_bit_start", "dc_page_start", "dc_first")
    return [(name, tuple(dev_tree[name][f] for f in fields)
             + (plan["meta"]["nn"],))
            for name, plan in raw.plans.items()
            if plan["kind"] == "fixed_delta"]


def delta_bound_bytes(args) -> int:
    """Bytes B6 must move for one chunk: the packed words, miniblock and
    page tables read once, n int64 written once."""
    return sum(t.numel() * t.element_size() for t in args[:7]) + 8 * args[7]


def profile_b6(out_dir: Path) -> list:
    """B6 on the l_orderkey chunk of a lineitem row group and on an orders
    row group's two DELTA chunks (files written with ``PARQUET_SPEC``)."""
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import kernels as K
    paths = G.write_parquet(str(out_dir), 0.7, tables=["lineitem", "orders"],
                            frames={"lineitem": G.gen_lineitem(0.18)})
    out = []
    for table, cols in (("lineitem", ["l_orderkey"]),
                        ("orders", ["o_orderkey", "o_custkey"])):
        chunks = delta_chunks(paths[table], cols)
        if [c for c, _a in chunks] != cols:
            raise AssertionError(f"{table}: DELTA chunks {chunks}")
        for name, args in chunks:
            if not torch.equal(K.delta_unpack(*args),
                               K.delta_unpack_plain(*args)):
                raise AssertionError(f"delta_unpack differs from plain: "
                                     f"{name}")
        many = [args for _c, args in chunks]
        nbytes = sum(delta_bound_bytes(a) for a in many)
        rec = {"kernel": "delta_unpack", "table": table, "chunks": cols,
               "values": [a[7] for a in many],
               "pages": [int(a[6].shape[0]) for a in many],
               "miniblocks": [int(a[1].shape[0]) - 1 for a in many],
               "bound_ms": bound_ms(nbytes),
               "plain_ms": _event_ms(lambda: [K.delta_unpack_plain(*a)
                                              for a in many], 5)}
        rec.update(_timed(f"b6_{table}", lambda: [K.delta_unpack(*a)
                                                  for a in many], 200))
        # the host's share of the allocations alone: the parent's four
        # (three scratch arrays and the output), the tree's two
        n = many[0][7]
        ntiles = -(-n // 2048)
        rec["alloc4_us"] = _host_us(lambda: (
            torch.empty(ntiles, dtype=torch.int64, device="cuda"),
            torch.empty(ntiles, dtype=torch.int32, device="cuda"),
            torch.empty(ntiles, dtype=torch.int64, device="cuda"),
            torch.empty(n, dtype=torch.int64, device="cuda")), 200)
        out.append(rec)
        if len(many) > 1 and hasattr(K, "delta_unpack_many"):
            for got, want in zip(K.delta_unpack_many(many),
                                 K.delta_unpack_many_plain(many)):
                if not torch.equal(got, want):
                    raise AssertionError("delta_unpack_many differs from "
                                         "plain")
            rec = {"kernel": "delta_unpack_many", "table": table,
                   "chunks": cols, "bound_ms": bound_ms(nbytes)}
            rec.update(_timed(f"b6_{table}_many",
                              lambda: K.delta_unpack_many(many), 200))
            out.append(rec)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose port to import")
    ap.add_argument("--tag", default="", help="suffix of the output name")
    ap.add_argument("--only", nargs="+", choices=PROFILES,
                    help="profile these kernels alone (default: all)")
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
    global _trace_tag
    _trace_tag = args.tag
    cudalib.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    only = args.only or PROFILES
    records = []
    if "b1" in only:
        records += [profile_b1(n, gen) for n in (1 << 23, 1 << 20, 8)]
    if "b7" in only:
        records += profile_b7(gen)
    if "b3" in only:
        records += profile_b3(gen)
    if "b2" in only:
        records.append(profile_b2(gen))
    if "b4" in only:
        records += profile_b4(gen)
        torch.cuda.empty_cache()
    if "b5" in only:
        records += profile_b5(Path(cudalib.BUILD) / "profile_parquet")
    if "b6" in only:
        records += profile_b6(Path(cudalib.BUILD) / "profile_parquet_b6")
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
