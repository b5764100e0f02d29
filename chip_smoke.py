#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout (B1
compaction, B2 hash aggregation, B3/B4 hash join build and probe), holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path through its query runners: TPC-H Q1, Q6, Q3 and Q4 at SF10
and the Q18 group-by (``group by l_orderkey, sum(l_quantity) having sum >
300``) at SF1, each answer checked against pandas on the host from the same
generated rows. Each query also runs up to its collect under PyTorch's sync
debug mode "error", where the only host waits allowed are the counted ones
(``obs/syncledger.sync_scope``): Q3 must count one per join (2), every other
query none.

Prints the card's name and power limit, per-query wall times, one
``{"kernels": [...]}`` line with each kernel's launches on the main path,
its error against the plain version and its times beside its bound, and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present or any phase fails. Details go to
``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py            # full size (needs one card)
    python3 chip_smoke.py --quick    # small shapes: build and check only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F64_RTOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
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


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_compaction(n: int, gen: torch.Generator) -> dict:
    from spark_rapids_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    cases = {}
    for density in (0.0, 1.0, 0.5, 0.02):
        keep = torch.rand(n, generator=gen, device=dev) < density
        perm, total = K.compact_permutation(keep)
        perm_p, total_p = K.compact_permutation_plain(keep)
        torch.cuda.synchronize()
        require(torch.equal(perm, perm_p) and int(total) == int(total_p),
                f"compact_permutation differs from plain at density "
                f"{density}")
        cases[str(density)] = int(total)
    # ragged, unaligned and empty masks
    keep = torch.rand(n + 77, generator=gen, device=dev) < 0.3
    for view in (keep[1:], keep[:0], keep[:5]):
        perm, total = K.compact_permutation(view)
        perm_p, total_p = K.compact_permutation_plain(view)
        require(torch.equal(perm, perm_p) and int(total) == int(total_p),
                f"compact_permutation differs from plain at n={view.numel()}")
    keep = torch.rand(n, generator=gen, device=dev) < 0.5
    ms = time_ms(lambda: K.compact_permutation(keep), 20)
    plain_ms = time_ms(lambda: K.compact_permutation_plain(keep), 5)
    library_ms = time_ms(lambda: torch.cumsum(keep, 0, dtype=torch.int32),
                         20)
    return {"name": "compact_permutation", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/compact.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:68",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            # read the mask once (1 B a row), write perm once (4 B a row)
            "bound_ms": bound_ms(n * (1 + 4) + 4), "bound_by": "bytes",
            "library_ms": library_ms, "rows": n, "kept_totals": cases}


def _by_rep(counts, rep, accs, nels):
    """Host arrays of the used slots, ordered by their first-arrival row
    (the same for kernel and plain: the least row index of each group)."""
    used = (counts > 0).nonzero().squeeze(1)
    order = torch.argsort(rep[used])
    sel = used[order]
    return (counts[sel].cpu().numpy(), rep[sel].cpu().numpy(),
            [a[sel].cpu().numpy() for a in accs],
            [ne[sel].cpu().numpy() for ne in nels])


def _compare_agg(out_k, out_p, kinds) -> float:
    ck, rk, ak, nk = _by_rep(*out_k)
    cp, rp, ap, np_ = _by_rep(*out_p)
    require(np.array_equal(ck, cp) and np.array_equal(rk, rp),
            "hash_grouped_aggregate: groups differ from plain")
    err = 0.0
    for (kind, dtype), a, b, na, nb in zip(kinds, ak, ap, nk, np_):
        require(np.array_equal(na, nb), "eligible counts differ")
        has = na > 0
        a, b = a[has], b[has]
        if dtype == torch.float64 and kind == "sum":
            require(np.allclose(a, b, rtol=F64_RTOL, atol=0.0),
                    "f64 sums differ beyond rtol")
            if len(a):
                err = max(err, float(np.max(np.abs(a - b))))
        else:
            require(np.array_equal(a, b), f"{kind} {dtype} accumulators "
                    "differ")
    return err


def check_hash_agg(n: int, nkeys: int, q18_rows: int, gen: torch.Generator,
                   dev=torch.device("cuda")) -> dict:
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops.hashing import splitmix64
    T = K.hash_table_size(n)
    key = torch.randint(0, nkeys, (n,), generator=gen, device=dev)
    key_valid = torch.rand(n, generator=gen, device=dev) < 0.99
    live = torch.rand(n, generator=gen, device=dev) < 0.995
    img = torch.where(key_valid, key ^ -(1 << 63), torch.zeros_like(key))
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    ints = torch.randint(-10 ** 12, 10 ** 12, (n,), generator=gen,
                         device=dev)
    floats = torch.rand(n, generator=gen, device=dev,
                        dtype=torch.float64) * 1e5
    elig = torch.rand(n, generator=gen, device=dev) < 0.9
    jobs = [("sum", ints, elig), ("sum", floats, elig),
            ("min", floats, elig), ("max", ints, elig),
            ("min", pos, live), ("max", pos, elig),
            ("sum", torch.ones(n, dtype=torch.int64, device=dev), live)]
    kinds = [(k, d.dtype) for k, d, _e in jobs]
    err = 0.0
    for images in ([img], [img, key_valid.to(torch.int64)],
                   [splitmix64(key) & 1023]):  # k=1, k=2, a skewed key
        out_k = K.hash_grouped_aggregate(images, live, jobs, T)
        out_p = K.hash_grouped_aggregate_plain(images, live, jobs, T)
        err = max(err, _compare_agg(out_k, out_p, kinds))
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    counts, _r, _a, _n = K.hash_grouped_aggregate([img], none, jobs, T)
    require(int(counts.sum()) == 0, "all-invalid rows entered the table")
    groups = int((K.hash_grouped_aggregate([img], live, jobs[:1], T)[0]
                  > 0).sum())

    # the Q18 partial shape: capacity rows, the orderkey image plus the
    # null signature, one float64 sum
    m = q18_rows
    T18 = K.hash_table_size(m)
    okey = torch.randint(1, 6_000_000, (m,), generator=gen, device=dev)
    images = [okey ^ -(1 << 63), torch.ones(m, dtype=torch.int64,
                                            device=dev)]
    live18 = torch.ones(m, dtype=torch.bool, device=dev)
    qty = torch.randint(1, 51, (m,), generator=gen,
                        device=dev).to(torch.float64)
    jobs18 = [("sum", qty, live18)]
    out_k = K.hash_grouped_aggregate(images, live18, jobs18, T18)
    out_p = K.hash_grouped_aggregate_plain(images, live18, jobs18, T18)
    err = max(err, _compare_agg(out_k, out_p, [("sum", torch.float64)]))
    ms = time_ms(lambda: K.hash_grouped_aggregate(images, live18, jobs18,
                                                  T18), 10)
    plain_ms = time_ms(lambda: K.hash_grouped_aggregate_plain(
        images, live18, jobs18, T18), 2)
    k, nj = len(images), len(jobs18)
    # each input read once (key words, live byte, data and eligible byte per
    # job), each T-wide output written once (count, rep, per job acc + nel),
    # and one random 32-byte sector per table touch of a live row: the
    # claim state and its k key words as one packed slot (4 + 8k <= 32
    # bytes), then count, rep and per job acc + nel
    nbytes = (m * (8 * k + 1) + m * nj * (8 + 1) + T18 * (4 + 4 + nj * 12)
              + m * (1 + 2 + 2 * nj) * 32)
    return {"name": "hash_grouped_aggregate", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/hash_agg.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:619",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None, "check_rows": n, "check_groups": groups,
            "check_table": T, "timed_rows": m, "timed_table": T18}


def _join_inputs(case: str, n: int, gen: torch.Generator, dev):
    """(build images, build valid, stream images, stream valid)."""
    if case == "empty":
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        zb = torch.zeros(0, dtype=torch.bool, device=dev)
        return [z], zb, [z], zb
    k = {"k2": 2, "k3": 3}.get(case, 1)
    hi = {"skewed": 4, "k2": 1024, "k3": 128}.get(case, n // 2)
    ns = 64 if case == "skewed" else n  # one key expands to ~n/4 rows
    bimg = [torch.randint(0, hi, (n,), generator=gen, device=dev)
            ^ -(1 << 63) for _ in range(k)]
    simg = [torch.randint(0, hi + hi // 4, (ns,), generator=gen, device=dev)
            ^ -(1 << 63) for _ in range(k)]
    bv = torch.rand(n, generator=gen, device=dev) < (
        0.0 if case == "all_invalid" else 0.9)
    sv = torch.rand(ns, generator=gen, device=dev) < 0.95
    return bimg, bv, simg, sv


def _compare_build(images, valid, T) -> tuple:
    """B3 against its plain version, by key; returns the kernel's build."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.testing import hashcheck
    slot, rank, table, counts = K.hash_table_build(images, valid, T)
    _s, _r, table_p, counts_p = K.hash_table_build_plain(images, valid, T)
    torch.cuda.synchronize()
    require(rank is None, "hash_table_build returned a rank")
    hashcheck.check_build(images, valid, slot, table, counts)
    require(torch.equal(hashcheck.table_by_key(table, counts),
                        hashcheck.table_by_key(table_p, counts_p)),
            "hash_table_build: table differs from plain by key")
    return slot, table, counts, table_p, counts_p


def _compare_probe(table, counts, table_p, counts_p, images, valid, T):
    from spark_rapids_tpu_torch.ops import kernels as K
    got = K.hash_table_probe(table, counts, images, valid, T)
    want = K.hash_table_probe_plain(table_p, counts_p, images, valid, T)
    hit = got < T
    require(torch.equal(hit, want < T), "hash_table_probe: hits differ "
            "from plain")
    for j, img in enumerate(images):
        require(torch.equal(table[j][got[hit].long()], img[hit]),
                "hash_table_probe: a hit slot holds another key")
    require(torch.equal(counts[got[hit].long()], counts_p[want[hit].long()]),
            "hash_table_probe: match counts differ from plain")


def check_hash_join(n: int, cap: int, live_rows: int, probe_rows: int,
                    gen: torch.Generator, dev=torch.device("cuda")):
    """B3 and B4 against their plain versions (k = 1, 2, 3, a skewed key,
    all-invalid and empty inputs, then the timed shape), and their times at
    Q3's lineitem build shape: ``cap`` rows of capacity, the first
    ``live_rows`` live, about 54% of those valid (l_shipdate > 1995-03-15),
    keys l_orderkey-like in [1, 4 * orders); the probe streams
    ``probe_rows`` o_orderkey-like keys (multiples of 4)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.testing import hashcheck
    cases = {}
    for case in ("k1", "k2", "k3", "skewed", "all_invalid", "empty"):
        bimg, bv, simg, sv = _join_inputs(case, n, gen, dev)
        T = K.hash_table_size(bv.shape[0])
        _slot, table, counts, table_p, counts_p = _compare_build(bimg, bv, T)
        _compare_probe(table, counts, table_p, counts_p, simg, sv, T)
        c, rows = hashcheck.join_matches(*K.hash_join_probe(bimg, bv, simg,
                                                            sv, T))
        c_p, rows_p = hashcheck.join_matches(*K.hash_join_probe_plain(
            bimg, bv, simg, sv, T))
        require(torch.equal(c, c_p) and torch.equal(rows, rows_p),
                f"hash_join_probe differs from plain ({case})")
        cases[case] = {"groups": int((counts > 0).sum()),
                       "matches": int(c.sum())}

    orders = live_rows // 4
    T = K.hash_table_size(cap)
    key = torch.randint(1, 4 * orders, (cap,), generator=gen, device=dev)
    img = [key ^ -(1 << 63)]
    valid = ((torch.arange(cap, device=dev) < live_rows)
             & (torch.rand(cap, generator=gen, device=dev) < 0.537))
    nvalid = int(valid.sum())
    skey = 4 * torch.randint(1, orders + 1, (probe_rows,), generator=gen,
                             device=dev)
    simg = [skey ^ -(1 << 63)]
    sv = torch.ones(probe_rows, dtype=torch.bool, device=dev)
    _slot, table, counts, table_p, counts_p = _compare_build(img, valid, T)
    _compare_probe(table, counts, table_p, counts_p, simg, sv, T)
    del table_p, counts_p
    build_ms = time_ms(lambda: K.hash_table_build(img, valid, T), 10)
    build_plain_ms = time_ms(lambda: K.hash_table_build_plain(img, valid, T),
                             1)
    probe_ms = time_ms(lambda: K.hash_table_probe(table, counts, simg, sv, T),
                       20)
    probe_plain_ms = time_ms(lambda: K.hash_table_probe_plain(
        table, counts, simg, sv, T), 2)
    k = len(img)
    # B3: keys and the valid byte read once, the slot written once, the
    # T-wide state, count and key words initialised once, and per valid row
    # one random 32 B sector for the claim or compare and one for the count
    b3_bytes = cap * (8 * k + 1) + cap * 4 + T * (4 + 4 + 8 * k) \
        + nvalid * 2 * 32
    # B4: keys and valid read once, the slot written once, one random 32 B
    # sector per valid row
    b4_bytes = probe_rows * (8 * k + 1) + probe_rows * 4 + probe_rows * 32
    common = {"route": "cuda",
              "source": "spark_rapids_tpu_torch/csrc/hash_join.cu",
              "max_abs_err": 0.0, "bound_by": "bytes", "library_ms": None,
              "check_rows": n, "check_cases": cases, "timed_table": T}
    b3 = dict(common, name="hash_table_build",
              replaces="spark_rapids_tpu/ops/pallas_kernels.py:335",
              ms=build_ms, plain_ms=build_plain_ms,
              bound_ms=bound_ms(b3_bytes), timed_rows=cap,
              timed_valid_rows=nvalid, timed_groups=int((counts > 0).sum()))
    b4 = dict(common, name="hash_table_probe",
              replaces="spark_rapids_tpu/ops/pallas_kernels.py:391",
              ms=probe_ms, plain_ms=probe_plain_ms,
              bound_ms=bound_ms(b4_bytes), timed_rows=probe_rows,
              timed_hits=int((K.hash_table_probe(table, counts, simg, sv, T)
                              < T).sum()))
    return [b3, b4]


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------

def _rel_err(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not len(a):
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def q1_reference(df):
    import pandas as pd
    f = df[df.l_shipdate <= np.datetime64("1998-09-02")]
    ep, d, t = f.l_extendedprice, f.l_discount, f.l_tax
    f = f.assign(disc_price=ep * (1 - d), charge=ep * (1 - d) * (1 + t))
    g = f.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"), avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"))
    return pd.DataFrame(g)


def check_q1(got, want) -> float:
    keys = ["l_returnflag", "l_linestatus"]
    got = got.sort_values(keys).reset_index(drop=True)
    want = want.sort_values(keys).reset_index(drop=True)
    require(len(got) == len(want), "Q1 group count differs")
    for k in keys:
        require(list(got[k].astype(str)) == list(want[k].astype(str)),
                f"Q1 key {k} differs")
    require(np.array_equal(got.count_order.to_numpy(np.int64),
                           want.count_order.to_numpy(np.int64)),
            "Q1 count_order differs")
    err = 0.0
    for c in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
              "avg_qty", "avg_price", "avg_disc"):
        err = max(err, _rel_err(got[c], want[c]))
    require(err <= F64_RTOL, f"Q1 float results differ: rel {err}")
    return err


def q3_reference(li, o, c):
    """TPC-H Q3 in pandas, every group in the query's order."""
    cut = np.datetime64("1995-03-15")
    m = (c[c.c_mktsegment == "BUILDING"][["c_custkey"]]
         .merge(o[o.o_orderdate < cut][["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_shippriority"]],
                left_on="c_custkey", right_on="o_custkey")
         .merge(li[li.l_shipdate > cut][["l_orderkey", "l_extendedprice",
                                         "l_discount"]],
                left_on="o_orderkey", right_on="l_orderkey"))
    m = m.assign(revenue=m.l_extendedprice * (1 - m.l_discount))
    g = m.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False).revenue.sum()
    return g.sort_values(["revenue", "o_orderdate"],
                         ascending=[False, True]).reset_index(drop=True)


def check_q3(got, want) -> float:
    """Rows in the query's order: revenue at rtol 1e-9, dates exact, and
    the keys of rows tied on (revenue, o_orderdate) as a set."""
    want = want.head(len(got))
    require(len(got) == 10 and len(want) == 10, "Q3 returned too few rows")
    err = _rel_err(got.revenue, want.revenue)
    require(err <= F64_RTOL, f"Q3 revenue differs: rel {err}")
    require(np.array_equal(got.o_orderdate.to_numpy("datetime64[us]"),
                           want.o_orderdate.to_numpy("datetime64[us]")),
            "Q3 order dates differ")
    for _, grp in want.groupby(["revenue", "o_orderdate"], sort=False):
        rows = grp.index
        for c in ("l_orderkey", "o_shippriority"):
            require(sorted(got.loc[rows, c]) == sorted(want.loc[rows, c]),
                    f"Q3 {c} differs")
    return err


def q4_reference(li, o):
    late = li.l_orderkey[li.l_commitdate < li.l_receiptdate]
    oo = o[(o.o_orderdate >= np.datetime64("1993-07-01"))
           & (o.o_orderdate < np.datetime64("1993-10-01"))]
    oo = oo[oo.o_orderkey.isin(late)]
    return (oo.groupby("o_orderpriority").size().rename("order_count")
            .reset_index())


def run_query(name: str, fn, runs: int) -> tuple:
    """Run ``fn`` once to warm up, then ``runs`` times, with the launch
    counts zeroed just before each run and read just after. Returns (the
    last result, the wall seconds of the timed runs, the launches of one
    run, which must be the same in every run)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    walls, launches = [], None
    for i in range(runs + 1):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if launches is not None:
            require(dict(K.LAUNCHES) == launches,
                    f"{name}: launch counts differ between runs")
        launches = dict(K.LAUNCHES)
        if i:
            walls.append(wall)
    log(f"{name}: median {np.median(walls):.4f} s of {walls}, "
        f"launches {launches}")
    return out, walls, launches


def require_syncs(name: str, fn, expected: int) -> None:
    """Run ``fn`` (a query up to, not including, its collect) with
    PyTorch's sync debug mode set to error: any call in it that makes the
    host wait for the device raises, except inside ``sync_scope``, which
    counts it. The row counts stay on the device, so filters, aggregates,
    concats, sorts and semi joins need no sync; an inner or outer join
    fetches its expansion totals once."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    torch.cuda.synchronize()
    before = SYNCS.total()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = SYNCS.total() - before
    require(got == expected, f"{name}: {got} counted host syncs before the "
            f"collect, expected {expected}")


def query_record(sf, rows: int, nbatches: int, upload_s: float, walls,
                 err: float, launches: dict) -> dict:
    med = float(np.median(walls))
    return {"sf": sf, "rows": rows, "batches": nbatches,
            "upload_s": upload_s, "wall_s": med, "wall_runs_s": walls,
            "rows_per_s": rows / med, "max_rel_err": err,
            "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes: build and check the kernels and "
                         "the queries, no full-size timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch_joins as J
    from spark_rapids_tpu_torch.models.tpch_data import (
        gen_customer, gen_lineitem, gen_orders,
    )
    from spark_rapids_tpu_torch.ops import cudalib

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if args.quick:
        b1_rows, b2_rows, b2_keys, q18_part = (1 << 20, 1 << 18, 160_000,
                                               1 << 18)
        b34_rows, b34_cap, b34_live, b34_probe = (1 << 16, 1 << 21,
                                                  1_200_000, 1 << 18)
        sf_q1, q1_batch, sf_q18, q18_batch = 0.2, 1 << 20, 0.1, 1 << 18
    else:
        # B1 at a Q1/Q6 batch, B2 on SF1 rows with ~3.8M keys and at the
        # Q18 partial shape, B3 at Q3's lineitem build (8 batches of 2^23
        # rows, SF10's 60M live) and B4 probing a 2^23-row batch;
        # batches as the queries below take them
        b1_rows, b2_rows, b2_keys, q18_part = (1 << 23, 6_000_000,
                                               6_000_000, 1 << 22)
        b34_rows, b34_cap, b34_live, b34_probe = (1 << 20, 1 << 26,
                                                  60_000_000, 1 << 23)
        sf_q1, q1_batch, sf_q18, q18_batch = 10, 1 << 23, 1, 1 << 22
    report = {"card": card, "quick": args.quick}

    t0 = time.perf_counter()
    secs = cudalib.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.2f} s {secs}")
    for name, text in cudalib.BUILD_LOGS.items():
        log(f"ptxas {name}: " + " | ".join(
            ln.strip() for ln in text.splitlines() if "Used" in ln
            or "spill" in ln))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    kernels = [check_compaction(b1_rows, gen),
               check_hash_agg(b2_rows, b2_keys, q18_part, gen)]
    torch.cuda.empty_cache()
    kernels += check_hash_join(b34_rows, b34_cap, b34_live, b34_probe, gen)
    for k in kernels:
        log(f"kernel {k['name']}: ms {k['ms']:.4f} plain {k['plain_ms']:.4f}"
            f" bound {k['bound_ms']:.4f} err {k['max_abs_err']}")
    torch.cuda.empty_cache()

    queries = {}
    launches_total = {k["name"]: 0 for k in kernels}
    runs = 1 if args.quick else 5

    t0 = time.perf_counter()
    df = gen_lineitem(sf_q1)
    report["gen_q1_s"] = time.perf_counter() - t0
    log(f"lineitem SF{sf_q1}: {len(df)} rows, {report['gen_q1_s']:.1f} s")

    t0 = time.perf_counter()
    batches = Q.upload_batches(df, Q.Q1_COLUMNS, q1_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0
    out, walls, launches = run_query(
        "Q1", lambda: Q.q1_from_batches(batches).to_pandas(), runs)
    err = check_q1(out, q1_reference(df))
    require_syncs("Q1", lambda: Q.q1_from_batches(batches), 0)
    require(launches["compact_permutation"] > 0, "Q1 ran no compaction")
    queries["q1"] = query_record(sf_q1, len(df), len(batches), up, walls,
                                 err, launches)
    del batches

    t0 = time.perf_counter()
    batches = Q.upload_batches(df, Q.Q6_COLUMNS, q1_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0
    out, walls, launches = run_query(
        "Q6", lambda: Q.q6_from_batches(batches).to_pandas(), runs)
    sd = df.l_shipdate
    m = ((sd >= np.datetime64("1994-01-01"))
         & (sd < np.datetime64("1995-01-01"))
         & (df.l_discount >= 0.05) & (df.l_discount <= 0.07)
         & (df.l_quantity < 24.0))
    want = float((df.l_extendedprice[m] * df.l_discount[m]).sum())
    err = _rel_err([out.revenue[0]], [want])
    require(len(out) == 1 and err <= F64_RTOL, f"Q6 revenue differs: {err}")
    require_syncs("Q6", lambda: Q.q6_from_batches(batches), 0)
    require(launches["compact_permutation"] > 0, "Q6 ran no compaction")
    queries["q6"] = query_record(sf_q1, len(df), len(batches), up, walls,
                                 err, launches)
    del batches
    torch.cuda.empty_cache()

    # Q3 and Q4 reuse the lineitem frame of Q1/Q6
    t0 = time.perf_counter()
    frames = {"lineitem": df, "orders": gen_orders(sf_q1),
              "customer": gen_customer(sf_q1)}
    report["gen_q3_s"] = time.perf_counter() - t0
    log(f"orders, customer SF{sf_q1}: {len(frames['orders'])}, "
        f"{len(frames['customer'])} rows, {report['gen_q3_s']:.1f} s")
    q3_rows = sum(len(f) for f in frames.values())
    t0 = time.perf_counter()
    tables = J.upload_q3(frames, q1_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0
    out, walls, launches = run_query(
        "Q3", lambda: J.q3_from_batches(tables).to_pandas(), runs)
    err = check_q3(out, q3_reference(df, frames["orders"],
                                     frames["customer"]))
    require_syncs("Q3", lambda: J.q3_from_batches(tables), 2)
    require(launches["hash_table_build"] > 0
            and launches["hash_table_probe"] > 0
            and launches["hash_grouped_aggregate"] > 0
            and launches["compact_permutation"] > 0,
            "Q3 did not run B1, B2, B3 and B4")
    queries["q3"] = query_record(sf_q1, q3_rows, sum(map(len,
                                                         tables.values())),
                                 up, walls, err, launches)
    del tables
    torch.cuda.empty_cache()

    q4_rows = len(df) + len(frames["orders"])
    t0 = time.perf_counter()
    tables = J.upload_q4(frames, q1_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0
    out, walls, launches = run_query(
        "Q4", lambda: J.q4_from_batches(tables).to_pandas(), runs)
    want = q4_reference(df, frames["orders"])
    require(list(out.o_orderpriority) == list(want.o_orderpriority)
            and list(out.order_count) == list(want.order_count),
            f"Q4 differs from pandas: {out} vs {want}")
    require_syncs("Q4", lambda: J.q4_from_batches(tables), 0)
    require(launches["hash_table_build"] > 0
            and launches["hash_table_probe"] > 0,
            "Q4 did not run B3 and B4")
    queries["q4"] = query_record(sf_q1, q4_rows, sum(map(len,
                                                         tables.values())),
                                 up, walls, 0.0, launches)
    queries["q4"]["order_count"] = int(out.order_count.sum())
    del tables, frames, df
    torch.cuda.empty_cache()

    df = gen_lineitem(sf_q18)
    t0 = time.perf_counter()
    batches = Q.upload_batches(df, Q.Q18_COLUMNS, q18_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0

    def q18():
        grouped, having = Q.q18_agg_from_batches(batches)
        return grouped.to_pandas(), having.to_pandas()
    (grouped, having), walls, launches = run_query("Q18 group-by", q18,
                                                   runs)
    want = df.groupby("l_orderkey").l_quantity.sum()
    got = grouped.sort_values("l_orderkey")
    require(np.array_equal(got.l_orderkey.to_numpy(),
                           want.index.to_numpy()), "Q18 group keys differ")
    err = _rel_err(got.sum_qty, want.to_numpy())
    require(err <= F64_RTOL, f"Q18 sums differ: rel {err}")
    want_h = want[want > 300]
    got_h = having.sort_values("l_orderkey")
    require(np.array_equal(got_h.l_orderkey.to_numpy(),
                           want_h.index.to_numpy())
            and np.allclose(got_h.sum_qty, want_h.to_numpy(),
                            rtol=F64_RTOL, atol=0), "Q18 having differs")
    require_syncs("Q18", lambda: Q.q18_agg_from_batches(batches), 0)
    require(launches["hash_grouped_aggregate"] > 0
            and launches["compact_permutation"] > 0,
            "Q18 did not run both kernels")
    queries["q18_groupby"] = query_record(sf_q18, len(df), len(batches), up,
                                          walls, err, launches)
    queries["q18_groupby"].update(groups=len(got), having_rows=len(got_h))
    del batches, df

    for q in queries.values():
        for name, n in q["launches"].items():
            launches_total[name] += n
    for k in kernels:
        k["launches"] = launches_total[k["name"]]
        k["max_err"] = k["max_abs_err"]
        require(k["launches"] > 0, f"{k['name']} never ran on the main path")
    report["kernels"] = kernels
    report["queries"] = queries

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    for name, q in queries.items():
        log(f"{name}: SF{q['sf']} {q['rows']} rows, {q['wall_s']:.4f} s, "
            f"{q['rows_per_s']:.4g} rows/s, upload {q['upload_s']:.1f} s")
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in keep}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
