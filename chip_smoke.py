#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout (B1
compaction, B2 hash aggregation, B3/B4 hash join build and probe, B5-B8 the
Parquet decode: hybrid expand, delta unpack, plain fixed, slab pack), holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path through its query runners:

  * the pandas upload path: TPC-H Q1, Q6, Q3 and Q4 at SF10 and the Q18
    group-by (``group by l_orderkey, sum(l_quantity) having sum > 300``) at
    SF1, each answer checked against pandas on the host from the same
    generated rows;
  * the port's ``TpuSparkSession``: Q1, Q6, Q3 and Q4 at SF10 and the Q18
    group-by at SF1 (``models/tpch.py``, with the hash-aggregation confs)
    planned, tagged and run on the card in test mode (any operator left on
    the CPU fails the run), with cached device scans, every answer equal to
    pandas and to the runners', warm walls beside the runners', and the
    runners' counted host syncs before the collect (Q3 two, one a join, the
    rest none); Q3 both with two shuffled joins (every SF10 table is above
    ``autoBroadcastJoinThreshold``) and with the threshold at the orders
    frame's estimate, so that its first join broadcasts;
  * the device Parquet scan: the same rows written as Parquet files with
    ``models/tpch_data.PARQUET_SPEC`` into the ignored
    ``spark_rapids_tpu_torch/build/tpch_parquet/``, then Q1, Q6, Q3 and Q4
    at SF10, the Q18 group-by at SF1 and a customer filter-and-collect at
    SF10 (every column, strings included) read from those files, with zero
    columns falling back to the host decode, checked against the same
    pandas references; then Q1, Q6, Q3, Q4, the customer collect and the
    Q18 group-by at SF1 through the session's ``read.parquet`` (no scan
    cache: every run decodes the files on the card, B5-B8 launched
    through the session), equal to pandas (the Q18 group-by also to its
    runner, with no more counted syncs), and the Q18 group-by once more
    with the session's device path off (``spark.rapids.sql.enabled=false``:
    the CPU scan decodes the file with pyarrow), equal too;
  * the aggregation's sorted grouping branches through the session at the
    JAX package's default confs (no hash branch), on cached uploads: a
    lineitem group-by on four dictionary keys past the dictionary branch
    (row space), Q3, a customer string group-by (sorted space) and a
    global string min, TPC-H Q10, Q17, Q18 and Q21 at SF10 (sorted
    payload), and the Q18 group-by at SF1 beside its B2 run, each against
    pandas, the branches taken read from ``ops/aggregate.BRANCHES``;
  * then the 14 other TPC-H queries at SF10, a string phase, Q9 from
    Parquet and the 19 TPCxBB queries at SF 250;
  * the four Mortgage queries (``models/mortgage.py``) through the
    session in 2^20-row batches, the ETL at SF 250 (6M performance rows
    expanded 12 times) and the other three at SF 500, each against its
    pandas reference (``testing/mortgagecases.py``), with its peak device
    memory, join routes and launches;
  * the window cases of ``testing/windowcases.py`` over 2^23 rows through
    the session on the card, every output column held against the CPU
    session's (``device="cpu"``), which a child process of this script
    (``--window-cpu``) computes while the phases above run.

Each query also runs up to its collect under PyTorch's sync debug mode
"error", where the only host waits allowed are the counted ones
(``obs/syncledger.sync_scope``): a query counts one per expanding join
(Q3 2, Q10 3, Q17 3, Q18 2, Q21 5), one per row-space aggregation (its
slot attempt's verdict) and one per concat past 2^27 padded rows (its live
total: the Mortgage ETL's final merge at SF 500), none otherwise, and a Parquet
scan one per row group (its upload).

B1 is timed at a 2^23-row batch, at a 2^20-row one (a Parquet row
group's) and at 8 rows (its floor), beside ``torch.cumsum`` of the mask
and the stable argsort of ``~keep`` (the one PyTorch call with B1's
result); B7 on one stream and on all the PLAIN fixed streams of a Q1 row
group in one ``plain_fixed_many`` call, beside their clones; B5 on all the
hybrid streams of a Q1 row group in one ``hybrid_expand_many`` call,
beside the sum of one call a stream; B3 at Q3's lineitem build and B2 at
the Q18 partial, each bound beside the count before its redesign; B4 and
``hash_join_lookup`` (B4 writing each row's match count and first
``bperm`` position, one launch) at Q3's probe; B6 on an l_orderkey chunk
and on an orders row group's two DELTA chunks in one ``delta_unpack_many``
call, beside one call a chunk. A Parquet query may make at most one B5,
one B6 and one B7 launch per row group.

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
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

F64_RTOL = 1e-9


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on stdout, after the seconds since the smoke started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


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
    """The least milliseconds the card takes to move ``nbytes``."""
    from spark_rapids_tpu_torch.tools.profile_kernels import bound_ms as b
    return b(nbytes)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _by_name(kernels: list, name: str) -> dict:
    """The kernels line's record of kernel ``name``."""
    return next(k for k in kernels if k["name"] == name)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_compaction(n: int, small: int, gen: torch.Generator) -> dict:
    """B1 against its plain version (densities 0, 1, 0.5, 0.02; ragged,
    unaligned and empty masks; sizes around the 4096-row tile, unaligned),
    then its time at ``n`` rows (a Q1/Q6 batch of the upload path), at
    ``small`` rows (a Parquet row group's batch) and at 8 rows (its floor:
    a launch through the wrapper, whatever the work), beside the two
    PyTorch calls: the stable argsort of ~keep, which computes the same
    permutation (``library_ms``), and the cumsum of the mask, which
    computes its scan alone."""
    from spark_rapids_tpu_torch.ops import cudalib
    from spark_rapids_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    tile = K.COMPACT_TILE_ROWS
    require(cudalib.load("compact").srt_compact_tile_rows() == tile,
            "compact_permutation: tile rows differ from the library's")

    def hold(view, what):
        perm, total = K.compact_permutation(view)
        perm_p, total_p = K.compact_permutation_plain(view)
        torch.cuda.synchronize()
        require(torch.equal(perm, perm_p) and int(total) == int(total_p),
                f"compact_permutation differs from plain: {what}")
        return int(total)

    cases = {}
    for density in (0.0, 1.0, 0.5, 0.02):
        keep = torch.rand(n, generator=gen, device=dev) < density
        cases[str(density)] = hold(keep, f"density {density}")
    # ragged, unaligned and empty masks
    keep = torch.rand(n + 77, generator=gen, device=dev) < 0.3
    for view in (keep[1:], keep[:0], keep[:5]):
        hold(view, f"n={view.numel()}")
    keep = torch.rand(4 * tile, generator=gen, device=dev) < 0.5
    edges = 0
    for m in (1, tile - 1, tile, tile + 1, 3 * tile + 1):
        for start in (0, 1, 3):
            hold(keep[start:start + m], f"n={m} at byte {start}")
            edges += 1
    keep = torch.rand(n, generator=gen, device=dev) < 0.5
    keep_s = keep[:small].clone()
    keep_8 = keep[:8].clone()

    def b1(k):
        return lambda: K.compact_permutation(k)

    def argsort(k):
        return lambda: torch.argsort((~k).to(torch.uint8), stable=True)

    def cumsum(k):
        return lambda: torch.cumsum(k, 0, dtype=torch.int32)
    ms = time_ms(b1(keep), 50)
    ms_small = time_ms(b1(keep_s), 200)
    floor_ms = time_ms(b1(keep_8), 200)
    plain_ms = time_ms(lambda: K.compact_permutation_plain(keep), 5)
    argsort_ms = time_ms(argsort(keep), 50)
    cumsum_ms = time_ms(cumsum(keep), 50)
    argsort_small = time_ms(argsort(keep_s), 200)
    cumsum_small = time_ms(cumsum(keep_s), 200)
    return {"name": "compact_permutation", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/compact.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:68",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            # read the mask once (1 B a row), write perm once (4 B a row)
            "bound_ms": bound_ms(n * (1 + 4) + 4), "bound_by": "bytes",
            "library_ms": argsort_ms,
            "library_call": "torch.argsort((~keep).to(torch.uint8), "
                            "stable=True)",
            "cumsum_ms": cumsum_ms, "rows": n, "floor_ms": floor_ms,
            "small_rows": small, "small_ms": ms_small,
            "small_bound_ms": bound_ms(small * 5 + 4),
            "small_argsort_ms": argsort_small,
            "small_cumsum_ms": cumsum_small, "kept_totals": cases,
            "tile_edge_checks": edges}


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
    from spark_rapids_tpu_torch.tools.profile_kernels import b2_bound_bytes
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
    # the all-ones image (every key word the fill) on every 7th row
    fill = torch.where(pos % 7 == 0, torch.full_like(img, -1), img)
    nullsig = key_valid.to(torch.int64)
    for images in ([img], [img, nullsig], [splitmix64(key) & 1023],
                   [fill], [fill, torch.full_like(img, -1)],
                   [img, key % 5, key % 3, nullsig]):
        # k = 1 and 2 (the Q18 layout), a skewed key, the fill key at
        # k = 1 and 2, k = 4 (Q3's group-by layout)
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
    # each input read once, each T-wide output written once, and per live
    # row the random sectors of one record holding all it updates
    nbytes = b2_bound_bytes(m, int(live18.sum()), len(images),
                            [d.element_size() for _k, d, _e in jobs18], T18)
    return {"name": "hash_grouped_aggregate", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/hash_agg.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:619",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes["bytes"]), "bound_by": "bytes",
            "old_bound_ms": bound_ms(nbytes["old"]),
            "library_ms": None, "check_rows": n, "check_groups": groups,
            "check_table": T, "timed_rows": m, "timed_table": T18}


def _join_inputs(case: str, n: int, gen: torch.Generator, dev):
    """(build images, build valid, stream images, stream valid)."""
    if case == "empty":
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        zb = torch.zeros(0, dtype=torch.bool, device=dev)
        return [z], zb, [z], zb
    k = {"k2": 2, "k3": 3}.get(case, 1)
    hi = {"skewed": 4, "k2": 1024, "k3": 128, "bool_key": 2}.get(case, n // 2)
    # one key expands to ~n/4 rows, a bool to ~n/2
    ns = 64 if case in ("skewed", "bool_key") else n
    sign = 0 if case == "bool_key" else -(1 << 63)  # a bool's image is 0/1
    bimg = [torch.randint(0, hi, (n,), generator=gen, device=dev) ^ sign
            for _ in range(k)]
    simg = [torch.randint(0, hi + hi // 4, (ns,), generator=gen, device=dev)
            ^ sign for _ in range(k)]
    if case == "int64_max":  # INT64_MAX's image: B3's all-ones fill word
        bimg[0][::5] = -1
        simg[0][::16384] = -1  # each expands to ~n/5 rows
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


def _compare_probe(slot_b, bvalid, table, counts, table_p, counts_p,
                   images, valid, T) -> int:
    """B4 against the plain probe of the plain build (by key), and the
    lookup against the plain probe of the same table, then ``_lookup``;
    returns the hits."""
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
    jt = K.JoinTable(table, counts, *K._placement(slot_b, counts, bvalid))
    plain = K._lookup(K.hash_table_probe_plain(table, counts, images, valid,
                                               T), counts, jt.starts)
    for g, w in zip(K.hash_join_lookup(jt, images, valid), plain):
        require(g.dtype == w.dtype and torch.equal(g, w),
                "hash_join_lookup differs from the plain probe + _lookup")
    return int(hit.sum())


def check_hash_join(n: int, cap: int, live_rows: int, probe_rows: int,
                    gen: torch.Generator, dev=torch.device("cuda")):
    """B3 and B4 against their plain versions (k = 1, 2, 3, a skewed key,
    a bool key (images 0 and 1), INT64_MAX keys (the all-ones image B3
    fills unused key words with), all-invalid and empty inputs, then the
    timed shape), and their times at
    Q3's lineitem build shape: ``cap`` rows of capacity, the first
    ``live_rows`` live, about 54% of those valid (l_shipdate > 1995-03-15),
    keys l_orderkey-like in [1, 4 * orders); the probe streams
    ``probe_rows`` o_orderkey-like keys (multiples of 4)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.testing import hashcheck
    from spark_rapids_tpu_torch.tools.profile_kernels import (
        lookup_bound_bytes)
    cases = {}
    for case in ("k1", "k2", "k3", "skewed", "bool_key", "int64_max",
                 "all_invalid", "empty"):
        bimg, bv, simg, sv = _join_inputs(case, n, gen, dev)
        T = K.hash_table_size(bv.shape[0])
        slot, table, counts, table_p, counts_p = _compare_build(bimg, bv, T)
        _compare_probe(slot, bv, table, counts, table_p, counts_p, simg, sv,
                       T)
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
    slot, table, counts, table_p, counts_p = _compare_build(img, valid, T)
    hits = _compare_probe(slot, valid, table, counts, table_p, counts_p, simg,
                          sv, T)
    del table_p, counts_p
    jt = K.JoinTable(table, counts, *K._placement(slot, counts, valid))
    del slot
    build_ms = time_ms(lambda: K.hash_table_build(img, valid, T), 10)
    build_plain_ms = time_ms(lambda: K.hash_table_build_plain(img, valid, T),
                             1)
    probe_ms = time_ms(lambda: K.hash_table_probe(table, counts, simg, sv, T),
                       20)
    probe_plain_ms = time_ms(lambda: K.hash_table_probe_plain(
        table, counts, simg, sv, T), 2)
    lookup_ms = time_ms(lambda: K.hash_join_lookup(jt, simg, sv), 20)
    lookup_plain_ms = time_ms(lambda: K._lookup(K.hash_table_probe_plain(
        table, counts, simg, sv, T), counts, jt.starts), 2)
    lookup_bytes = lookup_bound_bytes(probe_rows, int(sv.sum()), hits)
    k = len(img)
    # B3: keys and the valid byte read once, the slot written once, the
    # T-wide key words and counts initialised once, and per valid row two
    # random 32 B sectors: its key word and its count
    b3_bytes = cap * (8 * k + 1) + cap * 4 + T * (8 * k + 4) \
        + nvalid * 2 * 32
    # the earlier count, which also held the T-wide state word: scratch of
    # one implementation, not work of the function
    b3_old_bytes = b3_bytes + T * 4
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
              bound_ms=bound_ms(b3_bytes),
              old_bound_ms=bound_ms(b3_old_bytes), timed_rows=cap,
              timed_valid_rows=nvalid, timed_groups=int((counts > 0).sum()))
    b4 = dict(common, name="hash_table_probe",
              replaces="spark_rapids_tpu/ops/pallas_kernels.py:391",
              ms=probe_ms, plain_ms=probe_plain_ms,
              bound_ms=bound_ms(b4_bytes), timed_rows=probe_rows,
              timed_hits=hits, lookup_ms=lookup_ms,
              lookup_plain_ms=lookup_plain_ms,
              lookup_bound_bytes=lookup_bytes,
              lookup_bound_ms=bound_ms(lookup_bytes))
    del jt, table, counts
    torch.cuda.empty_cache()
    b4["dense_yardstick"] = dense_yardstick(cap, live_rows, probe_rows, gen,
                                            dev)
    return [b3, b4]


def dense_yardstick(cap: int, live_rows: int, probe_rows: int,
                    gen: torch.Generator, dev) -> dict:
    """The dense route's speed beside the hash route's at Q3's build and
    probe shapes (``cap`` build rows, the first ``live_rows`` live, 53.7%
    of them valid; ``probe_rows`` stream rows), keys in [1, 2^24), the
    widest range the dense route tables: ``join_probe_dense`` (the build
    sorted by offset, a (start, count) table, one gather a stream row)
    against ``hash_join_probe`` (B3, the placement sort, B4), both giving
    (counts, bstart, bperm). Their match counts must agree."""
    from spark_rapids_tpu_torch.columnar import dtype as dtypes
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops import joins as join_ops
    from spark_rapids_tpu_torch.ops import kernels as K

    def batch(keys, valid, n):
        return DeviceBatch(Schema(["k"], [dtypes.INT64]),
                           [DeviceColumn(dtypes.INT64, keys, valid)],
                           torch.tensor(n, dtype=torch.int32, device=dev))
    span = 1 << 24
    bkey = torch.randint(1, span, (cap,), generator=gen, device=dev)
    bvalid = ((torch.arange(cap, device=dev) < live_rows)
              & (torch.rand(cap, generator=gen, device=dev) < 0.537))
    skey = torch.randint(1, span, (probe_rows,), generator=gen, device=dev)
    sv = torch.ones(probe_rows, dtype=torch.bool, device=dev)
    build, stream = batch(bkey, bvalid, live_rows), batch(skey, sv,
                                                          probe_rows)
    T = K.hash_table_size(cap)
    bimg, simg = [bkey ^ -(1 << 63)], [skey ^ -(1 << 63)]
    counts, _bs, _bp, ok = join_ops.join_probe_dense(build, stream, 0, 0, 0,
                                                     span)
    hcounts, _hs, _hp = K.hash_join_probe(bimg, bvalid, simg, sv, T)
    require(bool(ok) and torch.equal(counts, hcounts),
            "dense probe: match counts differ from B3 + B4")
    del counts, hcounts, _bs, _bp, _hs, _hp
    dense_ms = time_ms(lambda: join_ops.join_probe_dense(
        build, stream, 0, 0, 0, span), 5)
    hash_ms = time_ms(lambda: K.hash_join_probe(bimg, bvalid, simg, sv, T),
                      5)
    dense_build_ms = time_ms(lambda: join_ops.dense_build(build, 0, 0, span),
                             5)
    table = join_ops.dense_build(build, 0, 0, span)
    dense_lookup_ms = time_ms(lambda: join_ops.dense_lookup(table, stream,
                                                            0), 10)
    log(f"dense probe at Q3's shapes ({cap} build rows, {probe_rows} "
        f"probes, keys in [1, 2^24)): {dense_ms:.4f} ms (build "
        f"{dense_build_ms:.4f}, lookup {dense_lookup_ms:.4f}) against B3 + "
        f"B4 {hash_ms:.4f} ms")
    return {"build_rows": cap, "live_rows": live_rows,
            "probe_rows": probe_rows, "key_span": span,
            "dense_ms": dense_ms, "dense_build_ms": dense_build_ms,
            "dense_lookup_ms": dense_lookup_ms, "hash_ms": hash_ms}


# ---------------------------------------------------------------------------
# Phase 2b: the decode kernels against their plain versions
# ---------------------------------------------------------------------------

def _to_dev(a: np.ndarray) -> torch.Tensor:
    """A host array on the card; u32/u64 words as int32/int64 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).cuda()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bytes (floats compared bit for bit)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def column_plan(path: str, column: str, rg: int = 0) -> dict:
    """The port's decode plan of one column chunk, its arrays on the card
    (a DELTA plan's as the merged chunk table ``delta_unpack`` takes)."""
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    from spark_rapids_tpu_torch.sql.sources import ParquetSource
    md = praw.file_metadata(path)
    names = [md.schema.column(i).name for i in range(md.num_columns)]
    chunk = praw.read_column_chunk(path, rg, names.index(column))
    plan = PD.plan_column(chunk, ParquetSource(path).schema.dtype_of(column),
                          md.schema.to_arrow_schema().field(column).type,
                          upload_blocked_chars())
    host = PD._device_upload(plan)
    plan["host"] = host
    plan["dev"] = {k: _to_dev(v) for k, v in host.items()}
    return plan


def _hybrid_args(up: dict, prefix: str) -> list:
    return [up[f"{prefix}_{k}"] for k in ("words", "out_start", "kind",
                                          "value", "bit_start", "bw")]


def _run_table(rng, nruns: int, bws, kinds, nwords: int) -> tuple:
    """A synthetic hybrid run table with its guard row (run lengths 1..600,
    bit-packed runs at random bit offsets) and its value count."""
    counts = rng.integers(1, 600, nruns)
    out_start = np.concatenate([[0], np.cumsum(counts),
                                [np.iinfo(np.int32).max]]).astype(np.int32)
    kind = np.append(rng.choice(kinds, nruns), 0).astype(np.uint8)
    value = np.append(rng.integers(-3, 1 << 20, nruns), 0).astype(np.int32)
    bw = np.append(rng.choice(bws, nruns), 0).astype(np.int32)
    bit_start = np.append(rng.integers(0, (nwords - 2) * 32 - 600 * 32,
                                       nruns), 0).astype(np.int64)
    return (out_start, kind, value, bit_start, bw), int(counts.sum())


def _delta_table(rng, totals, bws, nwords: int) -> tuple:
    """A synthetic merged DELTA chunk table (32-delta miniblocks at random
    bit offsets, min deltas of both signs) and its value count."""
    mstart, bw, mind, bits, first = [], [], [], [], []
    page_start = [0]
    for t in totals:
        base = page_start[-1]
        for s in range(0, max(t - 1, 0), 32):
            mstart.append(base + 1 + s)
            bw.append(rng.choice(bws))
            mind.append(rng.integers(-(1 << 40), 1 << 40))
            bits.append(rng.integers(0, (nwords - 2) * 32 - 32 * 32))
        first.append(rng.integers(-(1 << 62), 1 << 62))
        page_start.append(base + t)
    mstart.append(np.iinfo(np.int32).max)
    bw.append(0)
    mind.append(0)
    bits.append(0)
    return ((np.asarray(mstart, np.int32), np.asarray(bw, np.int32),
             np.asarray(mind, np.int64), np.asarray(bits, np.int64),
             np.asarray(page_start, np.int32), np.asarray(first, np.int64)),
            int(sum(totals)))


def _delta_args(up: dict) -> list:
    return [up[k] for k in ("dl_words", "dc_mstart", "dc_bw", "dc_min_delta",
                            "dc_bit_start", "dc_page_start", "dc_first")]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _q1_plain_streams(path: str) -> list:
    """The (words, kind, n) of row group 0's PLAIN fixed streams over Q1's
    columns (values and dictionary pages), as ``decode_rowgroup`` hands
    them to one ``plain_fixed_many`` call."""
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    plans = {c: column_plan(path, c) for c in Q.Q1_COLUMNS}
    streams = PD.plain_streams(plans, {c: p["dev"] for c, p in plans.items()})
    require(bool(streams), "Q1's columns hold no PLAIN fixed stream")
    return [s for _name, s in streams]


def _q1_hybrid_streams(path: str) -> list:
    """The (words, out_start, kind, value, bit_start, bw, n) of row group
    0's RLE/bit-packed hybrid streams over Q1's columns (definition levels
    and dictionary codes), uploaded in one buffer and handed to one
    ``hybrid_expand_many`` call, as ``decode_rowgroup`` does."""
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    from spark_rapids_tpu_torch.sql.sources import ParquetSource
    src = ParquetSource(path)
    raw = PD.prepare_rowgroup(
        path, 0, Q.Q1_COLUMNS,
        {c: src.schema.dtype_of(c) for c in Q.Q1_COLUMNS},
        upload_blocked_chars())
    dev_tree = PD.upload_arrays(
        {c: PD._device_upload(p) for c, p in raw.plans.items()}, "cuda")
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    streams = PD.hybrid_streams(raw.plans, dev_tree,
                                bucket_capacity(max(raw.n, 1)))
    require(len(streams) > 1, "Q1's columns hold no hybrid streams")
    return [s for _key, s in streams]


def _rowgroup_delta_chunks(path: str) -> list:
    """The (words, mstart, bwid, min_delta, bit_start, page_start, first,
    n) of row group 0's DELTA chunks over every column of the file,
    uploaded in one buffer and handed to one ``delta_unpack_many`` call,
    as ``decode_rowgroup`` does."""
    from spark_rapids_tpu_torch.exec.transitions import upload_blocked_chars
    from spark_rapids_tpu_torch.ops import parquet_decode as PD
    from spark_rapids_tpu_torch.sql.sources import ParquetSource
    src = ParquetSource(path)
    names = list(src.schema.names)
    raw = PD.prepare_rowgroup(
        path, 0, names, {c: src.schema.dtype_of(c) for c in names},
        upload_blocked_chars())
    dev_tree = PD.upload_arrays(
        {c: PD._device_upload(p) for c, p in raw.plans.items()}, "cuda")
    return [s for _name, s in PD.delta_streams(raw.plans, dev_tree)]


_CLONE_DTYPES = {"i32": torch.int32, "f32": torch.float32,
                 "i64": torch.int64, "f64": torch.float64}


def _clone_of(words: torch.Tensor, kind: str, n: int) -> torch.Tensor:
    """One PyTorch call with B7's result for a fixed-width kind: the words
    viewed as the values, cut to n and cloned."""
    return words.view(_CLONE_DTYPES[kind])[:n].clone()


def write_edge_files(out_dir: str) -> dict:
    """Small Parquet files of the decode's edge cases: an INT32 DELTA
    column whose deltas wrap in 32 bits, an INT64 one with negative deltas,
    and PLAIN strings with empty values and nulls."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(5)
    n = 50_003
    wrap = np.where(np.arange(n) % 2 == 0, np.iinfo(np.int32).max,
                    np.iinfo(np.int32).min).astype(np.int32)
    wrap[::7] = rng.integers(-(1 << 31), 1 << 31, len(wrap[::7]))
    down = (10 ** 12 - np.cumsum(rng.integers(0, 1000, n))).astype(np.int64)
    strs = np.array(["", "a", "bb", "x" * 31, "yz" * 16, None],
                    dtype=object)[rng.integers(0, 6, n)]
    paths = {"delta": os.path.join(out_dir, "delta.parquet"),
             "strings": os.path.join(out_dir, "strings.parquet")}
    pq.write_table(pa.table({"wrap": wrap, "down": down}), paths["delta"],
                   use_dictionary=False, data_page_version="1.0",
                   column_encoding={"wrap": "DELTA_BINARY_PACKED",
                                    "down": "DELTA_BINARY_PACKED"})
    pq.write_table(pa.table({"s": pa.array(strs, pa.string())}),
                   paths["strings"], use_dictionary=False,
                   data_page_version="1.0")
    return paths


def check_decode(paths: dict, edge: dict, cap: int) -> list:
    """B5-B8 against their plain versions, exactly, on real plans of the
    SF files (l_returnflag codes, l_shipdate codes and definition levels,
    l_orderkey DELTA pages, l_extendedprice PLAIN values, the l_shipdate
    dictionary page, c_name byte arrays) and on edge cases (bit widths 0,
    1, 17 and 32, all-RLE and all-bit-packed streams, n not a multiple of
    8, negative min deltas, 32-bit wrap, empty strings and nulls); then
    each kernel's time at its row-group shape (``cap`` outputs)."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261016)
    checked = {"hybrid_expand": 0, "delta_unpack": 0, "plain_fixed": 0,
               "slab_pack": 0}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        require(_bits_equal(got, want), f"{name} differs from plain: {what}")
        checked[name] += 1

    # B5: real plans, then synthetic run tables
    flag = column_plan(paths["lineitem"], "l_returnflag")
    ship = column_plan(paths["lineitem"], "l_shipdate")
    for plan, prefix, n in ((flag, "cd", bucket_capacity(flag["meta"]["nn"])),
                            (ship, "cd", bucket_capacity(ship["meta"]["nn"])),
                            (ship, "lv", bucket_capacity(ship["meta"]["n"]))):
        args = _hybrid_args(plan["dev"], prefix)
        hold("hybrid_expand", K.hybrid_expand(*args, n),
             K.hybrid_expand_plain(*args, n), f"real {prefix} n={n}")
    nwords = 40_000
    words = _to_dev(rng.integers(0, 1 << 32, nwords, dtype=np.uint64)
                    .astype(np.uint32))
    synthetic = []
    for bws, kinds in (([0], [1]), ([1], [1]), ([17], [1]), ([32], [1]),
                       ([0, 1, 17, 32], [0]), ([3, 17, 32], [0, 1])):
        table, total = _run_table(rng, 800, bws, kinds, nwords)
        args = [words] + [_to_dev(a) for a in table]
        for n in (total, total + 1, 12_345, 1 << 20, 0):
            hold("hybrid_expand", K.hybrid_expand(*args, n),
                 K.hybrid_expand_plain(*args, n), f"bw {bws} kinds {kinds}"
                 f" n={n}")
            synthetic.append(tuple(args) + (n,))
    # a Q1 row group's hybrid streams in one launch, as decode_rowgroup
    # hands them over; then with the synthetic ones, 43 streams, two launches
    rg_hybrid = _q1_hybrid_streams(paths["lineitem"])
    for streams in (rg_hybrid, rg_hybrid + synthetic):
        for got, want in zip(K.hybrid_expand_many(streams),
                             K.hybrid_expand_many_plain(streams)):
            hold("hybrid_expand", got, want,
                 f"{len(streams)} streams in one call")

    # B6: the l_orderkey chunk, the edge file, synthetic tables
    okey = column_plan(paths["lineitem"], "l_orderkey")
    args = _delta_args(okey["dev"])
    n_ok = okey["meta"]["nn"]
    got = K.delta_unpack(*args, n_ok)
    hold("delta_unpack", got, K.delta_unpack_plain(*args, n_ok), "l_orderkey")
    want = pq.ParquetFile(paths["lineitem"]).read_row_group(
        0, columns=["l_orderkey"]).column(0).to_numpy()
    require(np.array_equal(got.cpu().numpy(), want),
            "l_orderkey decode differs from pyarrow")
    for col in ("wrap", "down"):
        plan = column_plan(edge["delta"], col)
        a = _delta_args(plan["dev"])
        n = n_edge = plan["meta"]["nn"]
        got = K.delta_unpack(*a, n)
        hold("delta_unpack", got, K.delta_unpack_plain(*a, n), col)
        want = pq.read_table(edge["delta"], columns=[col]).column(0)
        got = got.to(torch.int32) if col == "wrap" else got
        require(np.array_equal(got.cpu().numpy(), want.to_numpy()),
                f"{col} decode differs from pyarrow")
    edge_delta = [tuple(_delta_args(column_plan(edge["delta"], c)["dev"]))
                  + (n_edge,) for c in ("wrap", "down")]
    synthetic_delta = []
    wide = [0, 1, 17, 27, 32]
    for totals, bws, wrap in (([100_000], wide, False),
                              ([20_000] * 13 + [777], wide, False),
                              ([1, 2, 0, 33, 1, 2048, 2049, 4095, 1, 5],
                               wide, False),
                              ([70_000, 3], [0], False),
                              ([9_000, 50_001], [32], False),
                              ([5_000, 4_000], [0], True)):
        table, n = _delta_table(rng, totals, bws, 200_000)
        if wrap:
            # 64-bit wrap: each page's first value 2^41 + 5 below the int64
            # limit, then deltas of 2^40: the fourth value wraps negative
            table[2][:-1] = 1 << 40
            table[5][:] = (1 << 63) - 5 - (1 << 41)
        a = [_to_dev(rng.integers(0, 1 << 32, 200_000, dtype=np.uint64)
                     .astype(np.uint32))] + [_to_dev(x) for x in table]
        got = K.delta_unpack(*a, n)
        hold("delta_unpack", got, K.delta_unpack_plain(*a, n),
             f"pages {len(totals)} bit widths {bws}")
        if wrap:
            v = got.cpu().numpy()
            require(bool((v[:3] > 0).all() and (v[3:5000] < 0).all()),
                    "the 64-bit wrap case did not wrap")
        synthetic_delta.append(tuple(a) + (n,))
    # a row group's DELTA chunks in one launch, as decode_rowgroup hands
    # them over: an orders row group (o_orderkey, o_custkey); then with the
    # edge and synthetic chunks; then 40 chunks, two launches
    rg_delta = _rowgroup_delta_chunks(paths["orders"])
    require(len(rg_delta) == 2, f"orders row group DELTA chunks: "
            f"{len(rg_delta)}")
    mixed_delta = rg_delta + edge_delta + synthetic_delta
    for chunks in (rg_delta, mixed_delta, (mixed_delta * 4)[:40]):
        for got, want in zip(K.delta_unpack_many(chunks),
                             K.delta_unpack_many_plain(chunks)):
            hold("delta_unpack", got, want,
                 f"{len(chunks)} chunks in one call")

    # B7: l_extendedprice values, the l_shipdate dictionary page, all kinds
    price = column_plan(paths["lineitem"], "l_extendedprice")
    n_pr = bucket_capacity(price["meta"]["nn"])
    vals = price["dev"]["vals"]
    hold("plain_fixed", K.plain_fixed(vals, "f64", n_pr),
         K.plain_fixed_plain(vals, "f64", n_pr), "l_extendedprice")
    dv = ship["dev"]["dv_words"]
    hold("plain_fixed", K.plain_fixed(dv, "i64", ship["meta"]["card"]),
         K.plain_fixed_plain(dv, "i64", ship["meta"]["card"]),
         "l_shipdate dictionary")
    for kind in ("i32", "f32", "i64", "f64", "bool"):
        for n in (1, 8191, nwords, 1 << 20):
            hold("plain_fixed", K.plain_fixed(words, kind, n),
                 K.plain_fixed_plain(words, kind, n), f"{kind} n={n}")
    # a Q1 row group's PLAIN fixed streams in one launch, as decode_rowgroup
    # hands them over; then more streams than a launch takes, every kind,
    # sources aligned and not
    rg_streams = _q1_plain_streams(paths["lineitem"])
    for got, want in zip(K.plain_fixed_many(rg_streams),
                         K.plain_fixed_many_plain(rg_streams)):
        hold("plain_fixed", got, want, "Q1 row group streams")
    mixed = [(words[off:off + 2 * (97 * j + 1)],
              ("i32", "f32", "i64", "f64", "bool")[j % 5], 150 * j)
             for j in range(40) for off in (0, 1)]
    for got, want in zip(K.plain_fixed_many(mixed),
                         K.plain_fixed_many_plain(mixed)):
        hold("plain_fixed", got, want, "80 mixed streams")

    # B8: c_name byte arrays, the edge file's empty strings and nulls
    name = column_plan(paths["customer"], "c_name")
    edge_s = column_plan(edge["strings"], "s")
    for plan, what in ((name, "c_name"), (edge_s, "empty strings")):
        up = plan["dev"]
        a = [up["chars"], up["st"], up["ln"], up["st"].shape[0],
             plan["meta"]["stride"]]
        hold("slab_pack", K.slab_pack(*a), K.slab_pack_plain(*a), what)

    # times at the row-group shapes, and at 8 outputs: the floor a launch
    # through the wrapper costs whatever the work
    tiny_tbl, _n = _delta_table(rng, [8], [27], 64)
    tiny_delta = [words[:64]] + [_to_dev(x) for x in tiny_tbl]
    tiny_chars = _to_dev(np.zeros(64, np.uint8))
    tiny_rows = _to_dev(np.zeros(8, np.int64))
    tiny_lens = _to_dev(np.zeros(8, np.int32))
    floors = {
        "hybrid_expand": time_ms(lambda: K.hybrid_expand(
            *_hybrid_args(ship["dev"], "cd"), 8), 200),
        "delta_unpack": time_ms(lambda: K.delta_unpack(*tiny_delta, 8), 200),
        "plain_fixed": time_ms(lambda: K.plain_fixed(vals, "f64", 8), 200),
        "slab_pack": time_ms(lambda: K.slab_pack(
            tiny_chars, tiny_rows, tiny_lens, 8, 8), 200)}
    out = []
    common = {"route": "cuda",
              "source": "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
              "max_abs_err": 0.0, "bound_by": "bytes"}
    args = _hybrid_args(ship["dev"], "cd")
    n = cap

    def one(a):
        return lambda: K.hybrid_expand(*a)
    out.append(dict(
        common, name="hybrid_expand",
        replaces="spark_rapids_tpu/ops/pallas_kernels.py:929",
        ms=time_ms(lambda: K.hybrid_expand(*args, n), 50),
        plain_ms=time_ms(lambda: K.hybrid_expand_plain(*args, n), 5),
        # the packed words and the run table read once, n int32 written
        bound_ms=bound_ms(_nbytes(args) + 4 * n), library_ms=None,
        timed="l_shipdate codes, row group 0", timed_rows=n,
        timed_runs=int(args[2].shape[0]),
        # the main path's call: a row group's streams in one launch
        rowgroup="lineitem row group 0, Q1's hybrid streams",
        rowgroup_streams=len(rg_hybrid),
        rowgroup_rows=sum(a[6] for a in rg_hybrid),
        rowgroup_ms=time_ms(lambda: K.hybrid_expand_many(rg_hybrid), 200),
        rowgroup_plain_ms=time_ms(
            lambda: K.hybrid_expand_many_plain(rg_hybrid), 5),
        rowgroup_single_calls_ms=sum(time_ms(one(a), 200)
                                     for a in rg_hybrid),
        rowgroup_bound_ms=bound_ms(sum(_nbytes(a[:6]) + 4 * a[6]
                                       for a in rg_hybrid)),
        checks=checked["hybrid_expand"]))
    args = _delta_args(okey["dev"])
    out.append(dict(
        common, name="delta_unpack",
        replaces="spark_rapids_tpu/ops/pallas_kernels.py:999",
        ms=time_ms(lambda: K.delta_unpack(*args, n_ok), 50),
        plain_ms=time_ms(lambda: K.delta_unpack_plain(*args, n_ok), 5),
        # the packed words, miniblock and page tables read once, n int64
        # written
        bound_ms=bound_ms(_nbytes(args) + 8 * n_ok), library_ms=None,
        timed="l_orderkey, row group 0", timed_rows=n_ok,
        timed_pages=int(args[6].shape[0]),
        timed_miniblocks=int(args[1].shape[0]) - 1,
        # the main path's call: a row group's DELTA chunks in one launch
        rowgroup="orders row group 0, o_orderkey and o_custkey",
        rowgroup_chunks=len(rg_delta),
        rowgroup_rows=sum(c[7] for c in rg_delta),
        rowgroup_ms=time_ms(lambda: K.delta_unpack_many(rg_delta), 200),
        rowgroup_plain_ms=time_ms(
            lambda: K.delta_unpack_many_plain(rg_delta), 5),
        rowgroup_single_calls_ms=sum(
            time_ms(lambda c=c: K.delta_unpack(*c), 200) for c in rg_delta),
        rowgroup_bound_ms=bound_ms(sum(_nbytes(c[:7]) + 8 * c[7]
                                       for c in rg_delta)),
        checks=checked["delta_unpack"]))
    # each stream's values read once and written once
    rg_bytes = sum(2 * t.numel() * t.element_size()
                   for t in K.plain_fixed_many_plain(rg_streams))
    out.append(dict(
        common, name="plain_fixed",
        replaces="spark_rapids_tpu/ops/pallas_kernels.py:1075",
        ms=time_ms(lambda: K.plain_fixed(vals, "f64", n_pr), 50),
        plain_ms=time_ms(lambda: K.plain_fixed_plain(vals, "f64", n_pr), 5),
        # the values' words read once, n float64 written
        bound_ms=bound_ms(16 * min(n_pr, vals.shape[0] // 2)),
        library_ms=time_ms(
            lambda: vals.view(torch.float64)[:n_pr].clone(), 50),
        timed="l_extendedprice, row group 0", timed_rows=n_pr,
        rowgroup="lineitem row group 0, Q1's PLAIN fixed streams",
        rowgroup_segments=len(rg_streams),
        rowgroup_ms=time_ms(lambda: K.plain_fixed_many(rg_streams), 200),
        rowgroup_plain_ms=time_ms(
            lambda: K.plain_fixed_many_plain(rg_streams), 20),
        rowgroup_clones_ms=time_ms(lambda: [
            _clone_of(*s) for s in rg_streams], 200),
        rowgroup_bound_ms=bound_ms(rg_bytes),
        checks=checked["plain_fixed"]))
    up = name["dev"]
    a = [up["chars"], up["st"], up["ln"], up["st"].shape[0],
         name["meta"]["stride"]]
    live_chars = int(name["host"]["ln"].astype(np.int64).sum())
    out.append(dict(
        common, name="slab_pack",
        replaces="spark_rapids_tpu/ops/pallas_kernels.py:1140",
        ms=time_ms(lambda: K.slab_pack(*a), 50),
        plain_ms=time_ms(lambda: K.slab_pack_plain(*a), 5),
        # the rows' chars, starts and lens read once, cap x stride written
        bound_ms=bound_ms(live_chars + 12 * a[3] + a[3] * a[4]),
        library_ms=None, timed="c_name, row group 0", timed_rows=a[3],
        timed_stride=a[4], checks=checked["slab_pack"]))
    for k in out:
        k["floor_ms"] = floors[k["name"]]
    return out


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


def count_syncs(fn) -> int:
    """Run ``fn`` (a query up to, not including, its collect) with
    PyTorch's sync debug mode set to error: any call in it that makes the
    host wait for the device raises, except inside ``sync_scope``, which
    counts it. Returns the counted syncs. The row counts stay on the
    device, so filters, aggregates, concats, sorts and semi joins need no
    sync; an inner or outer join fetches its expansion totals once, and a
    row-space aggregation reads its slot attempt's verdict once."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    torch.cuda.synchronize()
    before = SYNCS.total()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return SYNCS.total() - before


def require_syncs(name: str, fn, expected: int) -> None:
    """``count_syncs(fn)``, required to be ``expected``."""
    got = count_syncs(fn)
    require(got == expected, f"{name}: {got} counted host syncs before the "
            f"collect, expected {expected}")


def query_record(sf, rows: int, nbatches: int, upload_s: float, walls,
                 err: float, launches: dict) -> dict:
    med = float(np.median(walls))
    return {"sf": sf, "rows": rows, "batches": nbatches,
            "upload_s": upload_s, "wall_s": med, "wall_runs_s": walls,
            "rows_per_s": rows / med, "max_rel_err": err,
            "launches": launches}


def check_encodings(paths: dict) -> dict:
    """Each column's encodings in the footer of row group 0, required to be
    those of ``tpch_data.PARQUET_SPEC``: dictionary columns RLE_DICTIONARY,
    DELTA columns DELTA_BINARY_PACKED, PLAIN columns neither."""
    from spark_rapids_tpu_torch.models.tpch_data import PARQUET_SPEC
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    dict_encs = {"RLE_DICTIONARY", "PLAIN_DICTIONARY"}
    out = {}
    for table, path in paths.items():
        rg = praw.file_metadata(path).row_group(0)
        encs = {rg.column(i).path_in_schema: set(rg.column(i).encodings)
                for i in range(rg.num_columns)}
        spec = PARQUET_SPEC[table]
        for c in spec["dictionary"]:
            require(bool(encs[c] & dict_encs), f"{c}: {encs[c]}")
        for c in spec["delta"]:
            require("DELTA_BINARY_PACKED" in encs[c]
                    and not encs[c] & dict_encs, f"{c}: {encs[c]}")
        for c in spec["plain"]:
            require("PLAIN" in encs[c] and not encs[c] & dict_encs
                    and "DELTA_BINARY_PACKED" not in encs[c],
                    f"{c}: {encs[c]}")
        out[table] = {c: sorted(e) for c, e in encs.items()}
        log(f"encodings {table}: " + ", ".join(
            f"{c} {'/'.join(sorted(e))}" for c, e in encs.items()))
    return out


def _batch_bytes(tables) -> int:
    """Device bytes of decoded batches (data, validity, codes, slabs)."""
    total = 0
    for b in tables:
        for c in b.columns:
            for t in (c.data, c.validity, c.dict_codes, c.slab64, c.lens):
                if t is not None:
                    total += t.numel() * t.element_size()
    return total


def run_parquet_query(name: str, scan, query, runs: int,
                      row_groups: int, own_syncs: int) -> dict:
    """``query(scan())`` once to warm up, then ``runs`` times: the launch
    counts zeroed before each run and read after, the scan's seconds (files
    to device batches, synchronized) and the wall of scan + query (to the
    collect). Then the scan and the query up to its collect under the sync
    debug mode "error": one counted sync per row group (its upload) plus
    the query's own. Returns the record and the last result."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY, delta
    from spark_rapids_tpu_torch.ops import kernels as K
    walls, scans, launches, stats = [], [], None, None
    for i in range(runs + 1):
        K.reset_launches()
        before = REGISTRY.values()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = scan()
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        out = query(tables, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if launches is not None:
            require(dict(K.LAUNCHES) == launches,
                    f"{name}: launch counts differ between runs")
        launches = dict(K.LAUNCHES)
        stats = delta(before, REGISTRY.values())
        require(stats.get("scan.device.fallbackColumns", 0) == 0,
                f"{name}: columns fell back to the host decode")
        require(stats.get("scan.device.splits", 0) == row_groups,
                f"{name}: {stats.get('scan.device.splits')} row groups "
                f"decoded, expected {row_groups}")
        decoded = sum(_batch_bytes(t) for t in (
            tables.values() if isinstance(tables, dict) else [tables]))
        del tables
        if i:
            walls.append(wall)
            scans.append(t_scan)
    require_syncs(name, lambda: query(scan(), False),
                  row_groups + own_syncs)
    require(0 < launches["hybrid_expand"] <= row_groups, f"{name}: "
            f"{launches['hybrid_expand']} B5 launches for {row_groups} row "
            "groups")
    require(launches["plain_fixed"] <= row_groups, f"{name}: "
            f"{launches['plain_fixed']} B7 launches for {row_groups} row "
            "groups")
    require(launches["delta_unpack"] <= row_groups, f"{name}: "
            f"{launches['delta_unpack']} B6 launches for {row_groups} row "
            "groups")
    med = float(np.median(walls))
    log(f"{name}: scan+query median {med:.4f} s of {walls}, scan "
        f"{np.median(scans):.4f} s of {scans}, launches {launches}")
    return out, {"wall_s": med, "wall_runs_s": walls,
                 "scan_s": float(np.median(scans)), "scan_runs_s": scans,
                 "plan_s": stats.get("scan.device.prepTime", 0.0),
                 "encoded_bytes": stats.get("scan.device.bytesDevice", 0),
                 "decoded_bytes": decoded, "row_groups": row_groups,
                 "counted_syncs": row_groups + own_syncs,
                 "launches": launches}


def session_of(batch_rows: int, **conf):
    """The port's session on the card with the confs of the session phase:
    test mode (a fallback fails the query), device scan caching (warm
    executions skip the upload, as the runners' batches are already on the
    card) and the runners' batch size."""
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = (TpuSparkSession.builder()
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .config("spark.rapids.sql.batchSizeRows", batch_rows))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def run_session_query(name: str, query, runs: int, runner: dict,
                      sf, rows: int, syncs: int = 0) -> tuple:
    """A session query: one cold execution (uploads into the session's
    device scan cache; a partial aggregate learns its skip decision), then
    ``runs`` warm ones timed as the runners' are, then the query up to its
    collect under the sync debug mode "error", where it may make only the
    runners' counted syncs (``syncs``: Q3's two joins, else none)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    query.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    out, walls, launches = run_query(name, query.collect, runs)
    dense = dense_verifications(query)
    reset_routes()
    require_syncs(name, query.collect_batches, syncs + dense)
    med = float(np.median(walls))
    log(f"{name}: median {med:.4f} s against the runner's "
        f"{runner['wall_s']:.4f} s; counted syncs before the collect "
        f"{syncs + dense} (runner {syncs}, dense verifications {dense}); "
        f"cold run (upload) {cold:.1f} s; routes {route_counts()}")
    return out, {"sf": sf, "rows": rows, "upload_s": cold, "wall_s": med,
                 "wall_runs_s": walls, "rows_per_s": rows / med,
                 "launches": launches, "counted_syncs": syncs + dense,
                 "dense_verifications": dense, "routes": route_counts(),
                 "runner_wall_s": runner["wall_s"], "runner_syncs": syncs}


def dense_verifications(df) -> int:
    """The semi and anti joins of a session query's device plan that take
    the dense route: the session's scan statistics (read after the cold
    run's uploads) bound their build key to at most 2^24 values. Each
    reads its verification flag once, one counted sync (an expanding join
    reads its flag in the copy of its expansion totals)."""
    from spark_rapids_tpu_torch.exec import tpujoin
    sess = df.session
    joins = {id(node): node for node in sess.physical_plan(df._plan).walk()
             if isinstance(node, tpujoin.TpuShuffledHashJoinExec)
             and node.join_type in ("leftsemi", "leftanti")}
    return sum(node.dense_plan(sess) is not None for node in joins.values())


def route_counts() -> dict:
    """The join routes' probes and builds and the fused count distinct's
    runs since the last ``reset_routes``."""
    from spark_rapids_tpu_torch.exec import aggfuse, tpujoin
    return {"join_probes": dict(tpujoin.ROUTES),
            "join_builds": dict(tpujoin.BUILDS),
            "count_distinct": dict(aggfuse.ROUTES)}


def joined_on_device(rec: dict) -> bool:
    """A session record's joins ran on B3 and B4, or on the dense route."""
    launches = rec["launches"]
    return ((launches["hash_table_build"] > 0
             and launches["hash_table_probe"] > 0)
            or rec["routes"]["join_probes"]["dense"] > 0)


def reset_routes() -> None:
    from spark_rapids_tpu_torch.exec import aggfuse, tpujoin
    tpujoin.reset_routes()
    aggfuse.reset_routes()


def expanding_joins(sess, df) -> int:
    """The joins of a session query's device plan that expand rows (every
    type but the semi and anti joins; cross joins included), each subtree
    counted as often as the plan executes it (a subtree shared through
    ``exec/reuse.TpuReuseSubtreeExec`` once): each makes one counted sync
    (its single stream partition's expansion totals)."""
    from spark_rapids_tpu_torch.exec import tpujoin
    joins = {id(node): node for node in sess.physical_plan(df._plan).walk()
             if isinstance(node, tpujoin.TpuShuffledHashJoinExec)
             and node.join_type not in ("leftsemi", "leftanti")}
    return len(joins)


def run_session_cell(name: str, query, runs: int, sf, rows: int,
                     joins: int, branches: tuple) -> tuple:
    """A session query at the confs the session holds, on cached uploads:
    one cold execution (uploads into the scan cache; a partial aggregate
    learns its skip decision), ``runs`` warm ones timed, then the query up
    to its collect under the sync debug mode "error" with the aggregation
    branch counts (``ops/aggregate.BRANCHES``) zeroed before and read
    after. It may make one counted sync per expanding join (``joins``: its
    expansion totals), one per semi or anti join on the dense route
    (``dense_verifications``, predicted from the plan after the cold run),
    one per row-space aggregation (its slot attempt's verdict) and one per
    concat past ``exec/tpu.CONCAT_SHRINK_ROWS`` padded rows (its live
    total, counted by ``CONCAT_SHRINKS``), no other; each branch of
    ``branches`` must have run, the hash branch (B2) not at all."""
    from spark_rapids_tpu_torch.exec import tpu as TPU
    from spark_rapids_tpu_torch.ops import aggregate as A
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    query.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    out, walls, launches = run_query(name, query.collect, runs)
    dense = dense_verifications(query)
    TPU.reset_concat_shrinks()
    A.reset_branches()
    reset_routes()
    t0 = time.perf_counter()
    got = count_syncs(query.collect_batches)
    torch.cuda.synchronize()
    # the query up to its collect, one run (the sync-checked one)
    to_collect = time.perf_counter() - t0
    taken = dict(A.BRANCHES)
    routes = route_counts()
    shrinks = TPU.CONCAT_SHRINKS["synced"]
    want = joins + dense + taken.get("rowspace", 0) + shrinks
    require(got == want, f"{name}: {got} counted syncs before the collect, "
            f"expected {want} ({joins} joins, {dense} dense "
            f"verifications, {shrinks} concats past "
            f"{TPU.CONCAT_SHRINK_ROWS} rows, branches {taken})")
    for b in branches:
        require(taken.get(b, 0) > 0, f"{name}: branch {b} did not run "
                f"({taken})")
    require(not taken.get("hash"), f"{name}: took the hash branch")
    med = float(np.median(walls))
    log(f"{name}: median {med:.4f} s ({to_collect:.4f} s up to the "
        f"collect), {len(out)} rows, counted syncs "
        f"{got} ({joins} joins, {dense} dense verifications), branches "
        f"{taken}, routes {routes}; cold run (upload) {cold:.1f} s")
    return out, {"sf": sf, "rows": rows, "upload_s": cold, "wall_s": med,
                 "wall_runs_s": walls, "rows_per_s": rows / med,
                 "launches": launches, "counted_syncs": got,
                 "expanding_joins": joins, "dense_verifications": dense,
                 "concat_shrinks": shrinks, "to_collect_s": to_collect,
                 "branches": taken, "routes": routes,
                 "rows_out": len(out), "fallbacks": 0}


def q10_reference(li, o, c, n):
    o = o[(o.o_orderdate >= np.datetime64("1993-10-01"))
          & (o.o_orderdate < np.datetime64("1994-01-01"))]
    # the lines of those orders first: a hash probe of every line, then
    # string compares on the few left
    li = li.loc[li.l_orderkey.isin(o.o_orderkey),
                ["l_orderkey", "l_returnflag", "l_extendedprice",
                 "l_discount"]]
    li = li[li.l_returnflag == "R"]
    j = (c[["c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey"]]
         .merge(o[["o_orderkey", "o_custkey"]], left_on="c_custkey",
                right_on="o_custkey")
         .merge(li, left_on="o_orderkey", right_on="l_orderkey")
         .merge(n[["n_nationkey", "n_name"]], left_on="c_nationkey",
                right_on="n_nationkey"))
    j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
    g = (j.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone",
                    "n_name"], as_index=False).revenue.sum())
    return (g.sort_values(["revenue", "c_custkey"], ascending=[False, True])
            .head(20).reset_index(drop=True))


def q17_reference(li, p) -> float:
    p = p[(p.p_brand == "Brand#23") & (p.p_container == "MED BOX")]
    j = li[["l_partkey", "l_quantity", "l_extendedprice"]].merge(
        p[["p_partkey"]], left_on="l_partkey", right_on="p_partkey")
    lim = j.groupby("p_partkey").l_quantity.mean() * 0.2
    j = j[j.l_quantity < j.p_partkey.map(lim)]
    return float(j.l_extendedprice.sum() / 7.0) if len(j) else float("nan")


def q18_reference(li, o, c):
    ok = li.l_orderkey.to_numpy()
    tot = np.bincount(ok, weights=li.l_quantity.to_numpy())
    big = np.nonzero(tot > 300)[0]
    lines = li[li.l_orderkey.isin(big)]
    o = o[o.o_orderkey.isin(big)]
    j = (o[["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"]]
         .merge(c[["c_custkey", "c_name"]], left_on="o_custkey",
                right_on="c_custkey")
         .merge(lines[["l_orderkey", "l_quantity"]], left_on="o_orderkey",
                right_on="l_orderkey"))
    g = (j.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice"], as_index=False).l_quantity.sum()
         .rename(columns={"l_quantity": "sum_qty"}))
    return (g.sort_values(["o_totalprice", "o_orderdate"],
                          ascending=[False, True])
            .head(100).reset_index(drop=True))


def _distinct_suppliers(ok, sk) -> "pd.Series":
    """Distinct suppliers per order, from one packed int64 per line."""
    import pandas as pd
    u = np.unique(ok.astype(np.int64) << 20 | sk.astype(np.int64))
    keys, counts = np.unique(u >> 20, return_counts=True)
    return pd.Series(counts, index=keys)


def q21_reference(li, s, o, n):
    import pandas as pd
    ok, sk = li.l_orderkey.to_numpy(), li.l_suppkey.to_numpy()
    require(int(sk.max()) < 1 << 20, "l_suppkey does not fit 20 bits")
    late = (li.l_receiptdate > li.l_commitdate).to_numpy()
    saudi = n.n_nationkey[n.n_name == "SAUDI ARABIA"].to_numpy()
    supp = s[s.s_nationkey.isin(saudi)].set_index("s_suppkey").s_name
    fin = o.o_orderkey[o.o_orderstatus == "F"].to_numpy()
    # the candidate lines (late, a Saudi supplier, an F order), then the
    # supplier counts of their orders only
    j = pd.DataFrame({"ok": ok[late], "sk": sk[late]})
    j = j[j.sk.isin(supp.index) & j.ok.isin(fin)]
    mine = np.isin(ok, j.ok.unique())
    nsupp = _distinct_suppliers(ok[mine], sk[mine])
    nlate = _distinct_suppliers(ok[mine & late], sk[mine & late])
    j = j[(j.ok.map(nsupp) > 1) & (j.ok.map(nlate) == 1)]
    g = (j.sk.map(supp).value_counts().rename_axis("s_name")
         .reset_index(name="numwait"))
    return (g.sort_values(["numwait", "s_name"], ascending=[False, True])
            .head(100).reset_index(drop=True))


def same_in_order(got, want, keys, order, what: str) -> float:
    """``same_by_key`` on the unique ``keys``, and ``got`` in the query's
    order (``order``: (column, ascending) pairs)."""
    err = same_by_key(got, want, keys, what)
    cols = [c for c, _ in order]
    asc = [a for _, a in order]
    srt = got.sort_values(cols, ascending=asc, kind="stable")
    require(list(srt.index) == list(got.index), f"{what}: not in order")
    return err


def run_session_parquet(name: str, query, runs: int, runner, sf,
                        rows: int, row_groups: int, own_syncs: int) -> tuple:
    """A session query over Parquet files, decoded on the card, no scan
    cache: one cold execution (a partial aggregate learns its skip
    decision), then ``runs`` timed as the runners' Parquet queries are
    (files to the collect) with no column decoded on the host, then the
    query up to its collect under the sync debug mode "error": one counted
    sync per row group (its upload) plus the query's own, no more than the
    runner's record (``runner``, or None where no runner ran the query on
    these files)."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY, delta
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    query.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    before = REGISTRY.values()
    out, walls, launches = run_query(name, query.collect, runs)
    stats = delta(before, REGISTRY.values())
    require(stats.get("scan.device.fallbackColumns", 0) == 0,
            f"{name}: columns fell back to the host decode")
    require(stats.get("scan.device.splits", 0) == row_groups * (runs + 1),
            f"{name}: {stats.get('scan.device.splits')} row groups decoded "
            f"in {runs + 1} runs of {row_groups}")
    dense = dense_verifications(query)
    syncs = row_groups + own_syncs + dense
    reset_routes()
    require_syncs(name, query.collect_batches, syncs)
    for k, what in (("hybrid_expand", "B5"), ("delta_unpack", "B6"),
                    ("plain_fixed", "B7")):
        require(launches[k] <= row_groups, f"{name}: {launches[k]} {what} "
                f"launches for {row_groups} row groups")
    require(launches["hybrid_expand"] > 0, f"{name}: no B5 launch")
    med = float(np.median(walls))
    beside = ("" if runner is None else
              f" against the runner's {runner['wall_s']:.4f} s (syncs "
              f"{runner['counted_syncs']})")
    log(f"{name}: median {med:.4f} s{beside}; counted syncs {syncs} "
        f"({dense} dense verifications), routes {route_counts()}; B5 "
        f"{launches['hybrid_expand']} B6 {launches['delta_unpack']} B7 "
        f"{launches['plain_fixed']} B8 {launches['slab_pack']}; cold run "
        f"{cold:.1f} s")
    require(runner is None or syncs - dense <= runner["counted_syncs"],
            f"{name}: {syncs} syncs, more than the runner's")
    return out, {"sf": sf, "rows": rows, "cold_s": cold, "wall_s": med,
                 "wall_runs_s": walls, "rows_per_s": rows / med,
                 "launches": launches, "counted_syncs": syncs,
                 "dense_verifications": dense, "routes": route_counts(),
                 "row_groups": row_groups,
                 "runner_wall_s": runner and runner["wall_s"],
                 "runner_syncs": runner and runner["counted_syncs"]}


def join_execs(sess, df) -> dict:
    """The join operators of a session query's device plan, by name."""
    from spark_rapids_tpu_torch.exec import tpujoin
    out = {"TpuShuffledHashJoinExec": 0, "TpuBroadcastHashJoinExec": 0}
    for node in sess.physical_plan(df._plan).walk():
        if isinstance(node, tpujoin.TpuShuffledHashJoinExec):
            out[type(node).__name__] += 1
    return out


def same_by_key(got, want, keys, what: str) -> float:
    """Rows equal by key: keys and integers exact, floats at rtol 1e-9;
    returns the largest relative float error."""
    require(list(got.columns) == list(want.columns)
            and len(got) == len(want), f"{what}: shape differs")
    got = got.sort_values(keys).reset_index(drop=True)
    want = want.sort_values(keys).reset_index(drop=True)
    err = 0.0
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "M":  # dates at any unit
            g, w = g.astype("datetime64[us]"), w.astype("datetime64[us]")
        if np.asarray(w).dtype.kind == "f":
            err = max(err, _rel_err(g, w))
        else:
            require([str(x) for x in g] == [str(x) for x in w],
                    f"{what}: column {c} differs")
    require(err <= F64_RTOL, f"{what}: rel {err}")
    return err


def q6_reference(li) -> float:
    sd = li.l_shipdate
    m = ((sd >= np.datetime64("1994-01-01"))
         & (sd < np.datetime64("1995-01-01"))
         & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
         & (li.l_quantity < 24.0))
    return float((li.l_extendedprice[m] * li.l_discount[m]).sum())


def session_parquet_cells(paths: dict, frames: dict, sf, batch_rows: int,
                          runs: int, queries: dict) -> None:
    """Q1, Q6, Q3, Q4 and the customer collect through the session from
    the Parquet files ``paths`` holding ``frames`` (at ``sf``): decoded on
    the card, no scan cache, each table's row groups packed into
    partitions of a batch and concatenated by the coalesce above the scan;
    each answer equal to pandas from the same rows. Records go into
    ``queries``."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    li, o, c = frames["lineitem"], frames["orders"], frames["customer"]
    rgs = {t: praw.file_metadata(p).num_row_groups for t, p in paths.items()}
    sess = session_of(batch_rows, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.cacheDeviceScans": False}))
    ptables = {n: sess.read.parquet(p) for n, p in paths.items()}
    out, rec = run_session_parquet(
        "session Q1 parquet", T.q1(sess, ptables), runs, None, sf, len(li),
        rgs["lineitem"], 0)
    rec["max_rel_err"] = check_q1(out, q1_reference(li))
    queries["session_q1_parquet"] = rec
    out, rec = run_session_parquet(
        "session Q6 parquet", T.q6(sess, ptables), runs, None, sf, len(li),
        rgs["lineitem"], 0)
    err = _rel_err([out.revenue[0]], [q6_reference(li)])
    require(len(out) == 1 and err <= F64_RTOL,
            f"session Q6 parquet differs: {err}")
    rec["max_rel_err"] = err
    queries["session_q6_parquet"] = rec
    q3_df = T.q3(sess, ptables)
    out, rec = run_session_parquet(
        "session Q3 parquet", q3_df, runs, None, sf,
        len(li) + len(o) + len(c), sum(rgs.values()), 2)
    rec["max_rel_err"] = check_q3(out, q3_reference(li, o, c))
    rec["joins"] = join_execs(sess, q3_df)
    queries["session_q3_parquet"] = rec
    out, rec = run_session_parquet(
        "session Q4 parquet", T.q4(sess, ptables), runs, None, sf,
        len(li) + len(o), rgs["lineitem"] + rgs["orders"], 0)
    q4_want = q4_reference(li, o)
    require(list(out.o_orderpriority) == list(q4_want.o_orderpriority)
            and list(out.order_count) == list(q4_want.order_count),
            f"session Q4 parquet differs: {out} vs {q4_want}")
    rec["max_rel_err"] = 0.0
    queries["session_q4_parquet"] = rec
    out, rec = run_session_parquet(
        "session customer collect parquet", T.customer_segment(sess, ptables),
        runs, None, sf, len(c), rgs["customer"], 0)
    got = out.sort_values("c_custkey").reset_index(drop=True)
    want = c[c.c_mktsegment == "BUILDING"].reset_index(drop=True)
    for col in want.columns:
        require(list(got[col]) == list(want[col]),
                f"session customer collect: {col} differs from pandas")
    require(rec["launches"]["slab_pack"] > 0,
            "session customer scan ran no B8")
    rec.update(max_rel_err=0.0, rows_out=len(out))
    queries["session_customer_parquet"] = rec


def sorted_branch_cells(sess, tables: dict, frames: dict, sf, runs: int,
                        queries: dict, report: dict, q3_want,
                        session_q3) -> None:
    """The session cells of the sorted grouping branches, on the session
    of the Q3/Q4 cells and its cached uploads (``tables``: lineitem,
    orders and customer of ``frames`` at ``sf``), switched to the JAX
    package's default confs: Q3 and a customer string group-by and global
    min, then TPC-H Q10, Q17, Q18 and Q21 with supplier, part and nation
    added, each against pandas from the same rows. Records go into
    ``queries``."""
    import pandas as pd
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.sql import functions as SF_
    df = frames["lineitem"]
    q3_rows = sum(len(f) for f in frames.values())
    # the JAX package's default confs on the same session and uploads: no
    # hash branch, so unbounded keys take the sorted-payload branch
    sess.set_conf("spark.rapids.sql.autoBroadcastJoinThreshold", 10 << 20)
    sess.set_conf("spark.rapids.sql.agg.hashAggEnabled", False)
    out, rec = run_session_cell("session Q3 default confs",
                                T.q3(sess, tables), runs, sf,
                                q3_rows, 2, ("sorted_payload",))
    rec["max_rel_err"] = max(check_q3(out, q3_want),
                             check_q3(out, session_q3))
    rec["hash_wall_s"] = queries["session_q3"]["wall_s"]
    queries["session_q3_default"] = rec
    cust = frames["customer"]
    out, rec = run_session_cell(
        "session customer string group-by", tables["customer"]
        .group_by("c_nationkey")
        .agg(SF_.min("c_name").alias("min_name"),
             SF_.max("c_phone").alias("max_phone"),
             SF_.first("c_mktsegment").alias("first_seg"),
             SF_.count("c_phone").alias("n")), runs, sf, len(cust),
        0, ("sorted_space",))
    g = cust.groupby("c_nationkey")
    first_seg = g.c_mktsegment.first()
    want = pd.DataFrame({"c_nationkey": g.c_name.min().index,
                         "min_name": g.c_name.min().to_numpy(),
                         "max_phone": g.c_phone.max().to_numpy(),
                         "first_seg": first_seg.to_numpy(),
                         "n": g.size().to_numpy()})
    rec["max_rel_err"] = same_by_key(out, want, ["c_nationkey"],
                                     "session customer string group-by")
    queries["session_strings_groupby"] = rec
    out, rec = run_session_cell(
        "session customer string min", tables["customer"].agg(
            SF_.min("c_name").alias("min_name")), runs, sf,
        len(cust), 0, ("single",))
    require(list(out.min_name) == [cust.c_name.min()],
            f"session customer string min: {list(out.min_name)}")
    rec["max_rel_err"] = 0.0
    queries["session_strings_global"] = rec

    # TPC-H Q10, Q17, Q18 and Q21 at SF10 on the same session; Q18's
    # lineitem gets ten 45-unit lines for each of four orders (the
    # generator's orders never reach its 300 units)
    t0 = time.perf_counter()
    more = {"supplier": G.gen_supplier(sf), "part": G.gen_part(sf),
            "nation": G.gen_nation()}
    o_keys = frames["orders"].o_orderkey.to_numpy()[[3, 77, 500, 1234]]
    li18 = pd.concat([df[["l_orderkey", "l_quantity"]], pd.DataFrame({
        "l_orderkey": np.repeat(o_keys, 10),
        "l_quantity": np.full(40, 45.0)})], ignore_index=True)
    report["gen_new_s"] = time.perf_counter() - t0
    frames.update(more)
    tables.update({n: sess.create_dataframe(f) for n, f in more.items()})
    t18 = dict(tables, lineitem=sess.create_dataframe(li18))
    t0 = time.perf_counter()
    wants = {
        "q10": q10_reference(df, frames["orders"], cust, more["nation"]),
        "q17": q17_reference(df, more["part"]),
        "q18": q18_reference(li18, frames["orders"], cust),
        "q21": q21_reference(df, more["supplier"], frames["orders"],
                             more["nation"])}
    report["pandas_new_s"] = time.perf_counter() - t0
    log(f"supplier, part, nation SF{sf} and Q18's lineitem "
        f"{report['gen_new_s']:.1f} s; pandas Q10/Q17/Q18/Q21 "
        f"{report['pandas_new_s']:.1f} s")
    new_rows = {
        "q10": len(cust) + len(frames["orders"]) + len(df) + 25,
        "q17": len(df) + len(more["part"]),
        "q18": len(li18) * 2 + len(frames["orders"]) + len(cust),
        "q21": len(df) * 3 + len(more["supplier"]) + 25
        + len(frames["orders"])}
    for qname, qt, joins, branches in (
            ("q10", tables, 3, ("sorted_payload",)),
            ("q17", tables, 3, ("single", "sorted_payload")),
            ("q18", t18, 2, ("sorted_payload",)),
            ("q21", tables, 5, ())):
        qdf = T.QUERIES[qname](sess, qt)
        require(expanding_joins(sess, qdf) == joins,
                f"session {qname}: {expanding_joins(sess, qdf)} expanding "
                f"joins in the plan, expected {joins}")
        out, rec = run_session_cell(f"session {qname.upper()}", qdf,
                                    runs, sf, new_rows[qname], joins,
                                    branches)
        want = wants[qname]
        if qname == "q17":
            err = _rel_err(out.avg_yearly.to_numpy(np.float64), [want])
            require(len(out) == 1 and err <= F64_RTOL,
                    f"session Q17: {out} against {want}")
        elif qname == "q10":
            err = same_in_order(out, want, ["c_custkey"],
                                [("revenue", False), ("c_custkey", True)],
                                "session Q10")
        elif qname == "q18":
            # the 4 orders given 450 units, and any that reach 300
            require(len(out) >= 4, f"session Q18: {len(out)} rows")
            err = same_in_order(out, want, ["o_orderkey"],
                                [("o_totalprice", False),
                                 ("o_orderdate", True)], "session Q18")
        else:
            require(len(out) > 0, "session Q21 returned no rows")
            # its two distinct counts: the fused pass, on hash group ids
            require(rec["routes"]["count_distinct"]["hash"] == 2,
                    f"session Q21: fused count distinct {rec['routes']}")
            err = same_in_order(out, want, ["s_name"],
                                [("numwait", False), ("s_name", True)],
                                "session Q21")
        rec["max_rel_err"] = err
        queries[f"session_{qname}"] = rec


# the 14 queries of the expression and cross-join slice, and the tables
# each reads
NEW_TPCH = {
    "q2": ("region", "nation", "supplier", "partsupp", "part"),
    "q5": ("region", "nation", "customer", "orders", "lineitem",
           "supplier"),
    "q7": ("lineitem", "supplier", "nation", "orders", "customer"),
    "q8": ("part", "lineitem", "supplier", "orders", "customer", "nation",
           "region"),
    "q9": ("part", "lineitem", "supplier", "partsupp", "orders", "nation"),
    "q11": ("partsupp", "supplier", "nation"),
    "q12": ("orders", "lineitem"),
    "q13": ("customer", "orders"),
    "q14": ("lineitem", "part"),
    "q15": ("lineitem", "supplier"),
    "q16": ("partsupp", "supplier", "part"),
    "q19": ("lineitem", "part"),
    "q20": ("part", "lineitem", "partsupp", "supplier", "nation"),
    "q22": ("customer", "orders"),
}
CROSS_JOIN_QUERIES = ("q11", "q15", "q22")


def same_query(got, want, qname: str, what: str) -> float:
    """``got`` equal to the pandas reference ``want`` in the query's order
    (rows tied on its sort key as a set): keys, counts and strings exact,
    floats at rtol 1e-9. Returns the largest relative float error."""
    from spark_rapids_tpu_torch.testing import tpchcases as TC
    require(list(got.columns) == list(want.columns)
            and len(got) == len(want),
            f"{what}: shape {got.shape} {list(got.columns)} against "
            f"{want.shape} {list(want.columns)}")
    order = TC.ORDERS[qname]
    if order is not None:
        got, want = TC.in_query_order(got, order), TC.in_query_order(
            want, order)
    err = 0.0
    for c in got.columns:
        g, w = got[c], want[c]
        if pd_is_float(w):
            err = max(err, _rel_err(g.to_numpy(np.float64),
                                    w.to_numpy(np.float64)))
        else:
            require([str(x) for x in g] == [str(x) for x in w],
                    f"{what}: column {c} differs")
    require(err <= F64_RTOL, f"{what}: rel {err}")
    return err


def pd_is_float(s) -> bool:
    import pandas as pd
    return pd.api.types.is_float_dtype(s.dtype)


def tpch_cells(sess, tables: dict, frames: dict, sf, runs: int,
               queries: dict, report: dict) -> None:
    """TPC-H Q2, Q5, Q7, Q8, Q9, Q11, Q12, Q13, Q14, Q15, Q16, Q19, Q20
    and Q22 at ``sf`` on the session of the sorted-branch cells (the JAX
    package's default confs, cached uploads, test mode), with partsupp and
    region added and Q11's and Q20's partsupp and Q22's orders changed so
    that they give rows (``testing/tpchcases.query_frames``). Each answer equals its
    pandas reference (``tpchcases.pandas_reference``) and has rows; Q14's
    and Q19's one value is not NULL; Q11, Q15 and Q22 run a cartesian
    product. Counted syncs: one per expanding join (inner, outer and
    cross) plus one per row-space call. Records go into ``queries``."""
    from spark_rapids_tpu_torch.exec import tpujoin
    from spark_rapids_tpu_torch.exec.reuse import TpuReuseSubtreeExec
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.testing import tpchcases as TC
    t0 = time.perf_counter()
    frames = dict(frames, partsupp=G.gen_partsupp(sf),
                  region=G.gen_region())
    report["gen_partsupp_s"] = time.perf_counter() - t0
    # the earlier cells' uploads: the new queries read other column sets
    sess.clear_device_cache()
    torch.cuda.empty_cache()
    base = dict(tables, partsupp=sess.create_dataframe(frames["partsupp"]),
                region=sess.create_dataframe(frames["region"]))
    report["pandas_tpch_s"] = {}
    for qname, names in NEW_TPCH.items():
        fr = TC.query_frames(qname, frames)
        changed = [n for n in ("partsupp", "orders")
                   if fr[n] is not frames[n]]
        qt = dict(base, **{n: sess.create_dataframe(fr[n])
                           for n in changed})
        t0 = time.perf_counter()
        want = TC.pandas_reference(qname, fr)
        report["pandas_tpch_s"][qname] = time.perf_counter() - t0
        qdf = T.QUERIES[qname](sess, qt)
        plan = list(sess.physical_plan(qdf._plan).walk())
        crosses = sum(isinstance(n, tpujoin.TpuCartesianProductExec)
                      for n in plan)
        require(crosses == (qname in CROSS_JOIN_QUERIES),
                f"session {qname}: {crosses} cartesian products")
        shared = len({id(n) for n in plan
                      if isinstance(n, TpuReuseSubtreeExec)})
        # Q15's revenue view executes once for both its readers, so its
        # sums and their maximum are the same bits
        require(shared == (qname == "q15"),
                f"session {qname}: {shared} shared subtrees")
        joins = expanding_joins(sess, qdf)
        what = f"session {qname.upper()}"
        out, rec = run_session_cell(what, qdf, runs, sf,
                                    sum(len(fr[n]) for n in names), joins,
                                    ())
        require(len(out) > 0, f"{what} returned no rows")
        if qname in ("q14", "q19"):
            require(bool(out.iloc[:, 0].notna().all()),
                    f"{what}: a NULL answer")
        rec["max_rel_err"] = same_query(out, want, qname, what)
        launches = rec["launches"]
        require(launches["compact_permutation"] > 0
                and joined_on_device(rec),
                f"{what} did not run B1, and B3 and B4 or the dense route: "
                f"{launches} {rec['routes']}")
        rec.update(expanding_joins=joins, cross_joins=crosses,
                   shared_subtrees=shared,
                   pandas_s=report["pandas_tpch_s"][qname])
        queries[f"session_{qname}"] = rec
        if changed:
            sess.clear_device_cache()  # the uploads of its changed tables
    sess.clear_device_cache()
    torch.cuda.empty_cache()


def tpcxbb_phase(sf, batch_rows: int, runs: int, queries: dict,
                 report: dict) -> None:
    """The 19 TPCxBB queries (``models/tpcxbb.py``) at ``sf`` through the
    session at the JAX package's default confs, test mode, on cached
    uploads (one session, its scan cache cleared after each query), each
    against its pandas reference (``testing/tpcxbbcases.py``; Q7's
    store_sales gains the 12 sales ``query_frames`` adds), with rows.
    Counted syncs: one per expanding join, one per semi or anti join on the
    dense route, one per row-space call, predicted from each plan after
    its cold run. The join routes, the fused count distinct and the
    launches are read from the sync-checked run; the phase must take the
    union probe (Q7's i_category), the dense probe, and B3 and B4."""
    from spark_rapids_tpu_torch.models import tpcxbb as B
    from spark_rapids_tpu_torch.models import tpcxbb_data as D
    from spark_rapids_tpu_torch.sql.plan import LogicalScan
    from spark_rapids_tpu_torch.testing import tpcxbbcases as C
    t0 = time.perf_counter()
    frames = {n: f(sf, None) for n, f in D.ALL_TABLES.items()}
    report["tpcxbb_gen_s"] = time.perf_counter() - t0
    report["tpcxbb_rows"] = {n: len(f) for n, f in frames.items()}
    log(f"TPCxBB SF{sf}: {report['tpcxbb_gen_s']:.1f} s, "
        + ", ".join(f"{n} {len(f)}" for n, f in frames.items()
                    if len(f) > 100_000))
    sess = session_of(batch_rows)
    base = {n: sess.create_dataframe(f) for n, f in frames.items()}
    report["tpcxbb_pandas_s"] = {}
    totals = {"union": 0, "dense": 0, "hash_table_build": 0,
              "hash_table_probe": 0}
    for qname in sorted(B.QUERIES, key=lambda q: int(q[1:])):
        fr = C.query_frames(qname, frames)
        changed = [n for n in fr if fr[n] is not frames[n]]
        qt = dict(base, **{n: sess.create_dataframe(fr[n])
                           for n in changed})
        t0 = time.perf_counter()
        want = C.pandas_reference(qname, fr)
        report["tpcxbb_pandas_s"][qname] = time.perf_counter() - t0
        qdf = B.QUERIES[qname](sess, qt)
        joins = expanding_joins(sess, qdf)
        what = f"session TPCxBB {qname.upper()}"
        # input rows: those of every table scan of the query's plan
        scanned = sum(len(node.source.df) for node in qdf._plan.walk()
                      if isinstance(node, LogicalScan))
        out, rec = run_session_cell(what, qdf, runs, sf, scanned, joins, ())
        require(len(out) > 0, f"{what} returned no rows")
        rec["max_rel_err"] = C.same_answer(qname, out, want)
        rec["pandas_s"] = report["tpcxbb_pandas_s"][qname]
        totals["union"] += rec["routes"]["join_probes"]["union"]
        totals["dense"] += rec["routes"]["join_probes"]["dense"]
        for k in ("hash_table_build", "hash_table_probe"):
            totals[k] += rec["launches"][k]
        queries[f"session_bb_{qname}"] = rec
        sess.clear_device_cache()
        torch.cuda.empty_cache()
    report["tpcxbb_routes"] = totals
    log(f"TPCxBB routes and launches: {totals}")
    for k, v in totals.items():
        require(v > 0, f"TPCxBB: {k} never ran ({totals})")


def _same_columns(card, cpu, what: str) -> None:
    """Two device columns equal where valid, with the same validity:
    values exact; strings in the same form (dictionary codes and values,
    or slab words and lengths)."""
    valid = card.validity.cpu()
    require(torch.equal(valid, cpu.validity), f"{what}: validity differs")
    if card.dtype.is_string:
        if cpu.dict_values is not None:
            require(card.dict_values == cpu.dict_values
                    and torch.equal(card.dict_codes.cpu()[valid],
                                    cpu.dict_codes[valid]),
                    f"{what}: dictionary strings differ")
            return
        require(card.has_slab and cpu.has_slab
                and torch.equal(card.lens.cpu()[valid], cpu.lens[valid])
                and torch.equal(card.slab64.cpu()[valid],
                                cpu.slab64[valid]),
                f"{what}: slab strings differ")
        return
    require(torch.equal(card.data.cpu()[valid], cpu.data[valid]),
            f"{what}: values differ")


# the card's string phase: every comparison against a literal and between
# columns, the string predicates, LIKE, substring, IN, OR/NOT, CASE WHEN,
# if and year, over a char slab and a dictionary
SMOKE_STRING_CASES = [
    f"{c}_{op}_{lit}" for c in ("s", "d")
    for op in ("eq", "ne", "lt", "le", "gt", "ge")
    for lit in ("prefix9", "long")] + [
    f"lit_{op}_{c}" for c in ("s", "d")
    for op in ("eq", "ne", "lt", "le", "gt", "ge")] + [
    f"{a}_{op}_{b}" for a, b in (("s", "s2"), ("d", "d2"), ("s", "d"))
    for op in ("eq", "ne", "lt", "le", "gt", "ge")] + [
    f"{c}_{fn}_{p!r}" for c in ("s", "d")
    for fn in ("startswith", "endswith", "contains")
    for p in ("abcdefghi", "hi")] + [
    f"{c}_like_{p!r}" for c in ("s", "d")
    for p in ("abcdefgh", "ab%", "%hi", "%cd%")] + [
    f"{c}_{k}" for c in ("s", "d")
    for k in ("substr_1_2", "substr_-3_2", "substr_3_-1", "substring_isin",
              "in", "in_null")] + [
    "x_in_null", "or_nulls", "not_and_or", "case_float", "case_multi", "if",
    "year"]


def string_phase(rows: int, runs: int, report: dict) -> dict:
    """The string cases (``testing/stringcases.py``) of
    ``SMOKE_STRING_CASES`` in one projection of a ``rows``-row frame
    (char-slab and dictionary columns with nulls), through the session on
    the card and on the CPU (``device="cpu"``, the same code in torch on
    the host): every output column equal. The card's projection is timed
    (median of ``runs`` after a cold run that uploads the frame)."""
    from spark_rapids_tpu_torch.session import TpuSparkSession
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.testing import stringcases
    t0 = time.perf_counter()
    frame = stringcases.string_frame(rows)
    table = stringcases.cases(stringcases.port_conditional)
    names = SMOKE_STRING_CASES
    require(set(names) <= set(table), "unknown string cases")
    gen_s = time.perf_counter() - t0
    outs = {}
    for device in ("cuda", "cpu"):
        b = (TpuSparkSession.builder().device(device)
             .config("spark.rapids.sql.test.enabled", True)
             .config("spark.rapids.sql.cacheDeviceScans", True)
             .config("spark.rapids.sql.batchSizeRows", rows))
        s = b.get_or_create()
        df = stringcases.projection(SF_, s, frame, table, names)
        t0 = time.perf_counter()
        outs[device] = df.collect_batches()
        if device == "cuda":
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            _out, walls, _l = run_query("string phase", df.collect_batches,
                                        runs)
        else:
            cpu_s = time.perf_counter() - t0
    card, cpu = outs["cuda"], outs["cpu"]
    require(len(card) == len(cpu), "string phase: batch counts differ")
    slabs = 0
    for bc, bh in zip(card, cpu):
        require(int(bc.num_rows.item()) == int(bh.num_rows.item()),
                "string phase: row counts differ")
        for name, cc, ch in zip(bc.schema.names, bc.columns, bh.columns):
            _same_columns(cc, ch, f"string phase {name}")
        slabs += sum(c.has_slab for c in bc.columns)
    rec = {"rows": rows, "cases": len(names), "gen_s": gen_s,
           "cold_s": cold, "wall_s": float(np.median(walls)),
           "wall_runs_s": walls, "cpu_session_s": cpu_s,
           "slab_outputs": slabs}
    log(f"string phase: {len(names)} cases over {rows} rows equal to the "
        f"CPU session; card {rec['wall_s']:.4f} s (cold {cold:.1f} s), "
        f"CPU session {cpu_s:.1f} s")
    report["string_phase"] = rec
    return rec


def q9_parquet_cell(paths: dict, frames: dict, sf, batch_rows: int,
                    runs: int, queries: dict) -> None:
    """TPC-H Q9 through the session from Parquet files (lineitem, orders,
    part, partsupp, supplier and nation at ``sf``, ``PARQUET_SPEC``):
    decoded on the card with no column falling back to the host (p_name a
    PLAIN byte array, so B8 builds the slab its ``contains`` reads), equal
    to pandas."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    from spark_rapids_tpu_torch.testing import tpchcases as TC
    sess = session_of(batch_rows, **{
        "spark.rapids.sql.cacheDeviceScans": False})
    t = {n: sess.read.parquet(p) for n, p in paths.items()}
    qdf = T.q9(sess, t)
    rgs = sum(praw.file_metadata(paths[n]).num_row_groups
              for n in NEW_TPCH["q9"])
    out, rec = run_session_parquet(
        "session Q9 parquet", qdf, runs, None, sf,
        sum(len(frames[n]) for n in NEW_TPCH["q9"]), rgs,
        expanding_joins(sess, qdf))
    require(len(out) > 0, "session Q9 parquet returned no rows")
    rec["max_rel_err"] = same_query(out, TC.pandas_reference("q9", frames),
                                    "q9", "session Q9 parquet")
    require(rec["launches"]["slab_pack"] > 0,
            "session Q9 parquet ran no B8")
    queries["session_q9_parquet"] = rec


def mortgage_phase(sf, sf_etl, runs: int, queries: dict,
                   report: dict) -> None:
    """The four Mortgage queries (``models/mortgage.py``), each through a
    session at the JAX package's default confs with the cartesian product
    set (as its ``bench.py`` runs them), test mode (zero fallbacks), on
    cached uploads: the ETL at ``sf_etl``, the other three at ``sf``. Each
    is held to its pandas reference (``testing/mortgagecases.py``: keys,
    counts, dates and strings exact, float64 at rtol 1e-9, a 4-place
    rounding tie either way). Counted syncs: one per expanding join,
    predicted from the plan before the run (a window stage adds none),
    plus the dense, row-space and oversized-concat ones
    ``run_session_cell`` counts. Peak device memory, the
    join routes and the launches by kernel are read per query; the phase
    must launch B1."""
    from spark_rapids_tpu_torch.config import conf as CONF
    from spark_rapids_tpu_torch.models import mortgage as M
    from spark_rapids_tpu_torch.models import mortgage_data as MD
    from spark_rapids_tpu_torch.testing import mortgagecases as MC
    # the default batch size (the JAX package's bench runs Mortgage at its
    # default confs): the ETL's 12x cross join expands one 2^20-row batch
    # at a time
    require(MORTGAGE_BATCH_ROWS == CONF.BATCH_SIZE_ROWS.default,
            "Mortgage: not the default batch size")
    tables = {}
    for x in sorted({sf, sf_etl}):
        t0 = time.perf_counter()
        tables[x] = (MD.gen_performance(x), MD.gen_acquisition(x))
        report.setdefault("mortgage_gen_s", {})[str(x)] = (
            time.perf_counter() - t0)
        log(f"Mortgage SF{x}: performance {len(tables[x][0])} rows, "
            f"acquisition {len(tables[x][1])} rows, "
            f"{report['mortgage_gen_s'][str(x)]:.1f} s")
    totals = {}
    for name in M.QUERIES:
        qsf = sf_etl if name == "etl" else sf
        perf, acq = tables[qsf]
        sess = session_of(MORTGAGE_BATCH_ROWS, **M.ETL_CONFS)
        t0 = time.perf_counter()
        want = MC.pandas_reference(name, perf, acq)
        pandas_s = time.perf_counter() - t0
        qdf = M.run_query(name, sess, sess.create_dataframe(perf),
                          sess.create_dataframe(acq))
        joins = expanding_joins(sess, qdf)
        what = f"session Mortgage {name}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = len(perf) + (len(acq) if M.QUERIES[name][1] else 0)
        out, rec = run_session_cell(what, qdf, runs, qsf, rows, joins, ())
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        rec.update(MC.same_answer(name, out, want))
        rec["pandas_s"] = pandas_s
        rec["predicted_syncs"] = joins
        log(f"{what}: {len(out)} rows equal to pandas (max rel err "
            f"{rec['max_rel_err']:.3g}, {rec['rounding_ties']} rounding "
            f"ties); peak device memory "
            f"{rec['peak_device_bytes'] / 2**30:.2f} GiB; pandas "
            f"{pandas_s:.1f} s; launches {rec['launches']}")
        for k, v in rec["launches"].items():
            totals[k] = totals.get(k, 0) + v
        queries[f"session_mortgage_{name}"] = rec
        del out, want, qdf, sess
        torch.cuda.empty_cache()
    report["mortgage_launches"] = totals
    log(f"Mortgage launches: {totals}")
    require(totals.get("compact_permutation", 0) > 0,
            "Mortgage: B1 never ran")


WINDOW_CPU_DIR = os.path.join("spark_rapids_tpu_torch", "build",
                              "window_cpu")


def _window_frames(rows: int) -> dict:
    """The window cases' frames at ``rows`` rows, one per extra-column
    kind."""
    from spark_rapids_tpu_torch.testing import windowcases as WC
    frames = {}
    for extra, _q, *_ in list(WC.CASES.values()):
        if extra not in frames:
            frames[extra] = WC.frame(extra, n=rows)
    return frames


def _window_session(device: str, rows: int):
    from spark_rapids_tpu_torch.session import TpuSparkSession
    return (TpuSparkSession.builder().device(device)
            .config("spark.rapids.sql.test.enabled", True)
            .config("spark.rapids.sql.cacheDeviceScans", True)
            .config("spark.rapids.sql.batchSizeRows", rows).get_or_create())


def _column_state(col) -> dict:
    out = {"validity": col.validity.cpu()}
    if col.dict_values is not None:
        out.update(codes=col.dict_codes.cpu(), values=col.dict_values)
    elif col.dtype.is_string:
        out.update(slab=col.slab64.cpu(), lens=col.lens.cpu())
    else:
        out["data"] = col.data.cpu()
    return out


def window_cpu_child(rows: int) -> int:
    """The CPU side of the window phase, in a process of its own started
    at the beginning of the smoke (the torch code on the host takes
    minutes at 2^23 rows): each window case through the session with
    ``device="cpu"``, its output columns saved under WINDOW_CPU_DIR."""
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.sql.window import Window
    from spark_rapids_tpu_torch.testing import windowcases as WC
    # the lowest priority and two threads: the phases on the card, whose
    # host steps (data generation, Parquet writing, pandas references) set
    # the smoke's wall, keep the host's cores
    os.nice(19)
    torch.set_num_threads(2)
    os.makedirs(WINDOW_CPU_DIR, exist_ok=True)
    t0 = time.perf_counter()
    sess = _window_session("cpu", rows)
    bases = {extra: sess.create_dataframe(f)
             for extra, f in _window_frames(rows).items()}
    for name, (extra, query, _approx) in WC.CASES.items():
        batches = query(SF_, Window, bases[extra]).collect_batches()
        torch.save([{"num_rows": int(b.num_rows),
                     "names": list(b.schema.names),
                     "cols": [_column_state(c) for c in b.columns]}
                    for b in batches],
                   os.path.join(WINDOW_CPU_DIR, f"{name}.pt"))
        log(f"window CPU {name}: {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(WINDOW_CPU_DIR, "done.json"), "w") as f:
        json.dump({"rows": rows, "s": time.perf_counter() - t0}, f)
    return 0


def start_window_cpu(rows: int) -> subprocess.Popen:
    import shutil
    shutil.rmtree(WINDOW_CPU_DIR, ignore_errors=True)
    os.makedirs(WINDOW_CPU_DIR, exist_ok=True)
    with open(os.path.join(WINDOW_CPU_DIR, "child.log"), "w") as logf:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--window-cpu",
             str(rows)], stdout=logf, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _same_window_column(card, cpu: dict, approx: bool, what: str) -> None:
    """A card column against the CPU session's: the same validity; values
    exact where valid (dictionary codes and values, slab words and
    lengths), float columns of a float-sum case at rtol 1e-6 (atol 1e-9:
    prefix sums add in another order on the card)."""
    valid = card.validity.cpu()
    require(torch.equal(valid, cpu["validity"]), f"{what}: validity differs")
    if "values" in cpu:
        require(card.dict_values == cpu["values"]
                and torch.equal(card.dict_codes.cpu()[valid],
                                cpu["codes"][valid]),
                f"{what}: dictionary strings differ")
        return
    if "slab" in cpu:
        require(card.has_slab
                and torch.equal(card.lens.cpu()[valid], cpu["lens"][valid])
                and torch.equal(card.slab64.cpu()[valid],
                                cpu["slab"][valid]),
                f"{what}: slab strings differ")
        return
    got, want = card.data.cpu()[valid], cpu["data"][valid]
    if approx and got.dtype.is_floating_point:
        require(torch.allclose(got, want, rtol=1e-6, atol=1e-9,
                               equal_nan=True), f"{what}: values differ")
        return
    require(torch.equal(got, want), f"{what}: values differ")


def window_phase(rows: int, runs: int, child: subprocess.Popen,
                 queries: dict, report: dict) -> None:
    """The window cases (``testing/windowcases.py``: the JAX package's 22
    and the slab, dictionary and NULL partition keys) on a ``rows``-row
    frame through the session on the card, each timed (median of ``runs``
    warm runs on its cached upload) with no counted sync before the
    collect, then every output column held against the CPU session's
    (``device="cpu"``, computed by ``child`` meanwhile)."""
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.sql.window import Window
    from spark_rapids_tpu_torch.testing import windowcases as WC
    t0 = time.perf_counter()
    frames = _window_frames(rows)
    report["window_gen_s"] = time.perf_counter() - t0
    # one session: the cases that share a frame share its cached upload
    sess = _window_session("cuda", rows)
    bases = {extra: sess.create_dataframe(f) for extra, f in frames.items()}
    cards, recs = {}, {}
    for name, (extra, query, _approx) in WC.CASES.items():
        qdf = query(SF_, Window, bases[extra])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qdf.collect_batches()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        out, walls, launches = run_query(f"window {name}",
                                         qdf.collect_batches, runs)
        require_syncs(f"window {name}", qdf.collect_batches, 0)
        cards[name] = out
        recs[name] = {"sf": None, "rows": rows, "upload_s": cold,
                      "wall_s": float(np.median(walls)), "wall_runs_s": walls,
                      "launches": launches, "counted_syncs": 0}
        del qdf
    del sess, bases
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = child.wait(timeout=600)
    report["window_cpu_wait_s"] = time.perf_counter() - t0
    with open(os.path.join(WINDOW_CPU_DIR, "child.log")) as f:
        tail = f.read()[-2000:]
    require(rc == 0, f"window phase: the CPU session's process failed "
            f"({rc}): {tail}")
    with open(os.path.join(WINDOW_CPU_DIR, "done.json")) as f:
        report["window_cpu"] = json.load(f)
    for name, (_extra, _q, approx) in WC.CASES.items():
        cpu = torch.load(os.path.join(WINDOW_CPU_DIR, f"{name}.pt"),
                         weights_only=False)
        card = cards.pop(name)
        require(len(card) == len(cpu), f"window {name}: batch counts differ")
        for bc, bh in zip(card, cpu):
            require(int(bc.num_rows.item()) == bh["num_rows"]
                    and list(bc.schema.names) == bh["names"],
                    f"window {name}: rows or columns differ")
            for cname, cc, ch in zip(bh["names"], bc.columns, bh["cols"]):
                _same_window_column(cc, ch, approx,
                                    f"window {name} {cname}")
        queries[f"window_{name}"] = recs[name]
    total = sum(r["wall_s"] for r in recs.values())
    report["window_phase"] = {"rows": rows, "cases": len(recs),
                              "wall_s_sum": total}
    log(f"window phase: {len(recs)} cases over {rows} rows equal to the CPU "
        f"session (its process {report['window_cpu']['s']:.1f} s, waited "
        f"{report['window_cpu_wait_s']:.1f} s); card walls sum "
        f"{total:.4f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes: build and check the kernels and "
                         "the queries, no full-size timing")
    ap.add_argument("--window-cpu", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.window_cpu:
        return window_cpu_child(args.window_cpu)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port first: a checkout without it fails here, before any file
    # is written
    import spark_rapids_tpu_torch.session  # noqa: F401
    # the window phase's CPU side, started by ``run`` after the kernels
    # are timed, runs meanwhile in a process of its own
    children: list = []
    try:
        return run(args, children)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()


WINDOW_ROWS = 1 << 23
WINDOW_ROWS_QUICK = 1 << 16
# the ETL at SF 250, the other three at SF 500: the smoke keeps within
# its time limit (the ETL at SF 500 on one H100: 7.46 s warm, 31.0 GiB
# peak, equal to pandas; PERF.md)
MORTGAGE_SF = 500
MORTGAGE_ETL_SF = 250
MORTGAGE_RUNS = 2
MORTGAGE_BATCH_ROWS = 1 << 20


def run(args, children: list) -> int:
    import pandas as pd
    import pyarrow
    from spark_rapids_tpu_torch.models import q1_step as Q
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.models import tpch_joins as J
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_scan as S
    from spark_rapids_tpu_torch.ops import cudalib
    from spark_rapids_tpu_torch.sql import parquet_raw as praw

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} pyarrow {pyarrow.__version__}")
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
    report = {"card": card, "quick": args.quick,
              "pyarrow": pyarrow.__version__}
    pq_dir = os.path.join("spark_rapids_tpu_torch", "build", "tpch_parquet")

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
    kernels = [check_compaction(b1_rows, 1 << 20, gen),
               check_hash_agg(b2_rows, b2_keys, q18_part, gen)]
    torch.cuda.empty_cache()
    kernels += check_hash_join(b34_rows, b34_cap, b34_live, b34_probe, gen)
    for k in kernels:
        log(f"kernel {k['name']}: ms {k['ms']:.4f} plain {k['plain_ms']:.4f}"
            f" bound {k['bound_ms']:.4f} err {k['max_abs_err']}")
    b3 = _by_name(kernels, "hash_table_build")
    log(f"kernel hash_table_build: bound {b3['bound_ms']:.4f} (with the state "
        f"word, as counted before: {b3['old_bound_ms']:.4f})")
    b2 = _by_name(kernels, "hash_grouped_aggregate")
    log(f"kernel hash_grouped_aggregate: bound {b2['bound_ms']:.4f} (a "
        f"sector a table array, as counted before: "
        f"{b2['old_bound_ms']:.4f})")
    b4 = _by_name(kernels, "hash_table_probe")
    log(f"kernel hash_join_lookup: ms {b4['lookup_ms']:.4f} plain "
        f"{b4['lookup_plain_ms']:.4f} bound {b4['lookup_bound_ms']:.4f} "
        f"({b4['lookup_bound_bytes']} bytes, {b4['timed_hits']} hits)")
    b1 = _by_name(kernels, "compact_permutation")
    log(f"kernel compact_permutation: {b1['rows']} rows ms {b1['ms']:.4f} "
        f"argsort {b1['library_ms']:.4f} cumsum {b1['cumsum_ms']:.4f}; "
        f"{b1['small_rows']} rows ms {b1['small_ms']:.4f} argsort "
        f"{b1['small_argsort_ms']:.4f} cumsum {b1['small_cumsum_ms']:.4f} "
        f"bound {b1['small_bound_ms']:.4f}; floor {b1['floor_ms']:.4f}")
    torch.cuda.empty_cache()
    # after the kernels' timing, which a busy host would slow
    child = start_window_cpu(WINDOW_ROWS_QUICK if args.quick
                             else WINDOW_ROWS)
    children.append(child)

    queries = {}
    runs = 1 if args.quick else 5
    pq_runs = 1 if args.quick else 3
    runs_new = 1 if args.quick else 3  # the cells of the sorted branches
    # the runners' Parquet queries take 1 timed run, the session's 3: the
    # session's Parquet phases and the Mortgage and window phases need the
    # smoke's time
    runner_pq_runs = 1

    t0 = time.perf_counter()
    df = G.gen_lineitem(sf_q1)
    report["gen_q1_s"] = time.perf_counter() - t0
    log(f"lineitem SF{sf_q1}: {len(df)} rows, {report['gen_q1_s']:.1f} s")

    t0 = time.perf_counter()
    batches = Q.upload_batches(df, Q.Q1_COLUMNS, q1_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0
    out, walls, launches = run_query(
        "Q1", lambda: Q.q1_from_batches(batches).to_pandas(), runs)
    q1_want = q1_reference(df)
    err = check_q1(out, q1_want)
    q1_runner = out
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
    q6_want = q6_reference(df)
    err = _rel_err([out.revenue[0]], [q6_want])
    require(len(out) == 1 and err <= F64_RTOL, f"Q6 revenue differs: {err}")
    require_syncs("Q6", lambda: Q.q6_from_batches(batches), 0)
    require(launches["compact_permutation"] > 0, "Q6 ran no compaction")
    queries["q6"] = query_record(sf_q1, len(df), len(batches), up, walls,
                                 err, launches)
    q6_runner = out
    del batches
    torch.cuda.empty_cache()

    # the same queries through the port's TpuSparkSession
    sess = session_of(q1_batch)
    tables = {"lineitem": sess.create_dataframe(df)}
    out, rec = run_session_query("session Q1", T.q1(sess, tables), runs,
                                 queries["q1"], sf_q1, len(df))
    rec["max_rel_err"] = max(check_q1(out, q1_want),
                             same_by_key(out, q1_runner, ["l_returnflag",
                                                          "l_linestatus"],
                                         "session Q1 against the runner"))
    keys = list(out.l_returnflag + out.l_linestatus)
    require(keys == sorted(keys), "session Q1 is not in the query's order")
    require(rec["launches"]["compact_permutation"] > 0,
            "session Q1 ran no compaction")
    queries["session_q1"] = rec
    out, rec = run_session_query("session Q6", T.q6(sess, tables), runs,
                                 queries["q6"], sf_q1, len(df))
    err = _rel_err([out.revenue[0]], [q6_want])
    require(len(out) == 1 and err <= F64_RTOL,
            f"session Q6 revenue differs: {err}")
    rec["max_rel_err"] = max(err, same_by_key(out, q6_runner, ["revenue"],
                                              "session Q6 against the "
                                              "runner"))
    queries["session_q6"] = rec
    # a lineitem group-by on four dictionary keys whose joint table,
    # 4 x 3 x 51 x 12 = 7344 slots (a slot each for null), passes the
    # dictionary branch's 4096: the row-space branch, its slot attempt
    # read by one counted sync a call. It reads Q1's seven columns, so it
    # runs on Q1's cached upload.
    from spark_rapids_tpu_torch.sql import functions as SF_
    rs_keys = ["l_returnflag", "l_linestatus", "l_quantity", "l_discount"]
    cutoff = datetime.date(1998, 9, 2)
    out, rec = run_session_cell(
        "session rowspace group-by", tables["lineitem"]
        .filter(SF_.col("l_shipdate") <= cutoff).group_by(*rs_keys)
        .agg(SF_.sum("l_extendedprice").alias("sum_price"),
             SF_.sum("l_tax").alias("sum_tax"),
             SF_.count("*").alias("n")), runs_new, sf_q1, len(df), 0,
        ("rowspace",))
    f = df[df.l_shipdate <= np.datetime64(cutoff)]
    want = (f.groupby(rs_keys, as_index=False)
            .agg(sum_price=("l_extendedprice", "sum"),
                 sum_tax=("l_tax", "sum"), n=("l_extendedprice", "size")))
    rec["max_rel_err"] = same_by_key(out, want, rs_keys,
                                     "session rowspace group-by")
    queries["session_rowspace_groupby"] = rec
    sess.clear_device_cache()
    del sess, tables
    torch.cuda.empty_cache()

    # Q3 and Q4 reuse the lineitem frame of Q1/Q6
    t0 = time.perf_counter()
    frames = {"lineitem": df, "orders": G.gen_orders(sf_q1),
              "customer": G.gen_customer(sf_q1)}
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
    q3_want = q3_reference(df, frames["orders"], frames["customer"])
    err = check_q3(out, q3_want)
    q3_runner = out
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
    q4_want = q4_reference(df, frames["orders"])
    require(list(out.o_orderpriority) == list(q4_want.o_orderpriority)
            and list(out.order_count) == list(q4_want.order_count),
            f"Q4 differs from pandas: {out} vs {q4_want}")
    require_syncs("Q4", lambda: J.q4_from_batches(tables), 0)
    require(launches["hash_table_build"] > 0
            and launches["hash_table_probe"] > 0,
            "Q4 did not run B3 and B4")
    queries["q4"] = query_record(sf_q1, q4_rows, sum(map(len,
                                                         tables.values())),
                                 up, walls, 0.0, launches)
    queries["q4"]["order_count"] = int(out.order_count.sum())
    q4_runner = out
    del tables
    torch.cuda.empty_cache()

    # Q3 and Q4 through the session: cached scans; at SF10 every table is
    # far above autoBroadcastJoinThreshold, so both plan shuffled joins
    sess = session_of(q1_batch, **T.HASH_AGG_CONFS)
    tables = {n: sess.create_dataframe(f) for n, f in frames.items()}
    q3_df = T.q3(sess, tables)
    require(join_execs(sess, q3_df) == {"TpuShuffledHashJoinExec": 2,
                                        "TpuBroadcastHashJoinExec": 0},
            "session Q3 did not plan two shuffled joins")
    out, rec = run_session_query("session Q3", q3_df, runs, queries["q3"],
                                 sf_q1, q3_rows, syncs=2)
    rec["max_rel_err"] = max(check_q3(out, q3_want),
                             check_q3(out, q3_runner))
    require(joined_on_device(rec) and all(rec["launches"][k] > 0 for k in (
        "hash_grouped_aggregate", "compact_permutation")),
        f"session Q3 did not run B1, B2, and B3/B4 or the dense route: "
        f"{rec['launches']} {rec['routes']}")
    queries["session_q3"] = rec
    session_q3 = out
    out, rec = run_session_query("session Q4", T.q4(sess, tables), runs,
                                 queries["q4"], sf_q1, q4_rows)
    require(list(out.o_orderpriority) == list(q4_want.o_orderpriority)
            == list(q4_runner.o_orderpriority)
            and list(out.order_count) == list(q4_want.order_count)
            == list(q4_runner.order_count),
            f"session Q4 differs: {out} vs {q4_want}")
    require(joined_on_device(rec), f"session Q4 did not run B3 and B4 or "
            f"the dense route: {rec['launches']} {rec['routes']}")
    rec["max_rel_err"] = 0.0
    queries["session_q4"] = rec
    # Q3 with its first join broadcast: the threshold at the orders
    # frame's estimate, below lineitem's (the scans stay cached)
    threshold = tables["orders"]._plan.estimated_size_bytes()
    sess.set_conf("spark.rapids.sql.autoBroadcastJoinThreshold", threshold)
    q3_df = T.q3(sess, tables)
    require(join_execs(sess, q3_df) == {"TpuShuffledHashJoinExec": 1,
                                        "TpuBroadcastHashJoinExec": 1},
            "session Q3 with a broadcast did not plan one of each join")
    out, rec = run_session_query("session Q3 broadcast", q3_df, runs,
                                 queries["q3"], sf_q1, q3_rows, syncs=2)
    rec["max_rel_err"] = max(check_q3(out, q3_want),
                             check_q3(out, session_q3))
    rec["threshold_bytes"] = threshold
    queries["session_q3_broadcast"] = rec

    sorted_branch_cells(sess, tables, frames, sf_q1, runs_new, queries,
                        report, q3_want, session_q3)
    t0 = time.perf_counter()
    tpch_cells(sess, tables, frames, sf_q1, runs_new, queries, report)
    report["tpch_cells_s"] = time.perf_counter() - t0
    sess.clear_device_cache()
    del sess, tables, q3_df
    for name in ("supplier", "part", "nation"):
        del frames[name]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # 2^22 rows: the Mortgage and window phases need the smoke's time
    string_phase(1 << 16 if args.quick else 1 << 22, runs_new, report)
    report["string_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # the device Parquet scan: the same rows as Parquet files
    t0 = time.perf_counter()
    paths = G.write_parquet(os.path.join(pq_dir, f"sf{sf_q1}"), sf_q1,
                            frames=frames)
    edge = write_edge_files(os.path.join(pq_dir, "edge"))
    report["write_parquet_s"] = time.perf_counter() - t0
    log(f"parquet SF{sf_q1}: {report['write_parquet_s']:.1f} s, "
        + ", ".join(f"{t} {os.path.getsize(p) / 1e6:.1f} MB "
                    f"{praw.file_metadata(p).num_row_groups} row groups"
                    for t, p in paths.items()))
    report["encodings"] = check_encodings(paths)
    decode = check_decode(paths, edge, G.ROW_GROUP_ROWS)
    kernels += decode
    for k in decode:
        log(f"kernel {k['name']}: ms {k['ms']:.4f} plain {k['plain_ms']:.4f}"
            f" bound {k['bound_ms']:.4f} floor {k['floor_ms']:.4f} checks "
            f"{k['checks']}")
    b7 = _by_name(kernels, "plain_fixed")
    log(f"kernel plain_fixed row group: {b7['rowgroup_segments']} streams "
        f"ms {b7['rowgroup_ms']:.4f} clones {b7['rowgroup_clones_ms']:.4f} "
        f"plain {b7['rowgroup_plain_ms']:.4f} bound "
        f"{b7['rowgroup_bound_ms']:.4f}; one stream ms {b7['ms']:.4f} "
        f"clone {b7['library_ms']:.4f}")
    b6 = _by_name(kernels, "delta_unpack")
    log(f"kernel delta_unpack row group: {b6['rowgroup_chunks']} chunks "
        f"ms {b6['rowgroup_ms']:.4f}, one call a chunk "
        f"{b6['rowgroup_single_calls_ms']:.4f}, plain "
        f"{b6['rowgroup_plain_ms']:.4f}, bound "
        f"{b6['rowgroup_bound_ms']:.4f}; l_orderkey ms {b6['ms']:.4f} "
        f"floor {b6['floor_ms']:.4f} bound {b6['bound_ms']:.4f}")
    b5 = _by_name(kernels, "hybrid_expand")
    log(f"kernel hybrid_expand row group: {b5['rowgroup_streams']} streams "
        f"ms {b5['rowgroup_ms']:.4f}, one call a stream "
        f"{b5['rowgroup_single_calls_ms']:.4f}, plain "
        f"{b5['rowgroup_plain_ms']:.4f}, bound "
        f"{b5['rowgroup_bound_ms']:.4f}; one stream ms {b5['ms']:.4f}")
    torch.cuda.empty_cache()
    rgs = {t: praw.file_metadata(p).num_row_groups for t, p in paths.items()}

    def collect(batch, full):
        return batch.to_pandas() if full else batch

    out, rec = run_parquet_query(
        "Q1 parquet", lambda: S.scan_table(paths["lineitem"], Q.Q1_COLUMNS),
        lambda t, full: collect(Q.q1_from_batches(t), full), runner_pq_runs,
        rgs["lineitem"], 0)
    rec.update(sf=sf_q1, rows=len(df), max_rel_err=check_q1(out, q1_want))
    queries["q1_parquet"] = rec
    pq_out = {"q1": out}

    out, rec = run_parquet_query(
        "Q6 parquet", lambda: S.scan_table(paths["lineitem"], Q.Q6_COLUMNS),
        lambda t, full: collect(Q.q6_from_batches(t), full), runner_pq_runs,
        rgs["lineitem"], 0)
    err = _rel_err([out.revenue[0]], [q6_want])
    require(len(out) == 1 and err <= F64_RTOL, f"Q6 parquet differs: {err}")
    rec.update(sf=sf_q1, rows=len(df), max_rel_err=err)
    queries["q6_parquet"] = rec
    pq_out["q6"] = out
    torch.cuda.empty_cache()

    out, rec = run_parquet_query(
        "Q3 parquet", lambda: S.scan_tables(paths, J.Q3_COLUMNS),
        lambda t, full: collect(J.q3_from_batches(t), full), runner_pq_runs,
        sum(rgs.values()), 2)
    rec.update(sf=sf_q1, rows=q3_rows, max_rel_err=check_q3(out, q3_want))
    require(rec["launches"]["hash_table_build"] > 0,
            "Q3 parquet ran no join")
    queries["q3_parquet"] = rec
    pq_out["q3"] = out
    torch.cuda.empty_cache()

    out, rec = run_parquet_query(
        "Q4 parquet", lambda: S.scan_tables(paths, J.Q4_COLUMNS),
        lambda t, full: collect(J.q4_from_batches(t), full), runner_pq_runs,
        rgs["lineitem"] + rgs["orders"], 0)
    require(list(out.o_orderpriority) == list(q4_want.o_orderpriority)
            and list(out.order_count) == list(q4_want.order_count),
            f"Q4 parquet differs from pandas: {out} vs {q4_want}")
    rec.update(sf=sf_q1, rows=q4_rows, max_rel_err=0.0)
    queries["q4_parquet"] = rec
    pq_out["q4"] = out
    torch.cuda.empty_cache()

    cust = frames["customer"]
    out, rec = run_parquet_query(
        "customer collect parquet",
        lambda: S.scan_table(paths["customer"]),
        lambda t, full: collect(S.customer_segment_batches(t), full),
        runner_pq_runs, rgs["customer"], 0)
    want = cust[cust.c_mktsegment == "BUILDING"].reset_index(drop=True)
    require(list(out.columns) == list(want.columns)
            and len(out) == len(want), "customer collect: shape differs")
    for c in want.columns:
        require(list(out[c]) == list(want[c]),
                f"customer collect: {c} differs from pandas")
    require(rec["launches"]["slab_pack"] > 0, "customer scan ran no B8")
    rec.update(sf=sf_q1, rows=len(cust), max_rel_err=0.0,
               rows_out=len(out))
    queries["customer_parquet"] = rec
    pq_out["customer"] = out

    del frames, df, cust, pq_out
    torch.cuda.empty_cache()

    df = G.gen_lineitem(sf_q18)
    t0 = time.perf_counter()
    batches = Q.upload_batches(df, Q.Q18_COLUMNS, q18_batch)
    torch.cuda.synchronize()
    up = time.perf_counter() - t0

    def q18():
        grouped, having = Q.q18_agg_from_batches(batches)
        return grouped.to_pandas(), having.to_pandas()
    (grouped, having), walls, launches = run_query("Q18 group-by", q18,
                                                   runs)
    q18_want = df.groupby("l_orderkey").l_quantity.sum()

    def check_q18(grouped, having) -> float:
        got = grouped.sort_values("l_orderkey")
        require(np.array_equal(got.l_orderkey.to_numpy(),
                               q18_want.index.to_numpy()),
                "Q18 group keys differ")
        err = _rel_err(got.sum_qty, q18_want.to_numpy())
        require(err <= F64_RTOL, f"Q18 sums differ: rel {err}")
        want_h = q18_want[q18_want > 300]
        got_h = having.sort_values("l_orderkey")
        require(np.array_equal(got_h.l_orderkey.to_numpy(),
                               want_h.index.to_numpy())
                and np.allclose(got_h.sum_qty, want_h.to_numpy(),
                                rtol=F64_RTOL, atol=0), "Q18 having differs")
        return err
    err = check_q18(grouped, having)
    require_syncs("Q18", lambda: Q.q18_agg_from_batches(batches), 0)
    require(launches["hash_grouped_aggregate"] > 0
            and launches["compact_permutation"] > 0,
            "Q18 did not run both kernels")
    queries["q18_groupby"] = query_record(sf_q18, len(df), len(batches), up,
                                          walls, err, launches)
    queries["q18_groupby"].update(groups=len(grouped), having_rows=len(having))
    # the runner as the session collects it: the having rows only (the
    # timed runner above also copies every group to the host)
    having_only, walls_h, _ = run_query(
        "Q18 group-by, having rows only",
        lambda: Q.q18_agg_from_batches(batches)[1].to_pandas(), runs)
    same_by_key(having_only, having, ["l_orderkey"],
                "Q18 having rows, two timings")
    queries["q18_groupby"]["having_only_wall_s"] = float(np.median(walls_h))
    del batches

    # the Q18 group-by through the session, on the hash branch, beside the
    # runner that collects the same rows
    sess = session_of(q18_batch, **T.HASH_AGG_CONFS)
    li_q18 = {"lineitem": sess.create_dataframe(df)}
    out, rec = run_session_query(
        "session Q18 group-by", T.q18_groupby(sess, li_q18), runs,
        {"wall_s": queries["q18_groupby"]["having_only_wall_s"]}, sf_q18,
        len(df))
    rec["runner_full_result_wall_s"] = queries["q18_groupby"]["wall_s"]
    want_h = q18_want[q18_want > 300]
    rec["max_rel_err"] = max(
        same_by_key(out, pd.DataFrame({"l_orderkey": want_h.index,
                                       "sum_qty": want_h.to_numpy()}),
                    ["l_orderkey"], "session Q18 against pandas"),
        same_by_key(out, having, ["l_orderkey"],
                    "session Q18 against the runner"))
    require(rec["launches"]["hash_grouped_aggregate"] > 0
            and rec["launches"]["compact_permutation"] > 0,
            "session Q18 did not run B1 and B2")
    rec["having_rows"] = len(out)
    queries["session_q18_groupby"] = rec
    # the same query and upload at the default confs: the sorted-payload
    # branch beside B2
    sess.set_conf("spark.rapids.sql.agg.hashAggEnabled", False)
    out, rec = run_session_cell(
        "session Q18 group-by default confs", T.q18_groupby(sess, li_q18),
        runs_new, sf_q18, len(df), 0, ("sorted_payload",))
    rec["max_rel_err"] = max(
        same_by_key(out, pd.DataFrame({"l_orderkey": want_h.index,
                                       "sum_qty": want_h.to_numpy()}),
                    ["l_orderkey"], "session Q18 default against pandas"),
        same_by_key(out, having, ["l_orderkey"],
                    "session Q18 default against the runner"))
    rec["hash_wall_s"] = queries["session_q18_groupby"]["wall_s"]
    queries["session_q18_groupby_default"] = rec
    sess.clear_device_cache()
    del sess
    torch.cuda.empty_cache()

    # SF1 files of lineitem, orders and customer: the Q18 group-by's, and
    # the session's Parquet cells (run at SF1 to keep the smoke within
    # half its time limit; the runners' Parquet cells above are SF10)
    frames1 = {"lineitem": df, "orders": G.gen_orders(sf_q18),
               "customer": G.gen_customer(sf_q18)}
    paths1 = G.write_parquet(os.path.join(pq_dir, f"sf{sf_q18}"), sf_q18,
                             frames=frames1)
    path18 = paths1["lineitem"]
    session_parquet_cells(paths1, frames1, sf_q18, q1_batch, pq_runs,
                          queries)
    # Q9 from files: part, partsupp, supplier and nation beside them
    t0 = time.perf_counter()
    frames1.update(supplier=G.gen_supplier(sf_q18), part=G.gen_part(sf_q18),
                   partsupp=G.gen_partsupp(sf_q18), nation=G.gen_nation())
    paths9 = G.write_parquet(os.path.join(pq_dir, f"sf{sf_q18}"), sf_q18,
                             tables=["part", "partsupp", "supplier",
                                     "nation"], frames=frames1)
    report["write_parquet_q9_s"] = time.perf_counter() - t0
    report["encodings"].update(check_encodings(paths9))
    q9_parquet_cell(dict(paths1, **paths9), frames1, sf_q18, q1_batch,
                    pq_runs, queries)
    del frames1
    torch.cuda.empty_cache()

    def q18_query(t, full):
        grouped, having = Q.q18_agg_from_batches(t)
        return (grouped.to_pandas(), having.to_pandas()) if full else having
    (grouped, having), rec = run_parquet_query(
        "Q18 group-by parquet",
        lambda: S.scan_table(path18, Q.Q18_COLUMNS), q18_query,
        runner_pq_runs,
        praw.file_metadata(path18).num_row_groups, 0)
    rec.update(sf=sf_q18, rows=len(df), max_rel_err=check_q18(grouped,
                                                              having))
    queries["q18_groupby_parquet"] = rec

    # the Q18 group-by through the session from the file, decoded on the
    # card; then with the session's device path off, where the CPU scan
    # decodes the file with pyarrow on the host: the same rows
    rg18 = praw.file_metadata(path18).num_row_groups
    sess = session_of(q1_batch, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.cacheDeviceScans": False}))
    what = "session Q18 group-by parquet"
    out, rec = run_session_parquet(
        what, T.q18_groupby(sess, {"lineitem": sess.read.parquet(path18)}),
        pq_runs, queries["q18_groupby_parquet"], sf_q18, len(df), rg18, 0)
    want_h_df = pd.DataFrame({"l_orderkey": want_h.index,
                              "sum_qty": want_h.to_numpy()})
    rec["max_rel_err"] = max(
        same_by_key(out, having, ["l_orderkey"], what + " against the "
                    "runner"),
        same_by_key(out, want_h_df, ["l_orderkey"], what + " against "
                    "pandas"))
    queries["session_q18_groupby_parquet"] = rec
    host = session_of(q1_batch, **{"spark.rapids.sql.enabled": False})
    what = "session Q18 group-by parquet, host decode"
    host_out, walls, launches = run_query(
        what, T.q18_groupby(host, {"lineitem": host.read.parquet(path18)})
        .collect, 1)
    require(not any(launches.values()), f"{what}: launched a kernel")
    queries["session_q18_groupby_parquet_host"] = {
        "sf": sf_q18, "rows": len(df), "wall_s": walls[0],
        "device_wall_s": rec["wall_s"], "launches": launches,
        "max_rel_err": same_by_key(
            host_out, want_h_df, ["l_orderkey"], what + " against pandas")}
    same_by_key(host_out, out, ["l_orderkey"],
                "session Q18 group-by parquet, host against device decode")
    del sess, host
    del df
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tpcxbb_phase(1 if args.quick else 250, q1_batch, runs_new, queries,
                 report)
    report["tpcxbb_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mortgage_phase(1 if args.quick else MORTGAGE_SF,
                   1 if args.quick else MORTGAGE_ETL_SF,
                   1 if args.quick else MORTGAGE_RUNS, queries, report)
    report["mortgage_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    window_phase(WINDOW_ROWS_QUICK if args.quick else WINDOW_ROWS, runs_new,
                 child, queries, report)
    report["window_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    launches_total = {k["name"]: 0 for k in kernels}
    parquet_launches = dict(launches_total)
    for qname, q in queries.items():
        for name, n in q["launches"].items():
            launches_total[name] += n
            if qname.endswith("_parquet"):
                parquet_launches[name] += n
    session_launches = dict(parquet_launches)
    for name in session_launches:
        session_launches[name] = sum(
            q["launches"][name] for qname, q in queries.items()
            if qname.startswith("session_"))
    for name in ("hybrid_expand", "delta_unpack", "plain_fixed",
                 "slab_pack"):
        require(parquet_launches[name] > 0,
                f"{name} never ran on the Parquet path")
    for name, n in session_launches.items():
        require(n > 0, f"{name} never ran through the session")
    report["session_launches"] = session_launches
    log(f"launches through the session: {session_launches}")
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
        if "upload_s" in q:
            extra = f"upload {q['upload_s']:.1f} s"
        elif "device_wall_s" in q:
            extra = (f"host decode, decoded on the card "
                     f"{q['device_wall_s']:.4f} s")
        elif "cold_s" in q:
            extra = (f"cold {q['cold_s']:.1f} s, {q['row_groups']} row "
                     f"groups, runner {q['runner_wall_s']} s")
        else:
            extra = (f"scan {q['scan_s']:.3f} s, {q['row_groups']} row "
                     f"groups, {q['encoded_bytes'] / 1e6:.1f} MB encoded "
                     f"-> {q['decoded_bytes'] / 1e6:.1f} MB decoded")
        log(f"{name}: SF{q['sf']} {q['rows']} rows, {q['wall_s']:.4f} s, "
            f"{q['rows'] / q['wall_s']:.4g} rows/s, {extra}")
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
