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
  * the device Parquet scan: SF1 lineitem, orders and customer rows and
    the SF10 customer rows written as Parquet files with
    ``models/tpch_data.PARQUET_SPEC`` into the ignored
    ``spark_rapids_tpu_torch/build/tpch_parquet/``, then Q1, Q6, Q3, Q4
    and the Q18 group-by at SF1 and a customer filter-and-collect at SF10
    (every column, strings included) read from those files, with zero
    columns falling back to the host decode, checked against pandas from
    the same rows; then Q1, Q6, Q3, Q4, the customer collect and the
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
  * then the 14 other TPC-H queries at SF10, a string phase, the
    plain-strings phase (``plain_strings_phase``: TPCxBB Q28's plan over
    2^21 reviews of lognormal lengths with 1 MiB outliers, uploaded as
    plain offsets and chars, a group-by, an order-by, and locate and
    replace over the review text, each equal to pandas, and the string
    functions and casts of ``testing/stringcases.py`` over a plain column
    at 2^16 rows, equal to the CPU session), Q9 from Parquet and the 19
    TPCxBB queries at SF 10;
  * the four Mortgage queries (``models/mortgage.py``) through the
    session in 2^20-row batches, the ETL at SF 50 (1.2M performance rows
    expanded 12 times) and the other three at SF 500, each against its
    pandas reference (``testing/mortgagecases.py``), with its peak device
    memory, join routes and launches;
  * the export phase (``export_phase``, right after): the ETL's
    ColumnarRdd export (``ml/columnar_rdd.py``) on the same session's
    SF 50 uploads into the trainer's matrices on the card, held to the
    ETL's collect, its counted syncs by site to the ETL's cold run, B1
    launched;
  * the memory phase (``memory_phase``): under a 2 GiB metered budget,
    Q1 at SF10 spilled device -> host -> disk and faulted back, the
    grace join on Q3 and on Mortgage ``aggregates_with_join``, the
    spillable aggregate on the Q18 group-by at SF10 and an external sort
    of 60M rows, each equal to pandas (the sort to a numpy lexsort) and
    to its in-budget run, every wait counted;
  * the observability phase (``obs_phase``, after the session's Parquet
    cells and Q9; ``--obs-only`` runs it alone): the session Q3 cell on
    its cached SF10 uploads and session Q6 from the SF 0.5 file, each with
    metrics off, at the default (metrics on) and traced with the event
    journal on, median of 3 warm walls, the answers and the counted syncs
    by site the same in all three; one traced Q3 whose Chrome export has a
    span for every operator, whose ``sync.<site>`` spans are its
    sync-ledger entries and ``SYNCS``' counts, and whose journal holds
    its queryStart, queryPlan and queryEnd; Q3 under
    ``spark.rapids.sql.profile.syncEachOp``, each node's device, transfer
    and dispatch seconds summing to its exclusive time; Q3 under
    ``spark.rapids.tpu.debug.transferGuard=disallow`` (sync debug mode
    "error" around the query) with the same syncs; one traced Q9 from
    Parquet, its top spans and sync sites by ``tools/trace_summary.py``
    (artifacts in ``chiprun_out/obs/``);
  * the shuffle phase (``shuffle_phase``, after the observability phase;
    ``--shuffle-only`` runs it alone): the exchange's LOCAL buckets route
    on the session Q3 cell (8 partitions, B1-B4 in each, syncs by site as
    stated), a range-partitioned global sort of SF1 lineitem against a
    numpy lexsort, ``repartition(4)`` of SF1 customer written as 4
    Parquet files on the card, and Q3 at SF1 through the accelerated
    shuffle manager over two executors, in process and over TCP loopback
    sockets (with a connection dropped mid-transfer and retried), each
    equal to pandas, and the warm walls of Q3 on the four routes;
  * the adaptive phase (``adaptive_phase``, after the shuffle phase;
    ``--adaptive-only`` runs it alone at SF1): the session Q3 cell's
    capacity speculation (one cold run, three warm runs with one
    ``speculation.verify`` each, a cut capacity re-executed once and
    relearned), the Q18 group-by's dense composite key at SF1 (and a stale
    bound re-executed and blocklisted), Q1 and Q6 at SF10 with the filter
    fused into the aggregate and without (``fusion_cells``, run on the
    session Q1/Q6 cell's uploads), rollup_q1 on the SF10 upload beside PR
    15's wall, the reuse nodes of Q2, Q11 and Q17, Q3 at SF1 and a
    skewed-key join under ``spark.rapids.sql.adaptive.enabled`` (stages,
    broadcast demotion, skew split, one ``aqe.stageFetch`` a stage) and a
    project/filter chain as one fused stage;
  * the serving phase (``serving_phase``, after the adaptive phase;
    ``--serving-only`` runs it alone at SF1): on the session Q1 cell's
    SF10 uploads (Q3's tables added), Q1, Q6 and Q3 and Q6 over the SF 0.5
    Parquet lineitem
    first single threaded (walls, launches, syncs by site), then 24 jobs
    through a two-worker ``QueryScheduler`` of three weighted tenants
    under the sync debug mode "error": answers equal to pandas, launches
    and syncs the sum of the jobs', plan-cache hits jobs - distinct
    plans; the live monitor read meanwhile; a result-cache repeat with
    no launch and no sync; a cancelled and a timed-out Q3 whose buffers
    are released; a shed burst; then two fleet worker processes on the
    card from the seeded nvcc build directory (no nvcc run), Q1 and Q6
    at SF1 for two tenants equal to their oracles, a rolling restart
    pre-warmed from the fleet's manifest with nothing shed, and a killed
    worker whose job ends "lost" and whose tenant moves;
  * the expression phase (``expression_phase``, after the session's
    Parquet cells): TPC-H Q1 as a rollup and a three-key cube over SF10
    lineitem (the session Q1 cell's cached upload) through B1 and B2,
    explode(split) of 2^20 Zipf-worded reviews
    grouped by word, posexplode of 2^18 tag lists, the ids and rand after
    a filter bit-equal to the CPU session, input_file_name over two files
    of lineitem and of customer, and every case of
    ``testing/exprcases.py`` over 2^18 rows against the CPU session, which
    a child process of this script (``--expr-cpu``) computes meanwhile;
  * the scan-and-write phase (``scan_write_phase``, after the session's
    SF1 Parquet cells, the encoded-page cache on): SF1 lineitem decoded
    from its file, ordered by l_shipdate on the card and written as
    Parquet, read back equal to the frame with no host-decoded column;
    TPC-H Q6 over those files, pruned by their footers' l_shipdate
    statistics, beside Q6 over the unsorted file; lineitem written
    partitioned by (l_returnflag, l_linestatus) and Q1 over its
    directories, then with l_returnflag = 'R', the partition keys made on
    the card (no upload bytes past the data columns' plans); SF1 orders
    as ORC read back stripe-pruned and whole, SF1 customer as CSV under an
    explicit schema, each equal to its frame; Q6 twice through the page
    cache, the warm run reading no file, bit-equal;
  * the window cases of ``testing/windowcases.py`` over 2^20 rows through
    the session on the card, every output column held against the CPU
    session's (``device="cpu"``), which a child process of this script
    (``--window-cpu``) computes while the phases above run.

Each query also runs up to its collect under PyTorch's sync debug mode
"error", where the only host waits allowed are the counted ones
(``obs/syncledger.sync_scope``): a query counts one per expanding join
(Q3 2, Q10 3, Q17 3, Q18 2, Q21 5) and one per collapsed exchange over an
aggregate, a limit or a semi join (its ``exchange.shrink``) on a cold run,
which a warm run under the capacity speculation (the JAX package's
default) replaces with one ``speculation.verify``; one per row-space
aggregation (its slot attempt's verdict) and one per concat past 2^27
padded rows (its live total: the Mortgage ETL's final merge at SF 500),
one per exact image of plain strings (its count of rows tying on 64
bytes), none otherwise, and a Parquet scan one per row group (its
upload).

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
    python3 chip_smoke.py --scan-write-only   # that phase alone, SF1
    python3 chip_smoke.py --obs-only          # the observability phase
    python3 chip_smoke.py --shuffle-only      # the shuffle phase, SF1
    python3 chip_smoke.py --adaptive-only     # the adaptive phase, SF1
    python3 chip_smoke.py --serving-only      # the serving phase, SF1
    python3 chip_smoke.py --export-only       # the export phase, SF 50
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Optional

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
    card), the runners' batch size, and the encoded-page cache off, so
    that every Parquet run reads and uploads its row groups as before the
    cache came (``scan_write_phase`` turns it on, ``PAGE_CACHE_ON``)."""
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = (TpuSparkSession.builder()
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .config("spark.rapids.sql.batchSizeRows", batch_rows)
         .config("spark.rapids.sql.scan.pageCache.enabled", False))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def run_session_query(name: str, query, runs: int, runner: dict,
                      sf, rows: int, warm: dict, syncs: int = 0) -> tuple:
    """A session query: one cold execution (uploads into the session's
    device scan cache; a partial aggregate learns its skip decision), then
    ``runs`` warm ones timed as the runners' are, then the query up to its
    collect under the sync debug mode "error". The runners make ``syncs``
    counted syncs (Q3's two joins, else none); the session's warm run
    makes ``warm``, by site, stated by the caller before the run: with the
    capacity speculation of the JAX package's defaults
    (``spark.rapids.sql.adaptiveCapacity.enabled``) the joins'
    ``join.expandTotals``, the dense routes' ``join.denseVerify`` and the
    collapsed exchanges' ``exchange.shrink`` of the cold runs are all one
    ``speculation.verify`` (the gate was ``syncs`` + the dense
    verifications before speculation came)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    query.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    out, walls, launches = run_query(name, query.collect, runs)
    dense = dense_verifications(query)
    reset_routes()
    got = _syncs_by_site(query.collect_batches)
    require(got == warm, f"{name}: counted syncs before the collect {got}, "
            f"stated {warm}")
    med = float(np.median(walls))
    log(f"{name}: median {med:.4f} s against the runner's "
        f"{runner['wall_s']:.4f} s; counted syncs before the collect "
        f"{got} (runner {syncs}, dense verifications {dense}); "
        f"cold run (upload) {cold:.1f} s; routes {route_counts()}")
    return out, {"sf": sf, "rows": rows, "upload_s": cold, "wall_s": med,
                 "wall_runs_s": walls, "rows_per_s": rows / med,
                 "launches": launches, "counted_syncs": sum(got.values()),
                 "syncs_by_site": got,
                 "dense_verifications": dense, "routes": route_counts(),
                 "runner_wall_s": runner["wall_s"], "runner_syncs": syncs}


# a warm run of a plan with a join or an aggregate over a collapsed
# exchange under the capacity speculation: its joins' totals, dense flags
# and shrink counts in one fetch
VERIFY = {"speculation.verify": 1}


def claimed_by_exchanges(sess, plan) -> set:
    """The ids of the nodes that a collapsed or broadcast exchange of
    ``plan`` folds into its masked concat, by the exchanges' own
    ``claims_filter`` (``exec/tpu.claimed_filter``): they run no batch."""
    from spark_rapids_tpu_torch.exec.tpu import claimed_filter
    return {id(x) for n in plan.walk()
            if getattr(n, "claims_filter", None) is not None
            and n.claims_filter(sess.conf, sess)
            for x in claimed_filter(n.children[0])}


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
                     joins: int, branches: tuple, verify: int = 1) -> tuple:
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
    ``branches`` must have run, the hash branch (B2) not at all. Under the
    capacity speculation (the JAX package's default) the joins', dense
    routes' and exchange shrinks' syncs of the warm run are ``verify``
    ``speculation.verify`` instead (1: every cell here but TPCxBB Q28
    holds a join or an aggregate over a collapsed exchange)."""
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
    by_site = _syncs_by_site(query.collect_batches)
    got = sum(by_site.values())
    torch.cuda.synchronize()
    # the query up to its collect, one run (the sync-checked one)
    to_collect = time.perf_counter() - t0
    taken = dict(A.BRANCHES)
    routes = route_counts()
    shrinks = TPU.CONCAT_SHRINKS["synced"]
    # under the capacity speculation (the JAX package's default) the warm
    # run's joins, dense verifications and exchange shrinks are deferred
    # to one speculation.verify (before it: joins + dense + the rest)
    want = verify + taken.get("rowspace", 0) + shrinks
    require(got == want and by_site.get("speculation.verify", 0) == verify,
            f"{name}: {by_site} counted syncs before the collect, "
            f"expected {want} ({verify} speculation.verify for {joins} "
            f"joins and {dense} dense verifications, {shrinks} concats "
            f"past {TPU.CONCAT_SHRINK_ROWS} rows, branches {taken})")
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
                 "syncs_by_site": by_site,
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
                        rows: int, row_groups: int, own_syncs: int,
                        warm: dict) -> tuple:
    """A session query over Parquet files, decoded on the card, no scan
    cache: one cold execution (a partial aggregate learns its skip
    decision), then ``runs`` timed as the runners' Parquet queries are
    (files to the collect) with no column decoded on the host, then the
    query up to its collect under the sync debug mode "error": one counted
    sync per row group (its upload) plus the query's own, no more than the
    runner's record (``runner``, or None where no runner ran the query on
    these files). Under the capacity speculation (the JAX package's
    default) the warm run's own syncs (joins, dense verifications,
    exchange shrinks) are ``warm``, stated by the caller (one
    ``speculation.verify``, or none where the plan holds no join and no
    aggregate; before it: row groups + ``own_syncs`` + dense)."""
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
    want = dict(warm)
    if row_groups:
        want["scan.upload"] = row_groups
    syncs = sum(want.values())
    reset_routes()
    got = _syncs_by_site(query.collect_batches)
    require(got == want, f"{name}: counted syncs before the collect {got}, "
            f"expected {want} ({own_syncs} own and {dense} dense "
            f"verifications before the speculation)")
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
    # the speculation's one verify stands for the syncs the runner pays
    # its joins with (before it: the dense verifications came off)
    require(runner is None or syncs - want.get("speculation.verify", 0)
            <= runner["counted_syncs"],
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
        rgs["lineitem"], 0, VERIFY)
    rec["max_rel_err"] = check_q1(out, q1_reference(li))
    queries["session_q1_parquet"] = rec
    out, rec = run_session_parquet(
        "session Q6 parquet", T.q6(sess, ptables), runs, None, sf, len(li),
        rgs["lineitem"], 0, VERIFY)
    err = _rel_err([out.revenue[0]], [q6_reference(li)])
    require(len(out) == 1 and err <= F64_RTOL,
            f"session Q6 parquet differs: {err}")
    rec["max_rel_err"] = err
    queries["session_q6_parquet"] = rec
    q3_df = T.q3(sess, ptables)
    out, rec = run_session_parquet(
        "session Q3 parquet", q3_df, runs, None, sf,
        len(li) + len(o) + len(c), sum(rgs.values()), 2, VERIFY)
    rec["max_rel_err"] = check_q3(out, q3_reference(li, o, c))
    rec["joins"] = join_execs(sess, q3_df)
    queries["session_q3_parquet"] = rec
    out, rec = run_session_parquet(
        "session Q4 parquet", T.q4(sess, ptables), runs, None, sf,
        len(li) + len(o), rgs["lineitem"] + rgs["orders"], 0, VERIFY)
    q4_want = q4_reference(li, o)
    require(list(out.o_orderpriority) == list(q4_want.o_orderpriority)
            and list(out.order_count) == list(q4_want.order_count),
            f"session Q4 parquet differs: {out} vs {q4_want}")
    rec["max_rel_err"] = 0.0
    queries["session_q4_parquet"] = rec
    out, rec = run_session_parquet(
        "session customer collect parquet", T.customer_segment(sess, ptables),
        runs, None, sf, len(c), rgs["customer"], 0, {})
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
    # Q17's two readers of its part-lineitem base share one subtree since
    # the shared-subtree pruning (sql/pushdown.py), so its join runs once
    # (before it: 3 joins), and its l_partkey group-by takes the dense
    # composite on warm runs (agg.denseKeys; before it: sorted_payload)
    for qname, qt, joins, branches in (
            ("q10", tables, 3, ("sorted_payload",)),
            ("q17", tables, 2, ("single", "dense")),
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
            # its distinct count with no filter below it: the fused pass,
            # on hash group ids; the other's inner partial carries its
            # filter as a fused mask (exec/fusion.py), which the fused
            # count distinct does not take, as in the JAX package
            # (before the filter fusion: 2)
            require(rec["routes"]["count_distinct"]["hash"] == 1,
                    f"session Q21: fused count distinct {rec['routes']}")
            err = same_in_order(out, want, ["s_name"],
                                [("numwait", False), ("s_name", True)],
                                "session Q21")
        rec["max_rel_err"] = err
        if qname == "q17":
            # the shared-subtree pruning (sql/pushdown.py) hands Q17's two
            # readers of its part-lineitem base one subtree, run once
            rec["shared_subtrees"] = len({
                id(n) for n in sess.physical_plan(qdf._plan).walk()
                if type(n).__name__ == "TpuReuseSubtreeExec"})
            require(rec["shared_subtrees"] == 1,
                    f"session Q17: {rec['shared_subtrees']} shared subtrees")
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
# the queries of NEW_TPCH whose plans hold one reuse node
SHARED_TPCH = ("q2", "q11", "q15")


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
        # sums and their maximum are the same bits; since the logical
        # pruning prunes a shared subtree once, by the union of its
        # readers' columns (sql/pushdown.py), Q2's min-cost subquery and
        # Q11's threshold run once too (before it: Q15 only)
        require(shared == (qname in SHARED_TPCH),
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
        # Q28 holds no join and no aggregate: nothing to speculate
        out, rec = run_session_cell(what, qdf, runs, sf, scanned, joins, (),
                                    verify=0 if qname == "q28" else 1)
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
    slab words and lengths, or plain offsets and chars)."""
    valid = card.validity.cpu()
    require(torch.equal(valid, cpu.validity), f"{what}: validity differs")
    if card.dtype.is_string and cpu.is_plain:
        off = card.offsets.cpu()
        total = int(off[-1])
        require(card.is_plain and torch.equal(off, cpu.offsets)
                and torch.equal(card.chars[:total].cpu(),
                                cpu.chars[:total]),
                f"{what}: plain strings differ")
        return
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


# the plain-strings phase: TPCxBB product reviews of lognormal lengths
# (median 256 bytes, clipped to [1, 65536]) plus 1 MiB outliers, and the
# function cases' rows
PLAIN_REVIEWS = 1 << 21
PLAIN_OUTLIERS = 8
# cut from 2^20 for the smoke's time: the CPU session of the function cases
# took 114.3 s there, 22.9 s at 2^18 (PERF.md §4)
PLAIN_FUNCTION_ROWS = 1 << 16
# the share of reviews opening with one 80-byte boilerplate (ties on 64
# bytes that the exact images settle) and of reviews repeating another's
PLAIN_BOILER = 0.1
PLAIN_REPEATS = 0.02
# counted syncs each cell makes before its collect, by site: an exact
# image of plain strings reads its tie count once (``strings.tieSettle``:
# the group-by's sorted-payload reduce, the sort, and the function cases'
# five comparisons of the plain column with another column, greatest
# comparing twice); Q28 sorts by (split, pr_review_sk), which needs no
# tie count, and its union concatenates two filtered halves that each
# keep the upload's char capacity, so past ``rowops.CONCAT_SHRINK_CHARS``
# (as at 2^21 reviews) the concat reads their live char totals once;
# locate and replace over the reviews read nothing
# and the group-by's warm run, under the capacity speculation, reads its
# exchange's shrink counts in the one speculation.verify
PLAIN_SYNCS = {"q28": {"concat.charTotals": 1},
               "group_by": {"strings.tieSettle": 1,
                            "speculation.verify": 1},
               "order_by_desc": {"strings.tieSettle": 1},
               "review_functions": {},
               "functions": {"strings.tieSettle": 6}}
# the review functions' patterns: "the" opens a tenth of the reviews'
# boilerplate, "we " grows by two bytes as "they "
PLAIN_LOCATE = "the"
PLAIN_REPLACE = ("we ", "they ")


def review_frame(n: int, outliers: int, seed: int = 28):
    """TPCxBB ``product_reviews`` with ``n`` reviews whose text lengths
    are seeded lognormal (median 256 bytes, clipped to [1, 65536]), plus
    ``outliers`` reviews of 1 MiB; a tenth open with one 80-byte
    boilerplate, 2% repeat another review. Built as one byte buffer (pyarrow
    strings from offsets and chars)."""
    import pandas as pd
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    lens = np.clip(np.rint(rng.lognormal(np.log(256.0), 0.75, n)), 1,
                   65536).astype(np.int64)
    lens[rng.choice(n, outliers, replace=False)] = 1 << 20
    boiler_rows = np.flatnonzero((rng.random(n) < PLAIN_BOILER)
                                 & (lens >= 80))
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    chars = alphabet[rng.integers(0, len(alphabet), int(offsets[-1]),
                                  dtype=np.uint8)]
    boiler = np.frombuffer(b"We bought this for the kitchen and after two "
                           b"weeks of daily use we can say that ", np.uint8)
    chars[offsets[boiler_rows][:, None] + np.arange(80)[None, :]] = boiler
    text = pa.LargeStringArray.from_buffers(
        n, pa.py_buffer(offsets), pa.py_buffer(chars)).to_numpy(
            zero_copy_only=False)
    rep_rows = np.flatnonzero(rng.random(n) < PLAIN_REPEATS)
    text[rep_rows] = text[rng.integers(0, n, len(rep_rows))]
    return pd.DataFrame({
        "pr_review_sk": np.arange(1, n + 1, dtype=np.int64),
        "pr_review_rating": rng.integers(1, 6, n).astype(np.int32),
        "pr_item_sk": rng.integers(1, 1 << 16, n).astype(np.int64),
        "pr_user_sk": rng.integers(1, 1 << 20, n).astype(np.int64),
        "pr_review_content": text,
    })


def _syncs_by_site(fn) -> dict:
    """``count_syncs(fn)``, by ``sync_scope`` site."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    before = dict(SYNCS.syncs)
    count_syncs(fn)
    return {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
            if v != before.get(k, 0)}


def _plain_cell(name: str, query, runs: int, report: dict,
                syncs: Optional[dict] = None) -> tuple:
    """A plain-strings cell: cold run (upload) with the collect, whose
    answer it returns, ``runs`` warm ones up to the collect timed, then
    the query up to its collect under the sync debug mode "error", its
    counted syncs by site required to be ``syncs`` (by default
    ``PLAIN_SYNCS[name]``)."""
    want_syncs = PLAIN_SYNCS[name] if syncs is None else syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = query.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    _b, walls, launches = run_query(f"plain {name}", query.collect_batches,
                                    runs)
    syncs = _syncs_by_site(query.collect_batches)
    require(syncs == want_syncs, f"plain {name}: counted syncs "
            f"{syncs}, expected {want_syncs}")
    rec = {"wall_s": float(np.median(walls)), "wall_runs_s": walls,
           "cold_s": cold, "launches": launches, "syncs": syncs,
           "rows_out": len(out), "fallbacks": 0}
    report[name] = rec
    return out, rec


def plain_strings_phase(quick: bool, runs: int, report: dict) -> dict:
    """Plain offsets+chars strings on the card (C.6's repair): (a) TPCxBB
    Q28's plan through the session over ``PLAIN_REVIEWS`` reviews with 1
    MiB outliers (as a slab at the longest value's stride the text would
    ask rows x 1 MiB), a group-by count over the text (its repeated
    reviews), an order-by on the text descending, and ``locate`` and
    ``replace`` over the text, each equal to pandas (Q28 in the query's
    order, column by column);
    (b) the function and cast cases of ``testing/stringcases.py`` over its
    plain column at ``PLAIN_FUNCTION_ROWS`` rows, every output column
    equal to the CPU session's. Test mode, cached uploads, syncs as
    ``PLAIN_SYNCS``."""
    from spark_rapids_tpu_torch.columnar.column import slab_stride_for
    from spark_rapids_tpu_torch.models import tpcxbb as B
    from spark_rapids_tpu_torch.ops import rowops
    from spark_rapids_tpu_torch.session import TpuSparkSession
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.testing import stringcases
    from spark_rapids_tpu_torch.testing import tpcxbbcases as C
    n = 1 << 14 if quick else PLAIN_REVIEWS
    rec: dict = {"reviews": n}
    t0 = time.perf_counter()
    reviews = review_frame(n, 2 if quick else PLAIN_OUTLIERS)
    rec["gen_s"] = time.perf_counter() - t0
    lens = reviews.pr_review_content.str.len().to_numpy()
    rec["content_bytes"] = int(lens.sum())
    sess = session_of(n)
    t = sess.create_dataframe(reviews)
    cells: dict = {}
    t0 = time.perf_counter()
    want = C.pandas_reference("q28", {"product_reviews": reviews})
    rec["q28_pandas_s"] = time.perf_counter() - t0
    # the union's concat reads live char totals only past the shrink
    # (``--quick``'s reviews stay under it)
    q28_syncs = (PLAIN_SYNCS["q28"] if 2 * rec["content_bytes"]
                 > rowops.CONCAT_SHRINK_CHARS else {})
    out, cell = _plain_cell("q28", B.q28(sess, {"product_reviews": t}),
                            runs, cells, q28_syncs)
    # the content column as the scan cached it, beside the slab C.1's rule
    # (the longest value's power-of-two stride) would have asked for
    cols = [b.column("pr_review_content") for _src, parts in
            sess.device_scan_cache.values() for bids in parts.values()
            for b in (sess.buffer_catalog.acquire_batch(i) for i in bids)]
    require(len(cols) == 1 and cols[0].is_plain,
            "plain phase: the review text did not upload as one plain column")
    rec["device_bytes"] = sum(t_.numel() * t_.element_size()
                              for t_ in (cols[0].chars, cols[0].offsets,
                                         cols[0].validity))
    rec["c1_slab_bytes"] = cols[0].capacity * (
        slab_stride_for(int(lens.max()), 1 << 40) + 4 + 1)
    del cols
    log(f"plain phase: {n} reviews, {rec['content_bytes']} bytes of text "
        f"(longest {int(lens.max())}), generated in {rec['gen_s']:.1f} s; "
        f"the uploaded column holds {rec['device_bytes']} device bytes "
        f"where C.1's slab would ask {rec['c1_slab_bytes']}")
    require(len(out) == n and list(out.columns) == list(want.columns),
            "plain Q28: rows or columns differ")
    for c in want.columns:  # elementwise in numpy: 2^21 texts compare fast
        require(np.array_equal(out[c].to_numpy(object),
                               want[c].to_numpy(object)),
                f"plain Q28: column {c} differs from pandas")
    del out, want
    content = SF_.col("pr_review_content")
    t0 = time.perf_counter()
    counts = reviews.pr_review_content.value_counts()
    dups = counts[counts > 1]
    rec["group_by_pandas_s"] = time.perf_counter() - t0
    out, cell = _plain_cell("group_by", t.group_by("pr_review_content").agg(
        SF_.count("*").alias("n")).filter(SF_.col("n") > 1), runs, cells)
    require(len(out) == len(dups) > 0, f"plain group-by: {len(out)} "
            f"repeated reviews, pandas {len(dups)}")
    got = dict(zip(out.pr_review_content, out.n))
    require(all(got.get(k) == v for k, v in dups.items()),
            "plain group-by: counts differ from pandas")
    t0 = time.perf_counter()
    order = reviews.sort_values(["pr_review_content", "pr_review_sk"],
                                ascending=[False, True]).pr_review_sk
    rec["order_by_pandas_s"] = time.perf_counter() - t0
    out, cell = _plain_cell("order_by_desc", t.order_by(
        content.desc(), "pr_review_sk").select("pr_review_sk"), runs, cells)
    require(out.pr_review_sk.tolist() == order.tolist(),
            "plain order-by: order differs from pandas")
    del out, order
    t0 = time.perf_counter()
    text = reviews.pr_review_content
    want_at = (text.str.find(PLAIN_LOCATE) + 1).to_numpy()
    want_text = text.str.replace(*PLAIN_REPLACE, regex=False).to_numpy()
    rec["review_functions_pandas_s"] = time.perf_counter() - t0
    out, cell = _plain_cell("review_functions", t.select(
        "pr_review_sk", SF_.locate(PLAIN_LOCATE, content).alias("at"),
        SF_.replace(content, *PLAIN_REPLACE).alias("text")), runs, cells)
    out = out.sort_values("pr_review_sk")
    require(np.array_equal(out["at"].to_numpy(np.int64), want_at),
            "plain locate: positions differ from pandas")
    require(np.array_equal(out["text"].to_numpy(object), want_text),
            "plain replace: texts differ from pandas")
    rec["review_functions_hits"] = int((want_at > 0).sum())
    sess.clear_device_cache()
    del t, sess, reviews, text, out, want_at, want_text
    torch.cuda.empty_cache()

    # (b) the function and cast cases over the plain column
    rows = 1 << 14 if quick else PLAIN_FUNCTION_ROWS
    frame = stringcases.string_frame(rows)
    table = dict(stringcases.FUNCTION_CASES, **stringcases.parse_cases())
    card_sess = session_of(rows, **stringcases.PARSE_CONF)
    cpu_b = (TpuSparkSession.builder().device("cpu")
             .config("spark.rapids.sql.test.enabled", True)
             .config("spark.rapids.sql.batchSizeRows", rows))
    for k, v in stringcases.PARSE_CONF.items():
        cpu_b.config(k, v)
    df = stringcases.projection(SF_, card_sess, frame, table)
    _plain_cell("functions", df, runs, cells)
    card = df.collect_batches()
    t0 = time.perf_counter()
    cpu = stringcases.projection(SF_, cpu_b.get_or_create(), frame,
                                 table).collect_batches()
    rec["functions_cpu_session_s"] = time.perf_counter() - t0
    require(len(card) == len(cpu), "plain functions: batch counts differ")
    plain_in = sum(c.is_plain for c in card[0].columns)
    for bc, bh in zip(card, cpu):
        for name, cc, ch in zip(bc.schema.names, bc.columns, bh.columns):
            _same_columns(cc, ch, f"plain function {name}")
    rec.update(cells=cells, function_rows=rows, function_cases=len(table),
               plain_outputs=plain_in)
    log(f"plain phase: Q28 {cells['q28']['wall_s']:.4f} s, group-by "
        f"{cells['group_by']['wall_s']:.4f} s, order-by "
        f"{cells['order_by_desc']['wall_s']:.4f} s, locate and replace "
        f"{cells['review_functions']['wall_s']:.4f} s, equal to pandas; "
        f"{len(table)} function cases over {rows} rows equal to the CPU "
        f"session ({plain_in} plain outputs) in "
        f"{cells['functions']['wall_s']:.4f} s, CPU session "
        f"{rec['functions_cpu_session_s']:.1f} s")
    report["plain_strings_phase"] = rec
    return rec


# --- the expression phase (rollup, cube, explode, ids, expression cases) ----

EXPR_CASE_ROWS = 1 << 18  # cut from 2^20 for the smoke's time (PERF.md)
EXPR_CASE_ROWS_QUICK = 1 << 14
EXPR_PARTS = 4
EXPR_BATCH = 1 << 18
EXPR_CPU_DIR = os.path.join("spark_rapids_tpu_torch", "build", "expr_cpu")
EXPLODE_REVIEWS = 1 << 20
EXPLODE_VOCAB = 1 << 16
EXPLODE_BATCH = 1 << 17
TAG_ROWS = 1 << 18
TAG_VOCAB = 4096
NONDET_PARTS = 4
NONDET_BATCH = 1 << 20


def _batches(rows: int, parts: int, batch_rows: int) -> int:
    """Upload batches of ``rows`` rows in ``parts`` contiguous partitions
    of at most ``batch_rows`` rows each batch."""
    per = -(-rows // parts)
    sizes = [max(0, min(per, rows - i * per)) for i in range(parts)]
    return sum(-(-n // batch_rows) for n in sizes if n)


def _partial_concat_syncs(rows: int, batch_rows: int, sets: int) -> dict:
    """The counted syncs of a grouping-sets aggregate's partial pass over
    one partition: each Expand batch's partial keeps its input capacity,
    so their concat reads its live rows once (``concat.liveRows``) where
    the capacities sum past ``exec/tpu.CONCAT_SHRINK_ROWS``."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.exec.tpu import CONCAT_SHRINK_ROWS
    n = _batches(rows, 1, batch_rows)
    cap = bucket_capacity(min(rows, batch_rows))
    return ({"concat.liveRows": 1} if n * sets > 1
            and n * sets * cap > CONCAT_SHRINK_ROWS else {})


def _expr_session(device: str, batch_rows: int = EXPR_BATCH, **conf):
    from spark_rapids_tpu_torch.session import TpuSparkSession
    b = (TpuSparkSession.builder().device(device)
         .config("spark.rapids.sql.test.enabled", True)
         .config("spark.rapids.sql.cacheDeviceScans", True)
         .config("spark.rapids.sql.batchSizeRows", batch_rows))
    for k, v in conf.items():
        b.config(k, v)
    return b.get_or_create()


def expr_cpu_child(rows: int) -> int:
    """The CPU side of the expression cases, in a process of its own
    started with the window child: every case of ``testing/exprcases.py``
    over ``rows`` rows through the session with ``device="cpu"``, its
    output batches saved under EXPR_CPU_DIR."""
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.testing import exprcases as E
    os.nice(19)
    torch.set_num_threads(2)
    os.makedirs(EXPR_CPU_DIR, exist_ok=True)
    t0 = time.perf_counter()
    df = E.frame(rows)
    batches = E.projection(SF_, _expr_session("cpu"), df,
                           num_partitions=EXPR_PARTS).collect_batches()
    torch.save([{"num_rows": int(b.num_rows), "names": list(b.schema.names),
                 "cols": [_expr_column_state(c, int(b.num_rows))
                          for c in b.columns]}
                for b in batches], os.path.join(EXPR_CPU_DIR, "cases.pt"))
    with open(os.path.join(EXPR_CPU_DIR, "done.json"), "w") as f:
        json.dump({"rows": rows, "s": time.perf_counter() - t0}, f)
    return 0


def start_expr_cpu(rows: int) -> subprocess.Popen:
    import shutil
    shutil.rmtree(EXPR_CPU_DIR, ignore_errors=True)
    os.makedirs(EXPR_CPU_DIR, exist_ok=True)
    with open(os.path.join(EXPR_CPU_DIR, "child.log"), "w") as logf:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--expr-cpu",
             str(rows)], stdout=logf, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _expr_column_state(col, n: int) -> dict:
    """A column's first ``n`` rows on the host: validity, and the values
    (strings of any form decoded)."""
    if col.dtype.is_string:
        vals, valid = col.to_numpy(n)
        return {"validity": torch.from_numpy(valid.copy()), "strings": vals}
    return {"validity": col.validity[:n].cpu(), "data": col.data[:n].cpu()}


def _same_expr_column(card, n: int, cpu: dict, approx: bool,
                      what: str) -> None:
    """A card column's first ``n`` rows against the CPU session's: the
    same validity; where valid, strings and integers exact, floats bit
    for bit or (``approx``) within rtol 1e-13 (a subnormal relative to
    the smallest normal double), with NaN, the infinities and the sign of
    zero in the same places."""
    got_state = _expr_column_state(card, n)
    valid = got_state["validity"]
    require(torch.equal(valid, cpu["validity"]), f"{what}: validity differs")
    if "strings" in cpu:
        v = valid.numpy()
        require(np.array_equal(got_state["strings"][v], cpu["strings"][v]),
                f"{what}: strings differ")
        return
    got, want = got_state["data"][valid], cpu["data"][valid]
    if not got.dtype.is_floating_point:
        require(torch.equal(got, want), f"{what}: values differ")
        return
    nan = torch.isnan(got)
    require(torch.equal(nan, torch.isnan(want)), f"{what}: NaN differ")
    g, w = got[~nan], want[~nan]
    require(torch.equal(torch.signbit(g), torch.signbit(w))
            and torch.equal(torch.isinf(g), torch.isinf(w)),
            f"{what}: signs or infinities differ")
    if approx:
        from spark_rapids_tpu_torch.testing.exprcases import RTOL, TINY
        fin = torch.isfinite(g)
        gf, wf = g[fin], w[fin]
        require(torch.equal(g[~fin], w[~fin]) and bool(
            ((gf - wf).abs() <= RTOL * wf.abs().clamp(min=TINY)).all()),
            f"{what}: values differ past rtol {RTOL}")
    else:
        require(torch.equal(g, w), f"{what}: values differ")


# the second run of a plan whose final aggregate reads a collapsed
# exchange over its partial: one exchange.shrink (exec/tpu._shrink)
SECOND_RUN_SHRINK = {"exchange.shrink": 1}


def _expr_cell(name: str, query, rec: dict, want_syncs: dict,
               batches: bool = False, peak: bool = False):
    """One cell: a cold run (uploads into the scan cache) with its
    collect, whose answer it returns, then one warm run up to the collect,
    timed, with the launch counts zeroed before and read after, under the
    sync debug mode "error": its counted syncs by site must be
    ``want_syncs``, stated by the caller (the warm run is the plan's
    second: under the capacity speculation, the JAX package's default, a
    collapsed exchange over an aggregate reads its shrink counts again,
    ``SECOND_RUN_SHRINK``, as they speculate only once two runs agreed).
    ``batches``: return the cold run's device batches instead of a
    frame."""
    from spark_rapids_tpu_torch.ops import kernels as K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = query.collect_batches() if batches else query.collect()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    K.reset_launches()
    if peak:
        # the warm run's peak device bytes past what stood before it
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    syncs = _syncs_by_site(query.collect_batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"expr {name}: {wall:.4f} s warm, cold {cold:.1f} s, syncs "
        f"{syncs}, launches {launches}")
    require(syncs == want_syncs, f"expr {name}: counted syncs {syncs}, "
            f"expected {want_syncs}")
    rec.update({"upload_s": cold, "wall_s": wall, "launches": launches,
                "syncs": syncs, "fallbacks": 0})
    if peak:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def _q1_rollup_reference(q1_want) -> "pd.DataFrame":
    """Q1's groups rolled up from pandas' Q1 answer: sums and counts add,
    each average is its rolled-up sum over the count."""
    import pandas as pd
    w = q1_want.assign(sum_disc=q1_want.avg_disc * q1_want.count_order)
    sums = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "sum_disc", "count_order"]
    parts = [w]
    one = w.groupby("l_returnflag", as_index=False)[sums].sum()
    one["l_linestatus"] = None
    parts.append(one)
    tot = w[sums].sum().to_frame().T
    tot["l_returnflag"] = None
    tot["l_linestatus"] = None
    parts.append(tot)
    out = pd.concat(parts, ignore_index=True)
    out["avg_qty"] = out.sum_qty / out.count_order
    out["avg_price"] = out.sum_base_price / out.count_order
    out["avg_disc"] = out.sum_disc / out.count_order
    out["count_order"] = out.count_order.astype(np.int64)
    return out[list(q1_want.columns)]


def _cube_reference(frame, keys, value: str):
    """cube(keys) of sum(value) and count(*) in numpy: the finest groups
    by bincount over the keys' factorized codes, each grouping set the
    sum over the axes it rolls up (a rolled-up key NULL)."""
    import pandas as pd
    codes, uniq = zip(*(pd.factorize(frame[k]) for k in keys))
    dims = [len(u) for u in uniq]
    flat = np.ravel_multi_index(codes, dims)
    size = int(np.prod(dims))
    n = np.bincount(flat, minlength=size).reshape(dims)
    rev = np.bincount(flat, weights=frame[value].to_numpy(),
                      minlength=size).reshape(dims)
    parts = []
    for r in range(len(keys), -1, -1):
        for kept in itertools.combinations(range(len(keys)), r):
            drop = tuple(i for i in range(len(keys)) if i not in kept)
            shape = [dims[i] for i in kept] or [1]
            cn = np.asarray(n.sum(axis=drop)).reshape(shape)
            cr = np.asarray(rev.sum(axis=drop)).reshape(shape)
            idx = np.nonzero(cn)
            part = {keys[i]: (np.asarray(uniq[i], dtype=object)[
                idx[kept.index(i)]] if i in kept else None)
                for i in range(len(keys))}
            part.update(revenue=cr[idx], n=cn[idx].astype(np.int64))
            parts.append(pd.DataFrame(part))
    return pd.concat(parts, ignore_index=True)[keys + ["revenue", "n"]]


def _rollup_keys(df, keys):
    return df.assign(**{k: df[k].astype(object).where(df[k].notna(),
                                                      "<NULL>")
                        for k in keys})


def _word_reviews(n: int, vocab: int, seed: int = 15):
    """(reviews frame, vocabulary, token counts by word id, words a
    review): ``n`` reviews of 8-64 words each, single-space delimited,
    drawn from a Zipf distribution (exponent 1.1, its inverse CDF at 2^22
    points) over ``vocab`` distinct words of 2-12 letters. Built in numpy:
    each token is its word's row of a 16-byte table (the word and a
    space), the text the table rows' kept bytes in order; pyarrow makes
    the pandas strings."""
    import pandas as pd
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    cand = 2 * vocab
    lens = rng.integers(2, 13, cand)
    starts = np.concatenate([[0], np.cumsum(lens)])
    chars = letters[rng.integers(0, 26, int(starts[-1]))]
    words = [chars[starts[i]:starts[i + 1]].tobytes() for i in range(cand)]
    words = list(dict.fromkeys(words))[:vocab]
    wlen = np.array([len(w) for w in words], np.int64)
    table = np.full((vocab, 16), ord(" "), np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w, np.uint8)
    k = rng.integers(8, 65, n)
    total = int(k.sum())
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    cdf = np.cumsum(p / p.sum())
    steps = 1 << 22
    inverse = np.minimum(np.searchsorted(
        cdf, (np.arange(steps) + 0.5) / steps), vocab - 1)
    ids = inverse[rng.integers(0, steps, total)]
    # each token keeps its word and a space, but the last of its review
    keep = wlen[ids] + 1
    keep[np.cumsum(k) - 1] -= 1
    buf = table[ids][np.arange(16)[None, :] < keep[:, None]]
    ends = np.cumsum(keep)
    offs = np.concatenate([[0], ends[np.cumsum(k) - 1]]).astype(np.int32)
    arr = pa.StringArray.from_buffers(n, pa.py_buffer(offs),
                                      pa.py_buffer(buf))
    frame = pd.DataFrame({"id": np.arange(n, dtype=np.int64),
                          "text": arr.to_pandas()})
    return frame, [w.decode() for w in words], np.bincount(
        ids, minlength=vocab), k


def _tag_lists(n: int, vocab: int, seed: int = 16):
    """``n`` comma-separated lists of 0-8 tags of ``vocab``; 5% NULL, the
    empty lists empty strings."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    names = np.array([f"t{i:03x}" for i in range(vocab)], dtype=object)
    k = rng.integers(0, 9, n)
    tags = rng.integers(0, vocab, int(k.sum()))
    ends = np.cumsum(k)
    lists = [",".join(names[tags[e - c:e]]) for c, e in zip(k, ends)]
    col = np.asarray(lists, dtype=object)
    col[rng.random(n) < 0.05] = None
    return pd.DataFrame({"id": np.arange(n, dtype=np.int64), "tags": col})


def expression_phase(quick: bool, q1_session, q1_want, lineitem10, li1,
                     sfs: tuple, file_pairs, child: subprocess.Popen,
                     queries: dict, report: dict) -> None:
    """The expression slice's cells, each in test mode with its syncs
    counted by site and required to be the ones its sizes predict:
      * rollup_q1: TPC-H Q1's filter and eight aggregates as a rollup of
        (l_returnflag, l_linestatus) over lineitem at SF10 on the session
        Q1 cell's cached upload under HASH_AGG_CONFS (three grouping sets
        into B2), equal to pandas' Q1 rolled up;
      * cube_tax: cube(l_returnflag, l_linestatus, l_tax) of
        sum(l_extendedprice) and count(*) on the same upload (eight sets,
        ~480M expanded rows), equal to numpy;
      * explode_words: explode(split(text, " ")) of review text in
        EXPLODE_BATCH-row batches, grouped by word, equal to the
        generator's bincount;
      * posexplode_tags: posexplode(split(tags, ",")) of tag lists (a
        slab), whole against pandas;
      * nondet_ids: monotonically_increasing_id, spark_partition_id and
        rand(42) after a filter over SF1 lineitem in four partitions,
        bit-equal to the CPU session; input_file_name over two files of
        lineitem and of customer with prefetch, each row group's rows
        labelled with its file, cold and replayed;
      * expr_cases: every case of ``testing/exprcases.py`` on the card
        against the CPU session (``child``, started at the top)."""
    import pandas as pd
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    from spark_rapids_tpu_torch.testing import exprcases as E
    cells: dict = {}
    phase0 = time.perf_counter()

    # rollup_q1 and cube_tax on the session Q1 cell's session, its
    # confs put back after
    sess, tables = q1_session
    saved = dict(sess.conf._settings)
    for k, v in T.HASH_AGG_CONFS.items():
        sess.set_conf(k, v)
    li = tables["lineitem"]
    q1_cols = ["l_returnflag", "l_linestatus", "l_quantity",
               "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    q = _rollup_q1(li)
    rec = {"sf": sfs[0], "rows": len(lineitem10)}
    batch_rows = sess.conf.batch_size_rows
    out = _expr_cell("rollup_q1", q, rec,
                     dict(_partial_concat_syncs(len(lineitem10), batch_rows,
                                                3), **SECOND_RUN_SHRINK),
                     peak=True)
    # the adaptive phase's shrink cell (ROADMAP B.8): the wall and the
    # peak device bytes beside the wall before the shrink
    report.setdefault("adaptive", {})["rollup_q1"] = {
        "wall_s": rec["wall_s"], "syncs": rec["syncs"],
        "peak_bytes": rec["peak_bytes"],
        "before_shrink_wall_s": ROLLUP_Q1_BEFORE_S}
    log(f"adaptive rollup_q1: {rec['wall_s']:.4f} s warm (before the "
        f"shrink: {ROLLUP_Q1_BEFORE_S} s), peak {rec['peak_bytes'] / 1e9:.3f} GB "
        f"over the upload, syncs {rec['syncs']}")
    keys = ["l_returnflag", "l_linestatus"]
    rec["max_rel_err"] = same_by_key(
        _rollup_keys(out, keys), _rollup_keys(_q1_rollup_reference(q1_want),
                                              keys), keys, "expr rollup_q1")
    require(rec["launches"]["hash_grouped_aggregate"] > 0
            and rec["launches"]["compact_permutation"] > 0,
            f"expr rollup_q1 did not run B1 and B2: {rec['launches']}")
    cells["rollup_q1"] = rec
    queries["session_expr_rollup_q1"] = rec

    # the cube reads the same cached upload: its third key is l_tax, a
    # column of it (l_shipmode is not: a new upload of the cube's columns
    # took 45 s on the host, past the phase's budget; PERF.md)
    ckeys = ["l_returnflag", "l_linestatus", "l_tax"]
    q = (li.select(*q1_cols).cube(*ckeys)
         .agg(SF_.sum("l_extendedprice").alias("revenue"),
              SF_.count("*").alias("n")))
    rec = {"sf": sfs[0], "rows": len(lineitem10)}
    out = _expr_cell("cube_tax", q, rec,
                     dict(_partial_concat_syncs(len(lineitem10), batch_rows,
                                                8), **SECOND_RUN_SHRINK))
    t0 = time.perf_counter()
    want = _cube_reference(lineitem10, ckeys, "l_extendedprice")
    rec["reference_s"] = time.perf_counter() - t0
    rec["max_rel_err"] = same_by_key(_rollup_keys(out, ckeys),
                                     _rollup_keys(want, ckeys), ckeys,
                                     "expr cube_tax")
    require(rec["launches"]["hash_grouped_aggregate"] > 0
            and rec["launches"]["compact_permutation"] > 0,
            f"expr cube_tax did not run B1 and B2: {rec['launches']}")
    cells["cube_tax"] = rec
    queries["session_expr_cube_tax"] = rec
    sess.conf._settings = saved
    del want, out, q
    torch.cuda.empty_cache()

    # explode_words
    t0 = time.perf_counter()
    nrev = 1 << 14 if quick else EXPLODE_REVIEWS
    reviews, vocab, counts, words = _word_reviews(nrev, EXPLODE_VOCAB)
    gen_s = time.perf_counter() - t0
    ws = _expr_session("cuda", EXPLODE_BATCH)
    q = (ws.create_dataframe(reviews)
         .with_column("w", SF_.explode(SF_.split(SF_.col("text"), " ")))
         .group_by("w").agg(SF_.count("*").alias("n")))
    rec = {"sf": None, "rows": nrev, "gen_s": gen_s,
           "tokens": int(counts.sum()),
           "text_bytes": int(reviews.text.str.len().sum())}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # a totals read a batch; the string group keys' exact images: one tie
    # count a partial, one for the merge of several partials, one for the
    # final aggregate
    # final aggregate; and the concat of the partials reads its live chars
    # once where their token columns' char capacities (each its batch's)
    # sum past ``rowops.CONCAT_SHRINK_CHARS``
    from spark_rapids_tpu_torch.columnar.column import char_bucket
    from spark_rapids_tpu_torch.ops.rowops import CONCAT_SHRINK_CHARS
    nb = _batches(nrev, 1, EXPLODE_BATCH)
    tok_chars = reviews.text.str.len().to_numpy() - (words - 1)
    caps = sum(char_bucket(int(tok_chars[lo:lo + EXPLODE_BATCH].sum()))
               for lo in range(0, nrev, EXPLODE_BATCH))
    want_syncs = dict(SECOND_RUN_SHRINK, **{
        "generate.totals": nb, "strings.tieSettle": nb + 1 + (nb > 1)})
    if nb > 1 and caps > CONCAT_SHRINK_CHARS:
        want_syncs["concat.charTotals"] = 1
    out = _expr_cell("explode_words", q, rec, want_syncs)
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    got = dict(zip(out.w, out.n))
    want = {w: int(c) for w, c in zip(vocab, counts) if c}
    require(got == want, f"expr explode_words: {len(got)} words against "
            f"the generator's {len(want)}, counts differ")
    cells["explode_words"] = rec
    queries["session_expr_explode_words"] = rec
    ws.stop()
    del ws, q, reviews, out, got, want
    torch.cuda.empty_cache()

    # posexplode_tags
    tags = _tag_lists(1 << 12 if quick else TAG_ROWS, TAG_VOCAB)
    ts = _expr_session("cuda", TAG_ROWS)
    q = ts.create_dataframe(tags).with_column(
        "tag", SF_.posexplode(SF_.split(SF_.col("tags"), ",")))
    rec = {"sf": None, "rows": len(tags)}
    out = _expr_cell("posexplode_tags", q, rec, {
        "generate.totals": _batches(len(tags), 1, TAG_ROWS)})
    want = tags.dropna().assign(tag=lambda f: f.tags.str.split(","))
    want = want.explode("tag")
    want["pos"] = want.groupby(level=0).cumcount().astype(np.int32)
    want = want[["id", "tags", "pos", "tag"]].reset_index(drop=True)
    for f_ in (out, want):
        f_.sort_values(["id", "pos"], inplace=True, kind="stable")
        f_.reset_index(drop=True, inplace=True)
    require(list(out.columns) == list(want.columns) and len(out) == len(
        want) and all(np.array_equal(out[c].to_numpy(object),
                                     want[c].to_numpy(object))
                      for c in ("tags", "tag"))
            and np.array_equal(out.id.to_numpy(), want.id.to_numpy())
            and np.array_equal(out.pos.to_numpy(np.int64),
                               want.pos.to_numpy(np.int64)),
            "expr posexplode_tags differs from pandas")
    rec["rows_out"] = len(out)
    cells["posexplode_tags"] = rec
    queries["session_expr_posexplode_tags"] = rec
    ts.stop()
    del ts, q, tags, out, want
    torch.cuda.empty_cache()

    # nondet_ids: the card against the CPU session, bit for bit
    frame = li1[["l_orderkey", "l_quantity"]]

    def ids_query(s):
        return (s.create_dataframe(frame, NONDET_PARTS)
                .filter(SF_.col("l_quantity") < 25)
                .select(SF_.col("l_orderkey"),
                        SF_.monotonically_increasing_id().alias("mid"),
                        SF_.spark_partition_id().alias("pid"),
                        SF_.rand(42).alias("r")))
    ns = _expr_session("cuda", NONDET_BATCH)
    rec = {"sf": sfs[1], "rows": len(frame)}
    # a filter's batch holds its row count on the device: one read a batch
    card = _expr_cell("nondet_ids", ids_query(ns), rec, {
        "nondet.rowBase": _batches(len(frame), NONDET_PARTS, NONDET_BATCH)})
    t0 = time.perf_counter()
    cpu = ids_query(_expr_session("cpu", NONDET_BATCH)).collect()
    rec["cpu_s"] = time.perf_counter() - t0
    require(len(card) == len(cpu) and all(
        np.array_equal(card[c].to_numpy(), cpu[c].to_numpy())
        for c in ("l_orderkey", "mid", "pid"))
        and np.array_equal(card.r.to_numpy(np.float64).view(np.int64),
                           cpu.r.to_numpy(np.float64).view(np.int64)),
        "expr nondet_ids: the card's ids or rand differ from the CPU's")
    require(sorted(set(card.pid)) == list(range(NONDET_PARTS)),
            "expr nondet_ids: partitions missing")
    cells["nondet_ids"] = rec
    queries["session_expr_nondet_ids"] = rec
    ns.stop()
    del ns, card, cpu, frame

    # input_file_name over two files of lineitem and two of customer
    fs = _expr_session("cuda", NONDET_BATCH)
    rec = {"sf": None, "rows": 0, "files": {}}
    for table, (paths, key) in file_pairs.items():
        q = fs.read.parquet(*paths).select(
            SF_.input_file_name().alias("f"), SF_.col(key))
        for run in ("cold", "replay"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = q.collect_batches()
            torch.cuda.synchronize()
            rec[f"{table}_{run}_s"] = time.perf_counter() - t0
            labels = []
            for b in batches:
                col = b.columns[0]
                n = int(b.num_rows)
                require(col.dict_values is not None
                        and len(col.dict_values) == 1
                        and bool((col.dict_codes[:n] == 0).all()),
                        f"expr input_file {table}: a batch mixes files")
                labels.append((col.dict_values[0], n))
            want = [(p, praw.file_metadata(p).row_group(rg).num_rows)
                    for p in paths
                    for rg in range(praw.file_metadata(p).num_row_groups)]
            require(labels == want, f"expr input_file {table} {run}: "
                    f"labels {labels[:4]}... against {want[:4]}...")
        rec["files"][table] = len(want)
        rec["rows"] += sum(n for _p, n in want)
    syncs = _syncs_by_site(q.collect_batches)
    require(syncs == {}, f"expr input_file: counted syncs {syncs} on the "
            "replay, expected none")
    rec.update(syncs=syncs, fallbacks=0)
    cells["input_file"] = rec
    fs.stop()
    del fs, q, batches

    # expr_cases against the CPU session's process
    t0 = time.perf_counter()
    rows = EXPR_CASE_ROWS_QUICK if quick else EXPR_CASE_ROWS
    df = E.frame(rows)
    gen_s = time.perf_counter() - t0
    es = _expr_session("cuda")
    q = E.projection(SF_, es, df, num_partitions=EXPR_PARTS)
    rec = {"sf": None, "rows": rows, "gen_s": gen_s, "cases": len(E.CASES)}
    card = _expr_cell("expr_cases", q, rec, {}, batches=True)
    t0 = time.perf_counter()
    rc = child.wait(timeout=600)
    rec["cpu_wait_s"] = time.perf_counter() - t0
    with open(os.path.join(EXPR_CPU_DIR, "child.log")) as f:
        tail = f.read()[-2000:]
    require(rc == 0, f"expr_cases: the CPU session's process failed ({rc}): "
            f"{tail}")
    with open(os.path.join(EXPR_CPU_DIR, "done.json")) as f:
        rec["cpu"] = json.load(f)
    cpu = torch.load(os.path.join(EXPR_CPU_DIR, "cases.pt"),
                     weights_only=False)
    require(len(card) == len(cpu), "expr_cases: batch counts differ")
    bad = []
    for bc, bh in zip(card, cpu):
        require(int(bc.num_rows.item()) == bh["num_rows"]
                and list(bc.schema.names) == bh["names"],
                "expr_cases: rows or columns differ")
        for cname, cc, ch in zip(bh["names"], bc.columns, bh["cols"]):
            try:
                _same_expr_column(cc, bh["num_rows"], ch, cname in E.APPROX,
                                  f"expr_cases {cname}")
            except AssertionError as e:  # every differing case, then fail
                bad.append(str(e))
    require(not bad, f"expr_cases: {sorted(set(bad))}")
    cells["expr_cases"] = rec
    queries["session_expr_cases"] = rec
    es.stop()
    del es, q, card, cpu, df
    torch.cuda.empty_cache()
    report["expression_phase"] = cells
    log(f"expression phase: {len(cells)} cells in "
        f"{time.perf_counter() - phase0:.1f} s, syncs "
        + ", ".join(f"{k} {v.get('syncs')}" for k, v in cells.items()))


def q9_parquet_cell(paths: dict, frames: dict, sf, batch_rows: int,
                    runs: int, queries: dict):
    """TPC-H Q9 through the session from Parquet files (lineitem, orders,
    part, partsupp, supplier and nation at ``sf``, ``PARQUET_SPEC``):
    decoded on the card with no column falling back to the host (p_name a
    PLAIN byte array, so B8 builds the slab its ``contains`` reads), equal
    to pandas. Returns its answer."""
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
        expanding_joins(sess, qdf), VERIFY)
    require(len(out) > 0, "session Q9 parquet returned no rows")
    rec["max_rel_err"] = same_query(out, TC.pandas_reference("q9", frames),
                                    "q9", "session Q9 parquet")
    require(rec["launches"]["slab_pack"] > 0,
            "session Q9 parquet ran no B8")
    queries["session_q9_parquet"] = rec
    return out


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
    must launch B1. Returns the frames at ``sf`` and the answer of
    ``aggregates_with_join`` (the memory phase reuses both), and the ETL's
    session, DataFrame and collected answer (``export_phase`` exports the
    same ETL on the same cached uploads)."""
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
    answers = {}
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
        if name == "aggregates_with_join":
            answers[name] = out
        if name == "etl":
            etl = (sess, qdf, out)
        del out, want, qdf, sess
        torch.cuda.empty_cache()
    report["mortgage_launches"] = totals
    log(f"Mortgage launches: {totals}")
    require(totals.get("compact_permutation", 0) > 0,
            "Mortgage: B1 never ran")
    return (tables[sf], answers), etl


# the ColumnarRdd export: the ETL's answer through
# ``ml/columnar_rdd.py`` to the trainer's matrices on the card
EXPORT_CONF = {"spark.rapids.sql.exportColumnarRdd": True}
# a sync of these sites moves batches to the host: none may be the
# export's
TRANSFER_SITES = ("batch.fetch", "batch.rowCount", "write.fetch",
                  "aqe.stageFetch")
EXPORT_BUDGET_S = 30.0


def _forget_speculation(sess) -> None:
    """Drop what the session learned from earlier runs (capacities,
    shrink counts, dense keys, skip ratios), so the next run is cold as
    its first was; the cached uploads and scan statistics stay."""
    for d in (sess.capacity_cache, sess.agg_ratio_cache):
        d.clear()
    for st in (sess.capacity_spec_blocklist, sess.dense_plans_seen):
        while len(st):
            st.pop_oldest()


def export_phase(etl, report: dict) -> dict:
    """The Mortgage ETL's ColumnarRdd export on its SF 50 session (the JAX
    package's default confs, test mode, cached uploads, no new upload)
    with ``spark.rapids.sql.exportColumnarRdd``: every partition of
    ``ColumnarRdd.convert`` drained into the trainer's matrices
    (``testing/exportcheck.drain``: ``to_feature_matrix`` over the ETL's
    numeric and boolean columns, label ``delinquency_12``) under the sync
    debug mode "error", with nothing learned (``_forget_speculation``)
    and the launch counts zeroed before and read after. Requires: every
    ``x``, ``y`` and ``mask`` a CUDA tensor; the live rows equal to the
    ETL's collect of ``mortgage_phase`` (``exportcheck.same_rows``: keys
    and integer-valued columns exact, floats at rtol 1e-6 after the
    float32 cast); the counted syncs by site those of the same ETL's cold
    run up to its collect, none of a site that moves batches to the host;
    B1 launched. Logs the wall, the matrices' rows and bytes and the peak
    device bytes."""
    from spark_rapids_tpu_torch.ml import ColumnarRdd
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.testing import exportcheck as X
    sess, qdf, want = etl
    t_phase = time.perf_counter()
    for k, v in EXPORT_CONF.items():
        sess.set_conf(k, v)
    drained: list = []

    def export():
        drained.extend(X.drain(ColumnarRdd.convert(qdf)))
    _forget_speculation(sess)
    K.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    syncs = _syncs_by_site(export)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(bool(drained), "export: no batch")
    for d in drained:
        require(d["x"].is_cuda and d["y"].is_cuda and d["mask"].is_cuda,
                "export: a matrix is not on the card")
    stats = X.matrix_stats(drained)
    got = X.live_rows(drained)
    del drained
    same = X.same_rows(got, want)
    _forget_speculation(sess)
    cold = _syncs_by_site(qdf.collect_batches)
    require(syncs == cold, f"export: counted syncs by site {syncs}, the "
            f"ETL's cold run up to its collect {cold}")
    moved = {k: v for k, v in syncs.items() if k in TRANSFER_SITES}
    require(not moved, f"export: syncs that move batches to the host "
            f"{moved}")
    require(launches.get("compact_permutation", 0) > 0,
            f"export: B1 never ran ({launches})")
    for k, v in EXPORT_CONF.items():
        sess.set_conf(k, False)
    rec = {"sf": MORTGAGE_ETL_SF, "wall_s": wall, "rows": same["rows"],
           "max_rel_err": same["max_rel_err"], "syncs_by_site": syncs,
           "cold_syncs_by_site": cold, "launches": launches,
           "peak_device_bytes": peak, "features": len(X.ETL_FEATURES),
           **stats, "card": card_line()}
    rec["phase_s"] = time.perf_counter() - t_phase
    require(rec["phase_s"] <= EXPORT_BUDGET_S,
            f"export: the phase took {rec['phase_s']:.1f} s, over its "
            f"{EXPORT_BUDGET_S} s")
    log(f"export: {same['rows']} live rows in {stats['batches']} batches "
        f"equal to the ETL's collect (max rel err "
        f"{same['max_rel_err']:.3g}); wall {wall:.4f} s; matrices "
        f"{stats['matrix_rows']} rows x {len(X.ETL_FEATURES)} features, "
        f"{stats['matrix_bytes']} bytes; peak device memory {peak} bytes; "
        f"counted syncs {syncs} (cold collect_batches {cold}); launches "
        f"{launches}; phase {rec['phase_s']:.1f} s ({card_line()})")
    report["export"] = rec
    return rec


# the memory phase: a 2 GiB metered budget (allocFraction from the card's
# memory), out-of-core buckets of 256 MiB (6 MiB for Mortgage
# aggregates_with_join, whose join inputs are group-by outputs of about 1M
# rows: at 32 MiB its join split 2 ways, at 6 MiB 8 ways), a 512 MiB host
# tier so the larger spills reach disk, B2 tables of at most 2^20 slots
MEMORY_BUDGET = 2 << 30
MEMORY_PARTITION = 256 << 20
MEMORY_PARTITION_MORTGAGE = 6 << 20
MEMORY_HOST = 512 << 20
MEMORY_SLOTS = 1 << 20
MEMORY_SPILL_DIR = os.path.join("spark_rapids_tpu_torch", "build", "spill")
# allocator rounding and the kernels' persistent scratch (B1's tickets)
MEMORY_SLACK = 64 << 20


def _memory_counters() -> dict:
    """The spill, fault-back and out-of-core counters, flat."""
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    out = {}
    for d in ("device_to_host", "host_to_disk"):
        out[f"spill_events_{d}"] = REGISTRY.value("spill.events",
                                                  direction=d)
        out[f"spill_bytes_{d}"] = REGISTRY.value("spill.bytes", direction=d)
    for t in ("host", "disk"):
        out[f"fault_backs_{t}"] = REGISTRY.value("spill.faultBacks", tier=t)
    for op in ("join", "aggregate", "sort", "hashAggSplit"):
        out[f"ooc_{op}"] = REGISTRY.value("ooc.operators", op=op)
    out["clean_drops"] = REGISTRY.value("spill.cleanDrops")
    for k in ("device_to_host", "host_to_disk", "fault_back_host",
              "fault_back_disk"):
        out[f"time_{k}_s"] = REGISTRY.value(f"spill.time.{k}")
    return out


def _counters_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _memory_counters().items()}


def memory_session(batch_rows: int, partition_bytes: int, **conf):
    """A session of the memory phase: ``session_of``'s test mode and
    cached uploads, with the phase's budget, host tier and spill
    directory, and out-of-core on at ``partition_bytes``."""
    total = torch.cuda.mem_get_info(0)[1]
    return session_of(batch_rows, **dict({
        "spark.rapids.memory.tpu.allocFraction": MEMORY_BUDGET / total,
        "spark.rapids.memory.host.spillStorageSize": MEMORY_HOST,
        "spark.rapids.memory.spill.diskDir": MEMORY_SPILL_DIR,
        "spark.rapids.tpu.outOfCore.enabled": True,
        "spark.rapids.tpu.outOfCore.partitionBytes": partition_bytes,
        "spark.rapids.sql.agg.hashAggEnabled": True,
        "spark.rapids.sql.agg.hash.maxTableSlots": MEMORY_SLOTS}, **conf))


def _measured_run(sess, query) -> tuple:
    """One run of ``query`` up to its collect under the sync debug mode
    "error" (only counted waits pass; the counts by site), then its fetch
    to pandas, with the launch counts, the spill and out-of-core
    counters, the metered peak and the allocator's peak read around it.
    Returns (answer, record)."""
    import pandas as pd

    from spark_rapids_tpu_torch.exec import outofcore as OOC
    from spark_rapids_tpu_torch.exec.cpu import concat_host_frames
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    from spark_rapids_tpu_torch.ops import kernels as K
    dm = sess.device_manager
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dm.reset_per_device_peaks()
    before = _memory_counters()
    syncs = dict(SYNCS.syncs)
    r0 = len(OOC.RECORDS)
    K.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        parts = query.collect_batches()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    to_collect = time.perf_counter() - t0
    out = concat_host_frames([p if isinstance(p, pd.DataFrame) else
                              p.to_pandas() for p in parts], query.schema)
    del parts
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_site = {k: v - syncs.get(k, 0) for k, v in SYNCS.syncs.items()
               if v - syncs.get(k, 0)}
    # the collect's own fetches are counted too; only the waits up to it
    # are the query's
    fetch = by_site.pop("batch.rowCount", 0) + by_site.pop("batch.fetch", 0)
    rec = {"wall_s": wall, "to_collect_s": to_collect,
           "launches": dict(K.LAUNCHES),
           "counters": _counters_since(before),
           "ooc_records": list(OOC.RECORDS)[r0:],
           "metered_peak_bytes": dm.peak,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "memory": sess.last_query_metrics["memory"],
           "counted_syncs": sum(by_site.values()), "syncs_by_site": by_site,
           "collect_fetches": fetch}
    return out, rec


def keep_scans_of(sess, *dfs) -> None:
    """Free every cached scan of ``sess`` that none of the queries ``dfs``
    reads."""
    from spark_rapids_tpu_torch.exec.tpu import TpuScanExec
    read = {tuple(n.output_schema().names) for df in dfs
            for n in sess.physical_plan(df._plan).walk()
            if isinstance(n, TpuScanExec)}
    for key in list(sess.device_scan_cache):
        if key[1] not in read:
            for bids in sess.device_scan_cache.pop(key)[1].values():
                for bid in bids:
                    sess.buffer_catalog.remove(bid)


def _in_budget(sess, query) -> tuple:
    """The query's answer at the card's default budget with out-of-core
    off (the in-budget run), and its wall (a cold run: the uploads)."""
    from spark_rapids_tpu_torch.config import conf as CONF
    dm = sess.device_manager
    budget = dm.hbm_budget
    ooc = sess.conf.get(CONF.OOC_ENABLED.key)
    dm.hbm_budget = int(dm.hbm_total * CONF.ALLOC_FRACTION.default)
    sess.set_conf(CONF.OOC_ENABLED.key, False)
    try:
        t0 = time.perf_counter()
        out = query.collect()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        dm.hbm_budget = budget
        sess.set_conf(CONF.OOC_ENABLED.key, ooc)


def _require_cell(name: str, rec: dict, ops: tuple, disk: bool) -> None:
    c = rec["counters"]
    require(c["spill_bytes_device_to_host"] > 0,
            f"{name}: nothing spilled device -> host")
    if disk:
        require(c["spill_bytes_host_to_disk"] > 0,
                f"{name}: nothing spilled host -> disk")
    fanouts = {}
    for r in rec["ooc_records"]:
        fanouts.setdefault(r["op"], []).append(r["fanout"])
    rec["fanouts"] = fanouts
    for op in ops:
        require(c[f"ooc_{op}"] > 0, f"{name}: out-of-core {op} did not "
                f"engage ({fanouts})")
        require(max(fanouts.get(op, [0])) >= 8,
                f"{name}: out-of-core {op} below a fan-out of 8 "
                f"({fanouts})")


def _log_cell(name: str, rec: dict) -> None:
    c = rec["counters"]
    log(f"{name}: {rec['wall_s']:.4f} s ({rec['to_collect_s']:.4f} s up "
        f"to the collect; in-budget cold run "
        f"{rec.get('in_budget_wall_s', float('nan')):.4f} s); spilled "
        f"device->host {c['spill_bytes_device_to_host']} B in "
        f"{c['spill_events_device_to_host']}, host->disk "
        f"{c['spill_bytes_host_to_disk']} B in "
        f"{c['spill_events_host_to_disk']}; fault-backs host "
        f"{c['fault_backs_host']} disk {c['fault_backs_disk']}, clean drops "
        f"{c['clean_drops']}; host s: to host "
        f"{c['time_device_to_host_s']:.2f}, to disk "
        f"{c['time_host_to_disk_s']:.2f}, back from host "
        f"{c['time_fault_back_host_s']:.2f}, from disk "
        f"{c['time_fault_back_disk_s']:.2f}; fan-outs "
        f"{rec.get('fanouts')}; metered peak "
        f"{rec['metered_peak_bytes'] / 2**30:.3f} GiB, max allocated "
        f"{rec['max_memory_allocated'] / 2**30:.3f} GiB; counted syncs "
        f"{rec['counted_syncs']} {rec['syncs_by_site']}; launches "
        f"{rec['launches']}")


def memory_phase(frames: dict, mortgage: tuple, batch_rows: int,
                 queries: dict, report: dict, earlier: dict) -> None:
    """Larger-than-budget execution through the session (the memory
    runtime and the out-of-core drivers) on the SF10 TPC-H frames and the
    SF 500 Mortgage frames the smoke already made, under a 2 GiB metered
    budget (``memory_session``):

      * spill: Q1 run twice; the first spills its cached scan batches
        device -> host -> disk as they arrive, the second faults them
        back; after a spill of every resident batch
        ``torch.cuda.memory_allocated()`` is lower by at least the bytes
        moved;
      * grace join + aggregate: Q3 (B3/B4 in each bucket of its
        lineitem join) and Mortgage ``aggregates_with_join`` (B3/B4 on the
        int32 ``loan_id_hash`` in each bucket; 6 MiB buckets);
      * spillable aggregate: the Q18 group-by at SF10 (each 2^23-row
        batch split into B2 slices of at most 2^20 slots, then the grace
        merge);
      * external sort: lineitem's (l_orderkey, l_linenumber,
        l_extendedprice) by l_extendedprice descending, then l_orderkey,
        l_linenumber, held exactly against a numpy lexsort.

    Each answer equals pandas and the same query's in-budget answer from
    the same session (the default budget, out-of-core off); each
    out-of-core cell engages each operator it names at a fan-out of 8
    or more;
    every cell spills device -> host, the spill cell, Q3 and the sort
    also host -> disk; every host wait up to the collect is counted (by
    site); the metered peak stands beside the allocator's; no buffer
    leaks across the phase."""
    import pandas as pd

    from spark_rapids_tpu_torch.memory.leak import assert_no_leaks
    from spark_rapids_tpu_torch.models import mortgage as M
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.testing import mortgagecases as MC
    from concurrent.futures import ThreadPoolExecutor
    li = frames["lineitem"]
    cells = {}
    launches = {}
    # the host references of the Q18 group-by and the sort, computed in
    # threads while the cells before them run on the card
    pool = ThreadPoolExecutor(max_workers=2)
    t_refs = time.perf_counter()

    def timed(fn):
        def run():
            out = fn()
            return out, time.perf_counter() - t_refs
        return run
    q18_ref = pool.submit(timed(lambda: li.groupby(
        "l_orderkey", sort=False).l_quantity.sum()))
    sort_ref = pool.submit(timed(lambda: np.lexsort((
        li.l_linenumber.to_numpy(), li.l_orderkey.to_numpy(),
        -li.l_extendedprice.to_numpy()))))
    pool.shutdown(wait=False)
    with assert_no_leaks():
        # -- spill: Q1 twice, no out-of-core ---------------------------------
        reused = earlier.get("q1_session") is not None
        if reused:
            # the session Q1 cell's session, its upload cached on the card:
            # now under the phase's budget and host tier
            sess, tables = earlier.pop("q1_session")
            total = torch.cuda.mem_get_info(0)[1]
            sess.set_conf("spark.rapids.memory.tpu.allocFraction",
                          MEMORY_BUDGET / total)
            sess.device_manager.hbm_budget = int(
                total * sess.conf.alloc_fraction)
            sess.buffer_catalog.host_store.limit_bytes = MEMORY_HOST
            q1 = T.q1(sess, tables)
            m0 = 0  # the cached upload predates the phase
            del tables
            gc_collect()
            a_before = torch.cuda.memory_allocated()
        else:
            sess = memory_session(batch_rows, MEMORY_PARTITION, **{
                "spark.rapids.tpu.outOfCore.enabled": False})
            q1 = T.q1(sess, {"lineitem": sess.create_dataframe(li)})
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
        out1, rec = _measured_run(sess, q1)
        gc_collect()
        m1 = torch.cuda.memory_allocated()
        cat = sess.buffer_catalog
        resident = cat.device_store.total_size
        rec["allocated_growth_bytes"] = m1 - m0
        rec["resident_metered_bytes"] = resident
        if not reused:
            require(m1 - m0 <= resident + MEMORY_SLACK,
                    f"spill Q1: {m1 - m0} bytes still allocated, more "
                    f"than the {resident} resident")
        else:
            # the cached batches were on the card before the run: what it
            # spilled is gone from the allocator
            d2h = rec["counters"]["spill_bytes_device_to_host"]
            rec["allocated_drop_bytes"] = a_before - m1
            require(a_before - m1 >= d2h - MEMORY_SLACK,
                    f"spill Q1: spilled {d2h} bytes, the allocator fell "
                    f"by {a_before - m1}")
        out2, rec2 = _measured_run(sess, q1)
        rec["second_run"] = rec2
        require(rec2["counters"]["fault_backs_host"]
                + rec2["counters"]["fault_backs_disk"] > 0,
                "spill Q1: the second run faulted nothing back")
        # the in-budget answer: the session Q1 cell's, in this process
        out_in = earlier.get("session_q1")
        if out_in is None:
            out_in, rec["in_budget_wall_s"] = _in_budget(sess, q1)
        want = earlier.get("q1_want")
        if want is None:
            want = q1_reference(li)
        rec["max_rel_err"] = max(
            check_q1(out1, want), check_q1(out2, want),
            same_by_key(out1, out_in, ["l_returnflag", "l_linestatus"],
                        "spill Q1 against its in-budget run"),
            same_by_key(out2, out_in, ["l_returnflag", "l_linestatus"],
                        "spill Q1, second run, against its in-budget run"))
        # every resident batch to host: the allocator gives the bytes back
        gc_collect()
        a0 = torch.cuda.memory_allocated()
        moved = cat.device_store.synchronous_spill(0)
        a1 = torch.cuda.memory_allocated()
        rec["explicit_spill_bytes"] = moved
        rec["explicit_spill_freed_bytes"] = a0 - a1
        require(moved > 0 and a0 - a1 >= moved,
                f"spill Q1: a spill of {moved} bytes freed {a0 - a1}")
        _require_cell("spill Q1", rec, (), True)
        _log_cell("memory spill Q1", rec)
        log(f"memory spill Q1: allocated {m1 - m0} B past the start "
            f"(dropped {rec.get('allocated_drop_bytes')} B) with "
            f"{resident} B resident; second run {rec2['wall_s']:.4f} s, "
            f"{rec2['counters']}; an explicit spill of {moved} B freed "
            f"{a0 - a1} B")
        cells["spill_q1"] = rec
        sess.stop()
        del sess, q1, out1, out2, out_in

        # -- grace join: Q3 ---------------------------------------------------
        sess = memory_session(batch_rows, MEMORY_PARTITION)
        tables = {n: sess.create_dataframe(f) for n, f in frames.items()
                  if n in ("lineitem", "orders", "customer")}
        q3 = T.q3(sess, tables)
        out_in, in_wall = _in_budget(sess, q3)
        out, rec = _measured_run(sess, q3)
        rec["in_budget_wall_s"] = in_wall
        want = earlier.get("q3_want")
        if want is None:
            want = q3_reference(li, frames["orders"], frames["customer"])
        rec["max_rel_err"] = max(check_q3(out, want), check_q3(out, out_in))
        _require_cell("Q3", rec, ("join",), True)
        _log_cell("memory grace Q3", rec)
        cells["grace_q3"] = rec
        sess.stop()
        del sess, tables, q3, out, out_in

        # -- grace join + aggregate: Mortgage aggregates_with_join ------------
        perf, acq = mortgage[0]
        sess = memory_session(MORTGAGE_BATCH_ROWS, MEMORY_PARTITION_MORTGAGE,
                              **M.ETL_CONFS)
        qm = M.run_query("aggregates_with_join", sess,
                         sess.create_dataframe(perf),
                         sess.create_dataframe(acq))
        out_in, in_wall = _in_budget(sess, qm)
        out, rec = _measured_run(sess, qm)
        rec["in_budget_wall_s"] = in_wall
        t0 = time.perf_counter()
        want = MC.pandas_reference("aggregates_with_join", perf, acq)
        rec["reference_s"] = time.perf_counter() - t0
        rec.update(MC.same_answer("aggregates_with_join", out, want))
        MC.same_answer("aggregates_with_join", out, out_in)
        if mortgage[1].get("aggregates_with_join") is not None:
            MC.same_answer("aggregates_with_join", out,
                           mortgage[1]["aggregates_with_join"])
        require(rec["launches"].get("hash_table_build", 0) > 0
                and rec["launches"].get("hash_table_probe", 0) > 0,
                f"Mortgage aggregates_with_join: no B3/B4 in its buckets "
                f"{rec['launches']}")
        _require_cell("Mortgage aggregates_with_join", rec,
                      ("join", "aggregate"), False)
        _log_cell("memory grace Mortgage aggregates_with_join", rec)
        cells["grace_mortgage_aggregates_with_join"] = rec
        sess.stop()
        del sess, qm, out, out_in, want

        # -- spillable aggregate: the Q18 group-by at SF10 --------------------
        # dense keys off: on l_orderkey's bounded range they outrank the
        # hash table from the plan's second run and split no batch; this
        # cell holds the hash split past maxTableSlots
        sess = memory_session(batch_rows, MEMORY_PARTITION, **{
            "spark.rapids.sql.agg.denseKeys": False})
        q18 = T.q18_groupby(sess, {"lineitem": sess.create_dataframe(
            li[["l_orderkey", "l_quantity"]])})
        out_in, in_wall = _in_budget(sess, q18)
        out, rec = _measured_run(sess, q18)
        rec["in_budget_wall_s"] = in_wall
        t0 = time.perf_counter()
        sums, rec["pandas_done_at_s"] = q18_ref.result()
        rec["pandas_wait_s"] = time.perf_counter() - t0
        rec["groups"] = len(sums)
        sums = sums[sums > 300]
        want = pd.DataFrame({"l_orderkey": sums.index,
                             "sum_qty": sums.to_numpy()})
        rec["max_rel_err"] = max(
            same_by_key(out, want, ["l_orderkey"], "memory Q18 group-by"),
            same_by_key(out, out_in, ["l_orderkey"],
                        "memory Q18 group-by against its in-budget run"))
        require(rec["counters"]["ooc_hashAggSplit"] > 0,
                "memory Q18 group-by: no batch split past maxTableSlots")
        _require_cell("Q18 group-by", rec, ("aggregate",), False)
        _log_cell("memory spillable aggregate Q18 group-by", rec)
        cells["spillable_q18_groupby"] = rec
        sess.stop()
        del sess, q18, out, out_in, want, sums

        # -- external sort ---------------------------------------------------
        cols = ["l_orderkey", "l_linenumber", "l_extendedprice"]
        sess = memory_session(batch_rows, MEMORY_PARTITION)
        qs = sess.create_dataframe(li[cols]).order_by(
            SF_.col("l_extendedprice").desc(), "l_orderkey", "l_linenumber")
        out_in, in_wall = _in_budget(sess, qs)
        out, rec = _measured_run(sess, qs)
        rec["in_budget_wall_s"] = in_wall
        t0 = time.perf_counter()
        order, rec["numpy_done_at_s"] = sort_ref.result()
        rec["numpy_wait_s"] = time.perf_counter() - t0
        for c in cols:
            w = li[c].to_numpy()[order]
            require(np.array_equal(out[c].to_numpy(), w),
                    f"memory sort: {c} differs from the numpy lexsort")
            require(np.array_equal(out[c].to_numpy(), out_in[c].to_numpy()),
                    f"memory sort: {c} differs from its in-budget run")
        rec["max_rel_err"] = 0.0
        _require_cell("sort", rec, ("sort",), True)
        _log_cell("memory external sort", rec)
        cells["external_sort"] = rec
        sess.stop()
        del sess, qs, out, out_in, order
        gc_collect()
    for name, rec in cells.items():
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        queries[f"memory_{name}"] = dict(
            rec, sf=MORTGAGE_SF if "mortgage" in name else 10,
            rows=(len(mortgage[0][0]) + len(mortgage[0][1])
                  if "mortgage" in name else len(li)),
            upload_s=rec["in_budget_wall_s"] if "in_budget_wall_s" in rec
            else rec["wall_s"])
    for k in ("compact_permutation", "hash_grouped_aggregate",
              "hash_table_build", "hash_table_probe"):
        require(launches.get(k, 0) > 0, f"memory phase: {k} never ran")
    report["memory_launches"] = launches
    log(f"memory phase launches: {launches}")


def gc_collect() -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()


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


SCAN_WRITE_DIR = os.path.join("spark_rapids_tpu_torch", "build",
                              "scan_write")
PAGE_CACHE_ON = {"spark.rapids.sql.scan.pageCache.enabled": True}


def _frame_equal(got, want, what: str) -> None:
    """Every column of ``got`` equals ``want``'s, row for row: dates and
    timestamps at microseconds, the rest exactly (NULL for NULL)."""
    import pandas as pd
    require(list(got.columns) == list(want.columns) and len(got) == len(want),
            f"{what}: columns or rows differ")
    import pyarrow as pa

    def arrow_strings(x):
        a = pa.array(x)
        if isinstance(a, pa.ChunkedArray):
            a = a.combine_chunks()
        return a.cast(pa.large_string())
    for c in want.columns:
        g, w = got[c], want[c]
        if w.dtype.kind not in "biufM" and g.dtype.kind not in "biufM":
            # strings through arrow: no Python object a value
            require(arrow_strings(g).equals(arrow_strings(w)),
                    f"{what}: column {c} differs")
            continue
        if w.dtype.kind == "M" or g.dtype.kind == "M":
            g = pd.to_datetime(g).to_numpy("datetime64[us]")
            w = pd.to_datetime(w).to_numpy("datetime64[us]")
            same = np.array_equal(g, w)
        elif w.dtype.kind in "biuf":
            same = np.array_equal(g.to_numpy(w.dtype), w.to_numpy())
        else:
            same = np.array_equal(g.to_numpy(object), w.to_numpy(object))
        require(same, f"{what}: column {c} differs")


def _metric_of(sess, prefix: str, name: str):
    for op, ms in sess.last_query_metrics.items():
        if op.startswith(prefix):
            return ms.get(name, 0)
    return 0


def _counters(*names) -> dict:
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    return {n: REGISTRY.value(n) for n in names}


def _since(before: dict) -> dict:
    now = _counters(*before)
    return {n: now[n] - before[n] for n in before}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _kept_by_footer(paths, lo, hi) -> tuple:
    """(row groups, row groups whose l_shipdate min/max meet [lo, hi)) of
    the files ``paths``, from their footers."""
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    total = kept = 0
    for p in paths:
        md = praw.file_metadata(p)
        ci = md.schema.names.index("l_shipdate")
        for rg in range(md.num_row_groups):
            st = md.row_group(rg).column(ci).statistics
            total += 1
            kept += int(np.datetime64(st.max) >= lo
                        and np.datetime64(st.min) < hi)
    return total, kept


def scan_write_phase(li1, o1, c1, path_li1: str, batch_rows: int,
                     queries: dict, report: dict) -> None:
    """Scan and write through the session: SF1 lineitem decoded
    from its Parquet file, ordered by l_shipdate on the card and written
    (``write_sorted``, read back equal to the frame), TPC-H Q6 over the
    written files pruned by their footers' l_shipdate statistics beside
    the same query over the unsorted file (``q6_pruned``), lineitem
    (Q1's columns) written partitioned by (l_returnflag, l_linestatus)
    and Q1 over its
    directories (one a pair the generator's rows hold: six), then with
    l_returnflag = 'R' (``q1_partitioned``),
    SF1 orders written as ORC and read back stripe-pruned and whole, SF1
    customer as CSV read back under an explicit schema (``orc_csv``), and
    Q6 pruned twice through the encoded-page cache (``page_cache_warm``).
    Each query runs up to its collect under the sync debug mode, its
    counted syncs recorded by site."""
    import glob
    import shutil
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.sql import parquet_raw as praw
    shutil.rmtree(SCAN_WRITE_DIR, ignore_errors=True)
    os.makedirs(SCAN_WRITE_DIR)
    cells = {}
    lo, hi = np.datetime64("1994-01-01"), np.datetime64("1995-01-01")
    # (l_orderkey, l_linenumber) repeats in the generator's rows; with
    # the part and supplier keys it is unique, so both sides order alike
    key = ["l_orderkey", "l_linenumber", "l_partkey", "l_suppkey"]
    packed = np.zeros(len(li1), np.int64)
    for k in key:
        v = li1[k].to_numpy().astype(np.int64)
        packed = (packed << int(v.max()).bit_length()) | v
    require(sum(int(li1[k].max()).bit_length() for k in key) < 63,
            "write_sorted: the comparison key does not pack")
    order = np.argsort(packed, kind="stable")
    require(bool((np.diff(packed[order]) != 0).all()),
            "write_sorted: the comparison key repeats")
    li_sorted = li1.iloc[order].reset_index(drop=True)

    # write_sorted: the file decoded on the card, sorted, written
    sess = session_of(batch_rows, **{
        "spark.rapids.sql.cacheDeviceScans": False})
    sorted_dir = os.path.join(SCAN_WRITE_DIR, "lineitem_sorted")
    src = sess.read.parquet(path_li1).order_by("l_shipdate")
    before = _counters("scan.device.fallbackColumns")
    # one write, timed, under the sync debug mode (its waits by site)
    syncs, secs = _timed(lambda: _syncs_by_site(
        lambda: src.write.mode("overwrite").parquet(sorted_dir)))
    require(_since(before)["scan.device.fallbackColumns"] == 0,
            "write_sorted: a column of the source fell back to the host")
    files = sorted(glob.glob(os.path.join(sorted_dir, "*.parquet")))
    rgs = sum(pq.ParquetFile(f).metadata.num_row_groups for f in files)
    rec = {"rows": len(li1), "columns": len(li1.columns), "write_s": secs,
           "rows_per_s": len(li1) / secs,
           "bytes": _metric_of(sess, "TpuWriteExec", "numOutputBytes"),
           "files": _metric_of(sess, "TpuWriteExec", "numFiles"),
           "row_groups": rgs, "syncs": syncs}
    require(rec["files"] == len(files) and _metric_of(
        sess, "TpuWriteExec", "numOutputRows") == len(li1),
        f"write_sorted: metrics {sess.last_query_metrics}")
    before = _counters("scan.device.fallbackColumns")
    back, rec["read_back_s"] = _timed(lambda: sess.read.parquet(
        sorted_dir).order_by(*key).collect())
    require(_since(before)["scan.device.fallbackColumns"] == 0,
            "write_sorted: the written files decode partly on the host")
    _frame_equal(back, li_sorted, "write_sorted read back")
    del back
    cells["write_sorted"] = rec
    log(f"scan_write write_sorted: {secs:.2f} s, {rec['rows_per_s']:.4g} "
        f"rows/s, {rec['bytes'] / 1e6:.1f} MB in {rec['files']} files, "
        f"{rgs} row groups, syncs {syncs}; read back equal "
        f"({rec['read_back_s']:.2f} s)")

    # q6_pruned: Q6 over the written files beside the unsorted file, the
    # page cache off (every run reads and uploads its row groups)
    q6_want = q6_reference(li1)
    total, kept = _kept_by_footer(files, lo, hi)
    rec = {"row_groups": total, "kept": kept}
    for name, path in (("pruned", sorted_dir), ("unpruned", path_li1)):
        q = T.q6(sess, {"lineitem": sess.read.parquet(path)})
        before = _counters("scan.device.splits")
        out, walls, launches = run_query(f"scan_write q6 {name}", q.collect,
                                         3)
        splits = _since(before)["scan.device.splits"] // 4
        pruned = _metric_of(sess, "Parquet[", "numRowGroupsPruned")
        err = _rel_err([out.revenue[0]], [q6_want])
        require(len(out) == 1 and err <= F64_RTOL,
                f"q6 {name}: revenue differs from pandas: {err}")
        rec[name] = {"wall_s": float(np.median(walls)), "walls_s": walls,
                     "splits": splits, "pruned": pruned,
                     "launches": launches, "max_rel_err": err,
                     "syncs": _syncs_by_site(q.collect_batches)}
    require(rec["pruned"]["pruned"] == total - kept
            and rec["pruned"]["splits"] == kept,
            f"q6_pruned: pruned {rec['pruned']['pruned']}, decoded "
            f"{rec['pruned']['splits']}; the footers keep {kept} of {total}")
    for k in ("hybrid_expand", "plain_fixed"):
        require(0 < rec["pruned"]["launches"][k] <= kept,
                f"q6_pruned: {rec['pruned']['launches'][k]} {k} launches "
                f"for {kept} kept row groups")
    rec["runner_q6_parquet_wall_s"] = queries.get("q6_parquet", {}).get(
        "wall_s")
    cells["q6_pruned"] = rec
    log(f"scan_write q6_pruned: kept {kept} of {total} row groups "
        f"(footers), {rec['pruned']['wall_s']:.4f} s against "
        f"{rec['unpruned']['wall_s']:.4f} s over the unsorted file "
        f"(pruned {rec['unpruned']['pruned']}); syncs "
        f"{rec['pruned']['syncs']} / {rec['unpruned']['syncs']}")

    # q1_partitioned: a directory a (l_returnflag, l_linestatus) pair,
    # lineitem's columns that Q1 reads
    part_dir = os.path.join(SCAN_WRITE_DIR, "lineitem_by_flag")
    q1_cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_shipdate", "l_returnflag", "l_linestatus"]
    _, secs = _timed(lambda: sess.read.parquet(path_li1).select(
        *q1_cols).write.mode("overwrite").partition_by(
        "l_returnflag", "l_linestatus").parquet(part_dir))
    parts = _metric_of(sess, "TpuWriteExec", "numParts")
    flags = li1.groupby(["l_returnflag", "l_linestatus"]).ngroups
    require(parts == flags, f"q1_partitioned: {parts} directories for "
            f"{flags} flag and status pairs")
    psess = session_of(batch_rows, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.cacheDeviceScans": False}))
    q1_want = q1_reference(li1)
    rec = {"write_s": secs, "directories": parts}
    for name, flt in (("all", None), ("flag_r", "R")):
        lt = psess.read.parquet(part_dir)
        if flt is not None:
            lt = lt.filter(SF_.col("l_returnflag") == flt)
        q = T.q1(psess, {"lineitem": lt})
        before = _counters("scan.device.splits", "scan.device.bytesDevice")
        out, walls, launches = run_query(f"scan_write q1 {name}", q.collect,
                                         3)
        up = _since(before)
        pruned = _metric_of(psess, "Parquet[", "numRowGroupsPruned")
        want = q1_want if flt is None else q1_want[
            q1_want.l_returnflag == flt].reset_index(drop=True)
        err = check_q1(out, want)
        from spark_rapids_tpu_torch.obs.syncledger import SYNCS
        from spark_rapids_tpu_torch.ops import aggregate as A
        b0 = SYNCS.bytes.get("scan.upload", 0)
        A.BRANCHES.clear()
        syncs = _syncs_by_site(q.collect_batches)
        upload = SYNCS.bytes.get("scan.upload", 0) - b0
        # the keys are the partition columns: one-value dictionaries a
        # directory, merged, so the group-by takes the dictionary branch
        require(launches["compact_permutation"] > 0,
                f"q1_partitioned {name}: no B1 launch")
        rec[name] = {"branches": dict(A.BRANCHES),
                     "wall_s": float(np.median(walls)), "walls_s": walls,
                     "pruned": pruned, "splits": up["scan.device.splits"] // 4,
                     "launches": launches, "max_rel_err": err,
                     "syncs": syncs, "upload_bytes": upload,
                     "plan_bytes": up["scan.device.bytesDevice"] // 4}
        # the partition keys cost no upload: a run uploads its data
        # columns' plans and nothing more
        require(upload == rec[name]["plan_bytes"],
                f"q1_partitioned {name}: uploaded {upload} bytes for "
                f"{rec[name]['plan_bytes']} bytes of plans")
    dirs = {os.path.dirname(p) for p in glob.glob(
        os.path.join(part_dir, "*", "*", "*.parquet"))}
    r_dirs = {d for d in dirs if "l_returnflag=R" in d}
    rg_in = {d: sum(pq.ParquetFile(f).metadata.num_row_groups
                    for f in glob.glob(os.path.join(d, "*.parquet")))
             for d in dirs}
    require(len(dirs) == flags and 0 < len(r_dirs) < flags
            and rec["flag_r"]["pruned"] == sum(
                n for d, n in rg_in.items() if d not in r_dirs)
            and rec["all"]["pruned"] == 0,
            f"q1_partitioned: pruned {rec['flag_r']['pruned']} row groups, "
            f"directories {rg_in}")
    rec["directories_pruned"] = len(dirs) - len(r_dirs)
    cells["q1_partitioned"] = rec
    log(f"scan_write q1_partitioned: write {secs:.2f} s, Q1 "
        f"{rec['all']['wall_s']:.4f} s, with l_returnflag = 'R' "
        f"{rec['flag_r']['wall_s']:.4f} s ({rec['directories_pruned']} of "
        f"{flags} directories pruned); upload bytes {rec['all']['upload_bytes']} = "
        f"plans; syncs {rec['all']['syncs']} / {rec['flag_r']['syncs']}")
    psess.stop()
    del psess

    # orc_csv: orders as ORC (stripe pruning), customer as CSV (schema)
    rec = {}
    orc_dir = os.path.join(SCAN_WRITE_DIR, "orders_orc")
    _, rec["orc_write_s"] = _timed(lambda: sess.create_dataframe(
        o1).write.mode("overwrite").orc(orc_dir))
    cut = int(o1.o_orderkey.quantile(0.1))
    filt, rec["orc_filter_s"] = _timed(lambda: sess.read.orc(orc_dir).filter(
        SF_.col("o_orderkey") < cut).collect())
    rec["stripes_pruned"] = _metric_of(sess, "ORC[", "numStripesPruned")
    rec["stripes"] = len(sess.read.orc(orc_dir)._plan.source.splits)
    _frame_equal(filt.sort_values("o_orderkey").reset_index(drop=True),
                 o1[o1.o_orderkey < cut].sort_values("o_orderkey")
                 .reset_index(drop=True), "orc_csv orders filtered")
    whole, rec["orc_read_s"] = _timed(
        lambda: sess.read.orc(orc_dir).collect())
    _frame_equal(whole, o1, "orc_csv orders")
    csv_dir = os.path.join(SCAN_WRITE_DIR, "customer_csv")
    _, rec["csv_write_s"] = _timed(lambda: sess.create_dataframe(
        c1).write.mode("overwrite").csv(csv_dir))
    cust, rec["csv_read_s"] = _timed(lambda: sess.read.schema(
        Schema.from_pandas(c1)).option("header", True).csv(
        csv_dir).collect())
    _frame_equal(cust, c1, "orc_csv customer")
    cells["orc_csv"] = rec
    log(f"scan_write orc_csv: orders ORC write {rec['orc_write_s']:.2f} s, "
        f"{rec['stripes_pruned']} of {rec['stripes']} stripes pruned, read "
        f"{rec['orc_read_s']:.2f} s; customer CSV write "
        f"{rec['csv_write_s']:.2f} s read {rec['csv_read_s']:.2f} s")
    sess.stop()
    del sess, whole, cust, filt

    # page_cache_warm: Q6 over the sorted files twice, the page cache on
    csess = session_of(batch_rows, **dict(PAGE_CACHE_ON, **{
        "spark.rapids.sql.cacheDeviceScans": False}))
    q = T.q6(csess, {"lineitem": csess.read.parquet(sorted_dir)})
    rec = {}
    outs = []
    for run in ("cold", "warm"):
        before = _counters("scan.device.fileReads", "pagecache.hits",
                           "pagecache.deviceHits")
        from spark_rapids_tpu_torch.ops import kernels as K
        K.reset_launches()
        out, secs = _timed(q.collect)
        outs.append(out)
        rec[run] = dict(_since(before), wall_s=secs,
                        launches=dict(K.LAUNCHES))
    rec["warm"]["syncs"] = _syncs_by_site(q.collect_batches)
    rec["device_bytes"] = csess.page_cache.stats["deviceBytes"]
    require(rec["warm"]["scan.device.fileReads"] == 0
            and rec["warm"]["pagecache.hits"] > 0,
            f"page_cache_warm: {rec['warm']}")
    require(np.array_equal(outs[0].revenue.to_numpy().view(np.int64),
                           outs[1].revenue.to_numpy().view(np.int64)),
            "page_cache_warm: the warm answer is not bit-equal")
    cells["page_cache_warm"] = rec
    log(f"scan_write page_cache_warm: cold {rec['cold']['wall_s']:.4f} s "
        f"({rec['cold']['scan.device.fileReads']} file reads), warm "
        f"{rec['warm']['wall_s']:.4f} s (0 file reads, "
        f"{rec['warm']['pagecache.hits']} host hits, "
        f"{rec['warm']['pagecache.deviceHits']} device hits); warm syncs "
        f"{rec['warm']['syncs']}")
    csess.stop()
    del csess
    report["scan_write"] = cells
    queries["session_q6_pruned_parquet"] = {
        "sf": 1, "rows": len(li1), "wall_s": cells["q6_pruned"]["pruned"][
            "wall_s"], "launches": cells["q6_pruned"]["pruned"]["launches"],
        "cold_s": cells["q6_pruned"]["unpruned"]["wall_s"],
        "row_groups": kept,
        "runner_wall_s": cells["q6_pruned"]["runner_q6_parquet_wall_s"]}
    queries["session_q1_partitioned_parquet"] = {
        "sf": 1, "rows": len(li1), "wall_s": cells["q1_partitioned"]["all"][
            "wall_s"], "launches": cells["q1_partitioned"]["all"]["launches"],
        "cold_s": cells["q1_partitioned"]["write_s"],
        "row_groups": cells["q1_partitioned"]["all"]["splits"],
        "runner_wall_s": None}


OBS_DIR = os.path.join("spark_rapids_tpu_torch", "build", "obs")
OBS_OUT = os.path.join("chiprun_out", "obs")
OBS_MODES = ("off", "default", "traced")


def _obs_confs(mode: str, tag: str) -> dict:
    """The three observability modes: metrics off (the operator wrapper
    passes partitions through), the default (metrics on, tracing off),
    and tracing with its export and the event journal on."""
    if mode == "off":
        return {"spark.rapids.sql.metrics.enabled": False}
    if mode == "default":
        return {}
    return {"spark.rapids.tpu.trace.path":
            os.path.join(OBS_DIR, f"{tag}.trace.json"),
            "spark.rapids.tpu.eventLog.path":
            os.path.join(OBS_DIR, f"{tag}.events.jsonl")}


class _confs:
    """``with _confs(sess, {...}):`` the session's confs set for the body
    and restored after it."""

    def __init__(self, sess, confs: dict):
        self._sess, self._confs = sess, confs

    def __enter__(self):
        self._saved = dict(self._sess.conf._settings)
        for k, v in self._confs.items():
            self._sess.set_conf(k, v)
        return self._sess

    def __exit__(self, *exc):
        self._sess.conf._settings = self._saved
        return False


def _site_delta(before: dict) -> dict:
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    return {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
            if v != before.get(k, 0)}


def _obs_walls(name: str, sess, make_query, check, runs: int) -> dict:
    """The warm wall of a session query three ways (``OBS_MODES``),
    median of ``runs`` each, the modes alternating run by run; every
    answer checked (``check``: float columns at rtol 1e-9, as atomics
    add in another order each run) and equal across modes, and the
    counted syncs by site of every full run and of the query up to its
    collect under the sync debug mode "error" the same in all three."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    walls = {m: [] for m in OBS_MODES}
    full_syncs, pre_syncs, first = {}, {}, None
    for m in OBS_MODES:  # a warm-up in each mode (the trace file's first
        with _confs(sess, _obs_confs(m, name)):  # write, the journal's)
            make_query().collect()
            pre_syncs[m] = _syncs_by_site(make_query().collect_batches)
    for _ in range(runs):
        for m in OBS_MODES:
            with _confs(sess, _obs_confs(m, name)):
                q = make_query()
                before = dict(SYNCS.syncs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = q.collect()
                torch.cuda.synchronize()
                walls[m].append(time.perf_counter() - t0)
                syncs = _site_delta(before)
            check(out, f"{name} ({m})")
            if first is None:
                first = out
            else:
                check(out, f"{name} ({m}) against the first run", first)
            require(full_syncs.setdefault(m, syncs) == syncs,
                    f"{name} ({m}): syncs {syncs} differ between runs")
    require(full_syncs["off"] == full_syncs["default"]
            == full_syncs["traced"], f"{name}: counted syncs by site "
            f"differ between modes: {full_syncs}")
    require(pre_syncs["off"] == pre_syncs["default"] == pre_syncs["traced"],
            f"{name}: syncs before the collect differ between modes: "
            f"{pre_syncs}")
    med = {m: float(np.median(walls[m])) for m in OBS_MODES}
    over = {m: 100.0 * (med[m] - med["off"]) / med["off"]
            for m in ("default", "traced")}
    log(f"obs {name}: median off {med['off']:.4f} s, default "
        f"{med['default']:.4f} s ({over['default']:+.2f}%), traced "
        f"{med['traced']:.4f} s ({over['traced']:+.2f}%); runs {walls}; "
        f"syncs {full_syncs['off']}, before the collect {pre_syncs['off']}")
    return {"wall_s": med, "wall_runs_s": walls, "overhead_pct": over,
            "syncs": full_syncs["off"], "syncs_before_collect":
            pre_syncs["off"]}


def _summary_lines(path: str, top: int) -> list:
    """``tools/trace_summary.py``'s lines for an artifact."""
    import contextlib
    import io
    from spark_rapids_tpu_torch.tools import trace_summary
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        require(trace_summary.main([path, "-n", str(top)]) == 0,
                f"trace_summary failed on {path}")
    return buf.getvalue().splitlines()


def _traced_run(name: str, sess, query, confs: Optional[dict] = None
                ) -> tuple:
    """One traced, journaled run of ``query`` with its artifacts under
    ``chiprun_out/obs/``: (answer, wall, trace document, journal events,
    the query's ledger entries, its counted syncs by site, paths)."""
    from spark_rapids_tpu_torch.obs.events import read_events
    from spark_rapids_tpu_torch.obs.syncledger import SYNC_LEDGER, SYNCS
    from spark_rapids_tpu_torch.obs.events import EVENTS
    os.makedirs(OBS_OUT, exist_ok=True)
    EVENTS.close()
    paths = {k: os.path.join(OBS_OUT, f"{name}.{k}") for k in
             ("trace.json", "events.jsonl", "profile.json")}
    for p in paths.values():
        if os.path.exists(p):
            os.unlink(p)
    with _confs(sess, dict(confs or {}, **{
            "spark.rapids.tpu.trace.path": paths["trace.json"],
            "spark.rapids.tpu.eventLog.path": paths["events.jsonl"]})):
        seq0 = SYNC_LEDGER.seq
        before = dict(SYNCS.syncs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = query.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = _site_delta(before)
    sess.last_profile.save(paths["profile.json"])
    with open(paths["trace.json"]) as f:
        doc = json.load(f)
    events = read_events(paths["events.jsonl"])
    qid = events[0]["query"]
    entries = [e for e in SYNC_LEDGER.entries(since_seq=seq0)
               if e["query"] == qid]
    return out, wall, doc, events, entries, syncs, paths


def _by_site(items, site) -> dict:
    out: dict = {}
    for it in items:
        s = site(it)
        out[s] = out.get(s, 0) + 1
    return out


def obs_phase(q3_cell, paths: dict, q9_want, lineitem, batch_rows: int,
              runs: int, queries: dict, report: dict,
              claims: Optional[int] = None) -> None:
    """Observability on the card (``spark_rapids_tpu_torch/obs``): the
    session Q3 cell (its cached SF10 uploads, ``HASH_AGG_CONFS``; B1-B4)
    and session Q6 from the SF 0.5 Parquet file (B1, B5, B7) three ways
    (``_obs_walls``); one traced Q3 whose export, sync spans, ledger and
    journal agree; Q3 under ``profile.syncEachOp``, whose every node's
    device, transfer and dispatch seconds sum to its exclusive time; Q3
    under ``transferGuard=disallow`` with the same counted syncs; one
    traced Q9 from the Parquet files, summarized by the port's
    ``trace_summary`` (B.4's step 0), its answer equal to ``q9_want``.
    ``lineitem`` is the frame of the Parquet lineitem (Q6's reference).
    ``claims``: the nodes of Q3's plan that its exchanges' fused filters
    claim (they run no batch), stated by the caller where the plan's
    shape is known. Uploads nothing new."""
    from spark_rapids_tpu_torch.models import tpch as T
    t_phase = time.perf_counter()
    sess, tables, q3_want = q3_cell
    rec: dict = {}
    os.makedirs(OBS_DIR, exist_ok=True)

    def check_q3_out(out, what, other=None):
        check_q3(out, q3_want)
        if other is not None:
            same_by_key(out, other, ["l_orderkey"], what)

    rec["session_q3"] = _obs_walls(
        "session_q3", sess, lambda: T.q3(sess, tables), check_q3_out, runs)
    # the cell runs warm under the capacity speculation (the JAX
    # package's default): its two joins' totals and its two exchanges'
    # shrink counts are one speculation.verify (before it: two join
    # totals)
    want = VERIFY
    require(rec["session_q3"]["syncs_before_collect"] == want,
            f"obs session Q3: {rec['session_q3']['syncs_before_collect']} "
            f"before the collect, expected {want}")

    s6 = session_of(batch_rows, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.cacheDeviceScans": False}))
    q6_want = q6_reference(lineitem)

    def check_q6_out(out, what, other=None):
        err = _rel_err([out.revenue[0]], [q6_want if other is None
                                          else other.revenue[0]])
        require(len(out) == 1 and err <= F64_RTOL, f"{what}: rel {err}")

    rec["session_q6_parquet"] = _obs_walls(
        "session_q6_parquet", s6,
        lambda: T.q6(s6, {"lineitem": s6.read.parquet(paths["lineitem"])}),
        check_q6_out, runs)
    del s6

    # one traced Q3: the export, its spans, the sync track, the journal
    q3 = T.q3(sess, tables)
    out, wall, doc, events, entries, syncs, _ = _traced_run(
        "session_q3", sess, q3)
    check_q3(out, q3_want)
    names = _by_site(doc["traceEvents"], lambda ev: ev["name"])
    require(names.get("Query", 0) == 1, f"obs Q3 trace: Query spans "
            f"{names.get('Query')}")
    # a filter that a collapsed exchange folds into its concat (and the
    # coalesce between them) runs no batch of its own: no span
    claimed = claimed_by_exchanges(sess, sess.last_plan)
    require(claims is None or len(claimed) == claims, f"obs Q3: "
            f"{len(claimed)} nodes claimed by fused filters, stated {claims}")
    nodes = {n.name for n in sess.last_plan.walk()
             if id(n) not in claimed}
    missing = sorted(n for n in nodes if not names.get(n))
    require(not missing, f"obs Q3 trace: no span of {missing}")
    spans = _by_site([ev for ev in doc["traceEvents"]
                      if ev["name"].startswith("sync.")],
                     lambda ev: ev["args"]["site"])
    ledger = _by_site(entries, lambda e: e["site"])
    require(spans == ledger == syncs, f"obs Q3: sync spans {spans}, ledger "
            f"{ledger}, SYNCS {syncs}")
    kinds = [ev["kind"] for ev in events]
    plan_ev = next(ev for ev in events if ev["kind"] == "queryPlan")
    end_ev = events[-1]
    require(kinds[0] == "queryStart" and plan_ev["cpuOps"] == 0
            and end_ev["kind"] == "queryEnd"
            and end_ev["status"] == "success"
            and end_ev["rowsReturned"] == len(out),
            f"obs Q3 journal: {kinds}, plan {plan_ev.get('cpuOps')} CPU "
            f"ops, end {end_ev}")
    rec["q3_traced"] = {"wall_s": wall, "spans": len(doc["traceEvents"]),
                        "syncs": syncs, "events": _by_site(
                            events, lambda ev: ev["kind"])}
    log(f"obs Q3 traced: {wall:.4f} s, {len(doc['traceEvents'])} trace "
        f"events, {len(nodes)} operators with spans, sync spans = ledger = "
        f"SYNCS = {syncs}, journal {rec['q3_traced']['events']}")

    # profile.syncEachOp: the breakdown sums to each node's exclusive time
    with _confs(sess, {"spark.rapids.sql.profile.syncEachOp": True}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = T.q3(sess, tables).collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_q3(out, q3_want)
    prof = sess.profile_json()
    flat = []

    def walk(node):
        flat.append(node)
        for c in node["children"]:
            walk(c)
    walk(prof["plan"])
    # the nodes a collapsed exchange's fused filter claims ran no batch
    ran = [n for n in flat if "breakdown" in n]
    require(len(flat) - len(ran) == len(claimed),
            f"obs Q3 syncEachOp: {len(flat) - len(ran)} nodes without a "
            "breakdown")
    flat = ran
    worst = max(abs(n["breakdown"]["device_s"] + n["breakdown"]["transfer_s"]
                    + n["breakdown"]["dispatch_s"] - n["exclusive_s"])
                for n in flat)
    require(worst <= 1e-3, f"obs Q3 syncEachOp: a node's breakdown misses "
            f"its exclusive time by {worst:.6f} s")
    require(prof["plan"]["inclusive_s"] <= wall, f"obs Q3 syncEachOp: root "
            f"{prof['plan']['inclusive_s']} s past the wall {wall} s")
    top = sorted(flat, key=lambda n: -n["exclusive_s"])[:5]
    rec["q3_sync_each_op"] = {
        "wall_s": wall, "root_inclusive_s": prof["plan"]["inclusive_s"],
        "worst_breakdown_gap_s": worst,
        "top5": [{"op": n["op"][:120], "exclusive_s": n["exclusive_s"],
                  "rows": n["rows"], "batches": n["batches"],
                  **n["breakdown"]} for n in top]}
    log(f"obs Q3 syncEachOp: {wall:.4f} s (root {prof['plan']['inclusive_s']:.4f}"
        f" s), breakdown within {worst * 1e6:.1f} us; top 5 by exclusive: "
        + "; ".join(f"{n['op'][:60]} {n['exclusive_s']:.4f} s (device "
                    f"{n['breakdown']['device_s']:.4f} transfer "
                    f"{n['breakdown']['transfer_s']:.4f} dispatch "
                    f"{n['breakdown']['dispatch_s']:.4f})" for n in top))

    # the transfer guard armed: the same counted syncs, nothing else waits
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    before = dict(SYNCS.syncs)
    with _confs(sess, {"spark.rapids.tpu.debug.transferGuard": "disallow"}):
        out = T.q3(sess, tables).collect()
    guarded = _site_delta(before)
    check_q3(out, q3_want)
    require(guarded == rec["session_q3"]["syncs"], f"obs Q3 under the "
            f"transfer guard: syncs {guarded}, expected "
            f"{rec['session_q3']['syncs']}")
    rec["q3_guarded_syncs"] = guarded
    log(f"obs Q3 transferGuard=disallow: completed, syncs {guarded}")

    # B.4 step 0: where Q9's host time goes, from the files
    s9 = session_of(batch_rows, **{"spark.rapids.sql.cacheDeviceScans":
                                   False})
    t9 = {n: s9.read.parquet(p) for n, p in paths.items()}
    q9 = T.q9(s9, t9)
    q9.collect()  # warm
    out, wall, doc, events, entries, syncs, art = _traced_run(
        "session_q9_parquet", s9, q9)
    same_query(out, q9_want, "q9", "obs Q9 against the Q9 cell's answer")
    summary = s9.profile_json()["summary"]
    lines = _summary_lines(art["trace.json"], 10)
    lines += _summary_lines(art["profile.json"], 10)[-1:]
    for ln in lines:
        log(f"obs Q9 trace_summary: {ln}")
    rec["q9_parquet"] = {
        "wall_s": wall, "syncs": syncs,
        "occupancy_pct": summary["syncs"]["occupancyPct"],
        "sync_s": summary["syncs"]["seconds"],
        "sync_by_site": summary["syncs"]["bySite"],
        "trace_summary": lines}
    del s9, t9, q9
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"obs phase: {rec['phase_s']:.1f} s")
    report["obs_phase"] = rec


def obs_only() -> int:
    """The observability phase alone, on SF1 frames (Q3's cached uploads)
    and SF 0.5 Parquet files made here. Details go to
    ``chiprun_out/chip_smoke_obs.json``."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    frames = {"lineitem": G.gen_lineitem(1), "orders": G.gen_orders(1),
              "customer": G.gen_customer(1)}
    sess = session_of(1 << 23, **T.HASH_AGG_CONFS)
    tables = {n: sess.create_dataframe(f) for n, f in frames.items()}
    T.q3(sess, tables).collect()  # the cold run: the cached uploads
    sfh = SESSION_PARQUET_SF
    framesh = {"lineitem": G.gen_lineitem(sfh), "orders": G.gen_orders(sfh),
               "customer": G.gen_customer(sfh),
               "supplier": G.gen_supplier(sfh), "part": G.gen_part(sfh),
               "partsupp": G.gen_partsupp(sfh), "nation": G.gen_nation()}
    pathsh = G.write_parquet(os.path.join(OBS_DIR, f"sf{sfh}"), sfh,
                             tables=list(framesh), frames=framesh)
    log(f"frames, upload and files: {time.perf_counter() - t0:.1f} s")
    queries, report = {}, {}
    from spark_rapids_tpu_torch.testing import tpchcases as TC
    obs_phase((sess, tables, q3_reference(frames["lineitem"],
                                          frames["orders"],
                                          frames["customer"])),
              pathsh, TC.pandas_reference("q9", framesh),
              framesh["lineitem"], 1 << 23, 3, queries, report)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_obs.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


SHUFFLE_DIR = os.path.join("spark_rapids_tpu_torch", "build", "shuffle")
# the buckets route's partitions (spark.rapids.sql.shuffle.partitions)
SHUFFLE_PARTS = 8
# the MANAGER cells: two simulated executors, joins shuffled, the SF1
# tables in two partitions each, so half the map tasks' blocks cross the
# transport
SHUFFLE_MAP_PARTS = 2
SHUFFLE_MANAGER_CONFS = {"spark.rapids.shuffle.transport.enabled": True,
                         "spark.rapids.shuffle.executors": 2,
                         "spark.rapids.sql.autoBroadcastJoinThreshold": -1}
GUARD = {"spark.rapids.tpu.debug.transferGuard": "disallow"}


def q3_bucket_syncs(parts: int) -> dict:
    """Session Q3's counted syncs up to its collect on the LOCAL buckets
    route, stated before it runs: one ``exchange.split`` a window of 16
    batches of each of its six exchanges (four join inputs, the
    aggregate's, the sort's range; none past 16 batches at 2^23-row
    batches), one ``exchange.rangeBounds`` (the sort's), each of the two
    expanding joins once in each of the ``parts`` partitions, and the
    limit's remaining count once (its input is ``parts`` partitions)."""
    return {"exchange.split": 6, "exchange.rangeBounds": 1,
            "join.expandTotals": 2 * parts, "limit.remaining": 1}


def q3_manager_syncs(parts: int, map_parts: int, blocks: int) -> dict:
    """The same on the MANAGER route: ``exchange.split`` once a map task
    of each exchange (the three scans' ``map_parts`` each, the join's,
    the aggregate's and the range exchange's ``parts`` each, one window
    apiece), and one ``exchange.wire`` a block the other executor serves
    (``blocks``, counted as the writer registers them)."""
    return {"exchange.split": 3 * map_parts + 3 * parts,
            "exchange.rangeBounds": 1, "join.expandTotals": 2 * parts,
            "limit.remaining": 1, "exchange.wire": blocks}


class _remote_blocks:
    """``with _remote_blocks(sess) as n:`` counts the blocks that
    ``CachingShuffleWriter`` registers on executors other than the reduce
    side's (``sess.shuffle_env``), ``n["blocks"]``: the ones a fetch
    serializes."""

    def __init__(self, sess):
        self._local = sess.shuffle_env

    def __enter__(self):
        from spark_rapids_tpu_torch.shuffle import manager as M
        self._real = real = M.CachingShuffleWriter.write
        box = {"blocks": 0}
        local = self._local

        def write(w, partition_batches):
            if w.env is not local:
                box["blocks"] += sum(len(b) for b in partition_batches)
            return real(w, partition_batches)
        M.CachingShuffleWriter.write = write
        return box

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.shuffle import manager as M
        M.CachingShuffleWriter.write = self._real
        return False


def _reset_shuffle_envs(sess) -> None:
    """Close the session's executor pool: the next exchange builds it
    anew with the current transport class."""
    if sess._shuffle_env is not None:
        for env in sess._shuffle_env:
            env.close()
        sess._shuffle_env = None


def _left_over(sess, catalog_before: int) -> dict:
    """What a query left behind: transient ids, catalog entries past
    ``catalog_before``, registered shuffles and shuffle blocks."""
    envs = sess._shuffle_env or []
    return {"transients": len(sess._transient_bids),
            "catalog": len(sess.buffer_catalog._buffers) - catalog_before,
            "shuffles": len(sess._active_shuffles),
            "blocks": sum(len(e.shuffle_catalog._blocks) for e in envs),
            "received": sum(len(e.received_catalog._received)
                            for e in envs)}


def _median_wall(fn, runs: int) -> tuple:
    walls = []
    out = None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls, out


def _ledger_seconds(since: int, site: str) -> float:
    from spark_rapids_tpu_torch.obs.syncledger import SYNC_LEDGER
    return sum(e["seconds"] for e in SYNC_LEDGER.entries(since_seq=since)
               if e["site"] == site)


def shuffle_phase(q3_cell, li1, o1, c1, batch_rows: int, runs: int,
                  queries: dict, report: dict,
                  hash_joins: bool = True) -> None:
    """The exchange's one-card routes and the accelerated shuffle manager
    (``exec/tpu.TpuShuffleExchangeExec``, ``shuffle/``) on the card, every
    query under the sync debug mode "error" (the transfer guard), each
    answer against pandas:

      1. LOCAL buckets, hash: the session Q3 cell (its cached uploads,
         ``HASH_AGG_CONFS``, two shuffled joins) with ``localCollapse``
         off and SHUFFLE_PARTS partitions: B1-B4 in every partition,
         equal to pandas and to the collapse route, the counted syncs by
         site ``q3_bucket_syncs``, nothing left in the catalog;
      2. LOCAL buckets, range: SF1 lineitem ordered by (l_extendedprice
         desc, l_orderkey, l_linenumber), in order equal to a numpy
         lexsort, one ``exchange.rangeBounds`` sync;
      3. round-robin on the card: ``repartition(4)`` of SF1 customer
         written as Parquet, no CPU operator: 4 files whose row counts
         differ by at most 1, read back equal to the frame as a multiset;
      4. MANAGER: Q3 at SF1 over two executors, ``inprocess`` and
         ``socket``, equal to pandas, the counted syncs
         ``q3_manager_syncs``, the shuffle catalogs empty after it; the
         bytes on the wire and the ``exchange.wire`` seconds; then with
         the socket peer's ``fault_drop_tagged_after(1)`` armed, the same
         answer after one retry (``shuffle.fetch.retries`` 1, one
         ``fetchRetry`` event);
      5. the warm walls of Q3 (median of ``runs``) on the collapse, the
         buckets and both MANAGER routes at SF1, and on the collapse and
         buckets routes on the cell's uploads.

    Uploads SF1 lineitem, orders and customer (the frames ``li1``,
    ``o1``, ``c1``), nothing at SF10. ``hash_joins``: a join of the cell
    takes the hash route (B3/B4) on the collapse route, as at SF10; a
    smaller cell's may all take the dense one."""
    import glob

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.obs.syncledger import SYNC_LEDGER
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.sql import functions as F
    t_phase = time.perf_counter()
    rec: dict = {}
    sess, tables, q3_want = q3_cell
    # the routes' stated syncs are those of runs that read their sizes
    # exactly: the capacity cache keys on the plan, which is the same on
    # every route, so speculating one route's sizes on another is left out
    # of these checks (capacity speculation off on the buckets and
    # manager routes; the adaptive phase holds it)
    buckets = {"spark.rapids.sql.shuffle.localCollapse": False,
               "spark.rapids.sql.shuffle.partitions": SHUFFLE_PARTS,
               "spark.rapids.sql.adaptiveCapacity.enabled": False}

    # 1. LOCAL buckets, hash, on the cell's uploads
    K.reset_launches()
    collapse_out = T.q3(sess, tables).collect()
    collapse_launches = dict(K.LAUNCHES)
    check_q3(collapse_out, q3_want)
    require(not hash_joins or collapse_launches["hash_table_build"] > 0,
            f"shuffle Q3 collapse: launches {collapse_launches}, expected "
            f"a join on B3/B4")
    with _confs(sess, buckets):
        T.q3(sess, tables).collect()  # warm: the partial skip decision
        want = q3_bucket_syncs(SHUFFLE_PARTS)
        pre = _syncs_by_site(T.q3(sess, tables).collect_batches)
        require(pre == want, f"shuffle Q3 buckets: syncs before the "
                f"collect {pre}, stated {want}")
        catalog_before = len(sess.buffer_catalog._buffers)
        seq = SYNC_LEDGER.seq
        with _confs(sess, GUARD):
            K.reset_launches()
            out = T.q3(sess, tables).collect()
            launches = dict(K.LAUNCHES)
        sync_s = {site: _ledger_seconds(seq, site) for site in
                  ("exchange.split", "exchange.rangeBounds",
                   "join.expandTotals")}
        check_q3(out, q3_want)
        same_by_key(out, collapse_out, ["l_orderkey"],
                    "shuffle Q3 buckets against the collapse route")
        left = _left_over(sess, catalog_before)
        require(not any(left.values()), f"shuffle Q3 buckets left {left}")
        # each hash-route join builds (B3) and probes (B4) in every
        # partition, the final aggregate runs B2 in every partition
        require(launches["hash_table_build"]
                == SHUFFLE_PARTS * collapse_launches["hash_table_build"]
                and launches["hash_table_probe"]
                >= launches["hash_table_build"]
                and launches["hash_grouped_aggregate"] >= SHUFFLE_PARTS
                and launches["compact_permutation"] > 0,
                f"shuffle Q3 buckets: launches {launches}, collapse "
                f"{collapse_launches}: expected B3 and B4 in each hash join "
                f"of each partition, B2 in each")
        sf10_walls = {}
        sf10_walls["buckets"], runs_b, _ = _median_wall(
            lambda: T.q3(sess, tables).collect(), runs)
    sf10_walls["collapse"], runs_c, _ = _median_wall(
        lambda: T.q3(sess, tables).collect(), runs)
    rec["q3_buckets_hash"] = {"syncs_before_collect": pre,
                              "sync_s": sync_s, "launches": launches,
                              "collapse_launches": collapse_launches,
                              "wall_s": sf10_walls, "wall_runs_s": {
                                  "buckets": runs_b, "collapse": runs_c}}
    log(f"shuffle Q3 buckets ({SHUFFLE_PARTS} partitions, cell uploads): "
        f"syncs {pre}, their seconds {sync_s}, launches {launches}, "
        f"walls buckets "
        f"{sf10_walls['buckets']:.4f} s collapse "
        f"{sf10_walls['collapse']:.4f} s")

    # 1b. the buckets route at the JAX package's defaults (capacity
    # speculation on), right after the collapse route's warm runs: the
    # speculation keys carry every exchange's route
    # (exec/tpu.exchange_routes), so nothing the collapse learned is
    # speculated here. The first run reads its sizes exactly
    # (q3_bucket_syncs); the next speculates its 2 x SHUFFLE_PARTS join
    # totals into one speculation.verify beside the splits, the range
    # bounds and the limit's count, which read every run; no run
    # re-executes
    spec_want = {"exchange.split": 6, "exchange.rangeBounds": 1,
                 "limit.remaining": 1, "speculation.verify": 1}
    spec_buckets = {k: v for k, v in buckets.items()
                    if k != "spark.rapids.sql.adaptiveCapacity.enabled"}
    with _confs(sess, spec_buckets):
        reruns0 = sess.capacity_spec_reruns
        learn = _syncs_by_site(T.q3(sess, tables).collect_batches)
        require(learn == q3_bucket_syncs(SHUFFLE_PARTS), f"shuffle Q3 "
                f"buckets, speculation on: first run's syncs {learn}, "
                f"stated {q3_bucket_syncs(SHUFFLE_PARTS)}")
        spec = _syncs_by_site(T.q3(sess, tables).collect_batches)
        require(spec == spec_want, f"shuffle Q3 buckets, speculation on: "
                f"warm syncs {spec}, stated {spec_want}")
        wall_s, runs_s, out = _median_wall(
            lambda: T.q3(sess, tables).collect(), runs)
        check_q3(out, q3_want)
        same_by_key(out, collapse_out, ["l_orderkey"], "shuffle Q3 "
                    "buckets, speculation on, against the collapse route")
        reruns = sess.capacity_spec_reruns - reruns0
        require(reruns == 0, f"shuffle Q3 buckets, speculation on: "
                f"{reruns} re-executions")
    rec["q3_buckets_speculated"] = {"learn_syncs": learn,
                                    "warm_syncs": spec, "reruns": reruns,
                                    "wall_s": wall_s, "wall_runs_s": runs_s}
    log(f"shuffle Q3 buckets, speculation on: first run {learn}, warm "
        f"{spec}, {reruns} re-executions, warm {wall_s:.4f} s")

    # 2. LOCAL buckets, range: a global sort of SF1 lineitem
    cols = ["l_orderkey", "l_linenumber", "l_extendedprice", "l_quantity"]
    rs = session_of(batch_rows, **dict(buckets, **GUARD))
    frame = li1[cols]
    ldf = rs.create_dataframe(frame)

    def ordered():
        return ldf.order_by(F.col("l_extendedprice").desc(), "l_orderkey",
                            "l_linenumber")
    ordered().collect()  # the cold run: the upload
    pre = _syncs_by_site(ordered().collect_batches)
    require(pre.get("exchange.rangeBounds") == 1
            and pre.get("exchange.split") == 1, f"shuffle range sort: "
            f"syncs before the collect {pre}, stated one rangeBounds and "
            f"one split")
    # one timed run: its 6M rows' collect to pandas leads its wall
    wall, walls, out = _median_wall(lambda: ordered().collect(), 1)
    order = np.lexsort((frame.l_linenumber.to_numpy(),
                        frame.l_orderkey.to_numpy(),
                        -frame.l_extendedprice.to_numpy()))
    for c in cols:
        require(np.array_equal(out[c].to_numpy(), frame[c].to_numpy()[order]),
                f"shuffle range sort: {c} differs from the lexsort")
    rec["range_sort"] = {"rows": len(frame), "syncs_before_collect": pre,
                         "wall_s": wall, "wall_runs_s": walls}
    log(f"shuffle range sort of {len(frame)} rows: {wall:.4f} s, syncs {pre}")
    rs.clear_device_cache()

    # 3. round-robin on the card: repartition(4).write.parquet
    out_dir = os.path.join(SHUFFLE_DIR, "customer_rr")
    cdf = rs.create_dataframe(c1).repartition(4)
    require(all(not n.name.startswith("Cpu") for n in
                rs.physical_plan(cdf._plan).walk()),
            "shuffle repartition: a CPU operator in the plan")
    t0 = time.perf_counter()
    cdf.write.mode("overwrite").parquet(out_dir)
    write_s = time.perf_counter() - t0
    files = sorted(glob.glob(os.path.join(out_dir, "*.parquet")))
    counts = [pq.ParquetFile(f).metadata.num_rows for f in files]
    require(len(files) == 4 and max(counts) - min(counts) <= 1
            and sum(counts) == len(c1), f"shuffle repartition(4): files "
            f"{len(files)} of rows {counts}")
    back = pq.read_table(out_dir).to_pandas().sort_values(
        "c_custkey").reset_index(drop=True)
    want_c = c1.sort_values("c_custkey").reset_index(drop=True)
    for c in want_c.columns:
        require(list(back[c]) == list(want_c[c]),
                f"shuffle repartition(4): {c} read back differs")
    rec["repartition_write"] = {"files": len(files), "rows": counts,
                                "wall_s": write_s}
    log(f"shuffle repartition(4) write of {len(c1)} customer rows: "
        f"{write_s:.4f} s, rows per file {counts}")
    rs.stop()
    del rs, ldf, cdf, back

    # 4. MANAGER over inprocess and socket, and 5. the SF1 walls
    q3_want1 = q3_reference(li1, o1, c1)
    ms = session_of(batch_rows, **dict(T.HASH_AGG_CONFS,
                                       **SHUFFLE_MANAGER_CONFS))
    t1 = {"lineitem": ms.create_dataframe(li1, SHUFFLE_MAP_PARTS),
          "orders": ms.create_dataframe(o1, SHUFFLE_MAP_PARTS),
          "customer": ms.create_dataframe(c1, SHUFFLE_MAP_PARTS)}
    walls1, walls1_runs = {}, {}
    with _confs(ms, {"spark.rapids.shuffle.transport.enabled": False}):
        check_q3(T.q3(ms, t1).collect(), q3_want1)  # the uploads
        walls1["collapse"], walls1_runs["collapse"], out = _median_wall(
            lambda: T.q3(ms, t1).collect(), runs)
        check_q3(out, q3_want1)
        with _confs(ms, buckets):
            T.q3(ms, t1).collect()
            walls1["buckets"], walls1_runs["buckets"], out = _median_wall(
                lambda: T.q3(ms, t1).collect(), runs)
        check_q3(out, q3_want1)
    for transport in ("inprocess", "socket"):
        _reset_shuffle_envs(ms)
        with _confs(ms, {"spark.rapids.shuffle.transport.class": transport,
                         "spark.rapids.sql.shuffle.partitions":
                             SHUFFLE_PARTS,
                         "spark.rapids.sql.adaptiveCapacity.enabled":
                             False}):
            T.q3(ms, t1).collect()  # warm: the executors and their servers
            with _remote_blocks(ms) as blocks:
                pre = _syncs_by_site(T.q3(ms, t1).collect_batches)
            want = q3_manager_syncs(SHUFFLE_PARTS, SHUFFLE_MAP_PARTS,
                                    blocks["blocks"])
            require(pre == want, f"shuffle Q3 manager {transport}: syncs "
                    f"before the collect {pre}, stated {want}")
            catalog_before = len(ms.buffer_catalog._buffers)
            seq = SYNC_LEDGER.seq
            nbytes = REGISTRY.value("shuffle.fetch.bytes") or 0
            with _confs(ms, GUARD):
                out = T.q3(ms, t1).collect()
            check_q3(out, q3_want1)
            left = _left_over(ms, catalog_before)
            require(not any(left.values()),
                    f"shuffle Q3 manager {transport} left {left}")
            wire_bytes = (REGISTRY.value("shuffle.fetch.bytes") or 0) - nbytes
            wire_s = _ledger_seconds(seq, "exchange.wire")
            walls1[transport], walls1_runs[transport], out = _median_wall(
                lambda: T.q3(ms, t1).collect(), runs)
            check_q3(out, q3_want1)
            cell = {"syncs_before_collect": pre, "wire_bytes": wire_bytes,
                    "wire_sync_s": wire_s,
                    "split_sync_s": _ledger_seconds(seq, "exchange.split"),
                    "range_bounds_sync_s": _ledger_seconds(
                        seq, "exchange.rangeBounds")}
            if transport == "socket":
                # a connection dropped mid-transfer: one retry
                envs = ms.shuffle_envs
                retries = REGISTRY.value("shuffle.fetch.retries") or 0
                ev_seq = max((e["seq"] for e in EVENTS.flight_events()),
                             default=0)
                envs[1].transport.fault_drop_tagged_after(1)
                out = T.q3(ms, t1).collect()
                check_q3(out, q3_want1)
                got = (REGISTRY.value("shuffle.fetch.retries") or 0) - retries
                events = [e for e in EVENTS.flight_events()
                          if e["seq"] > ev_seq and e["kind"] == "fetchRetry"]
                require(got == 1 and len(events) == 1
                        and envs[1].transport.stats["faults_fired"] == 1,
                        f"shuffle Q3 socket drop: retries {got}, fetchRetry "
                        f"events {len(events)}, stats "
                        f"{envs[1].transport.stats}")
                cell["drop_retry"] = {"retries": got,
                                      "stats": dict(envs[1].transport.stats)}
            rec[f"q3_manager_{transport}"] = cell
            log(f"shuffle Q3 manager {transport}: syncs {pre}, "
                f"{wire_bytes} bytes fetched over the wire, exchange.wire "
                f"{wire_s:.4f} s, exchange.split "
                f"{cell['split_sync_s']:.4f} s, exchange.rangeBounds "
                f"{cell['range_bounds_sync_s']:.4f} s")
    rec["q3_sf1_walls_s"] = walls1
    rec["q3_sf1_wall_runs_s"] = walls1_runs
    log("shuffle Q3 SF1 warm walls (median of "
        f"{runs}): " + ", ".join(f"{k} {v:.4f} s" for k, v in walls1.items()))
    ms.stop()
    del ms, t1
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"shuffle phase: {rec['phase_s']:.1f} s")
    report["shuffle_phase"] = rec


def shuffle_only() -> int:
    """The shuffle phase alone, on SF1 frames: the Q3 cell's uploads in
    2^23-row batches with shuffled joins. Details go to
    ``chiprun_out/chip_smoke_shuffle.json``."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    frames = {"lineitem": G.gen_lineitem(1), "orders": G.gen_orders(1),
              "customer": G.gen_customer(1)}
    sess = session_of(1 << 23, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1}))
    tables = {n: sess.create_dataframe(f) for n, f in frames.items()}
    T.q3(sess, tables).collect()  # the cold run: the cached uploads
    log(f"frames and upload: {time.perf_counter() - t0:.1f} s")
    queries, report = {}, {}
    shuffle_phase((sess, tables, q3_reference(frames["lineitem"],
                                              frames["orders"],
                                              frames["customer"])),
                  frames["lineitem"], frames["orders"], frames["customer"],
                  1 << 23, 3, queries, report, hash_joins=False)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_shuffle.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


# --- the adaptive phase (capacity speculation, dense keys, the fusions,
# the exchange's shrink, shared subtrees, AQE, whole-stage fusion) --------
ADAPTIVE_SKEW_ROWS = 400_000
ADAPTIVE_SKEW_CONFS = {
    "spark.rapids.sql.adaptive.enabled": True,
    "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
    "spark.rapids.sql.shuffle.partitions": 4,
    "spark.rapids.sql.adaptive.skewJoin.skewedPartitionThreshold": 1 << 20,
    "spark.rapids.sql.adaptive.coalesce.minPartitionSize": 1 << 20}
# rollup_q1's wall on the same upload before the exchange's shrink came
# (PERF.md, ROADMAP B.8)
ROLLUP_Q1_BEFORE_S = 2.4505


def _timed_syncs(fn) -> tuple:
    """(wall seconds, counted syncs by site, result) of ``fn`` under the
    sync debug mode "error" (as ``count_syncs``)."""
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    torch.cuda.synchronize()
    before = dict(SYNCS.syncs)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, {k: v - before.get(k, 0) for k, v in SYNCS.syncs.items()
                  if v != before.get(k, 0)}, out


def _frame_of(batches) -> "pd.DataFrame":
    import pandas as pd
    return pd.concat([b.to_pandas() for b in batches], ignore_index=True)


def _plan_ops(sess, df) -> list:
    return [type(n).__name__ for n in sess.physical_plan(df._plan).walk()]


def fusion_cells(sess, tables: dict, q1_want, q6_want, batches: int,
                 runs: int, report: dict) -> None:
    """Q1 and Q6 on the session Q1/Q6 cell's cached uploads with the
    filter fused into the partial aggregate (``spark.rapids.sql.agg.
    fuseFilter``, the default) and without it: fused, the plan holds no
    TpuFilterExec and the filter compacts nothing (kernel B1 launches
    ``batches`` fewer times a run, one a filtered batch); the warm walls
    of both, the median of ``runs``, each answer against pandas. The
    adaptive phase reports them."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.ops import kernels as K
    out: dict = {}
    for qname in ("q1", "q6"):
        rec = {}
        for mode, fuse in (("on", True), ("off", False)):
            sess.set_conf("spark.rapids.sql.agg.fuseFilter", fuse)
            df = T.QUERIES[qname](sess, tables)
            ops = _plan_ops(sess, df)
            require(("TpuFilterExec" in ops) != fuse,
                    f"fusion {qname} {mode}: plan {ops}")
            got = df.collect()
            if qname == "q1":
                check_q1(got, q1_want)
            else:
                require(_rel_err([got.revenue[0]], [q6_want]) <= F64_RTOL,
                        f"fusion q6 {mode}: {got}")
            med, walls, _o = _median_wall(df.collect_batches, runs)
            K.reset_launches()
            df.collect_batches()
            torch.cuda.synchronize()
            rec[mode] = {"wall_s": med, "wall_runs_s": walls,
                         "b1_launches": K.LAUNCHES["compact_permutation"]}
        sess.reset_conf()
        require(rec["off"]["b1_launches"] - rec["on"]["b1_launches"]
                == batches, f"fusion {qname}: B1 launches {rec}")
        log(f"adaptive fusion {qname}: fused {rec['on']['wall_s']:.4f} s "
            f"(B1 {rec['on']['b1_launches']}), unfused "
            f"{rec['off']['wall_s']:.4f} s (B1 {rec['off']['b1_launches']})")
        out[qname] = rec
    report.setdefault("adaptive", {})["fusion"] = out


def adaptive_phase(q3_cell, li1, o1, c1, batch_rows: int,
                   queries: dict, report: dict, shared: bool = True
                   ) -> None:
    """The adaptive slice (ROADMAP A.10) on the card, every query under
    the sync debug mode "error", each answer against pandas; cells the
    smoke already holds:

      1. speculation: the session Q3 cell (its cached uploads, shuffled
         joins) once cold for the capacity cache, then three warm runs,
         each's counted syncs by site as stated; then one cached join
         capacity cut to a quarter: the next run re-executes once
         (``capacity_spec_reruns``), answers right, and the run after it
         relearns the entry;
      2. dense keys: the Q18 group-by over SF1 lineitem twice, the second
         run on ``BRANCHES["dense"]`` with no hash or sorted branch; a
         stale bound set by hand: one re-execution, the right answer, the
         plan blocklisted;
      3. fusion: the records of ``fusion_cells`` (Q1 and Q6 at SF10);
      4. shrink: rollup_q1 on the session Q1 cell's SF10 upload, its warm
         wall and peak device bytes beside its 2.4505 s before the
         shrink (the
         expression phase's cell records them here);
      5. shared subtrees: the TPC-H cells' Q2, Q11 and Q17 each held one
         reuse node; their warm walls;
      6. AQE: Q3 at SF1 with ``spark.rapids.sql.adaptive.enabled``: its
         stages and decisions, at least one broadcast demotion, one
         ``aqe.stageFetch`` a stage; a skewed-key join gives an
         ``aqeSkewSplit``;
      7. whole stage: a project/filter chain over SF1 lineitem with
         ``spark.rapids.sql.fusion.stageEnabled``: one TpuFusedStageExec,
         the answer equal to the unfused run's."""
    import pandas as pd
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.ops import aggregate as A
    from spark_rapids_tpu_torch.sql import functions as SF_
    from spark_rapids_tpu_torch.testing.datagen import (
        gen_skewed_join_frames,
    )
    rec = report.setdefault("adaptive", {})
    phase0 = time.perf_counter()

    # 1. speculation on the session Q3 cell
    sess, tables, q3_want = q3_cell
    sess.reset_conf()
    sess.capacity_cache.clear()
    q3 = T.q3(sess, tables)
    # stated before the runs: the cold run reads both joins' expansion
    # totals and both exchanges' (the partial and the final aggregate's)
    # shrink counts; the first warm run expands into the cached sizes
    # (one speculation.verify) but still reads the shrink counts, which
    # speculate once two runs agree (the JAX package's rule); the later
    # warm runs make the verify alone
    stated = [{"join.expandTotals": 2, "exchange.shrink": 2},
              {"exchange.shrink": 2, "speculation.verify": 1},
              {"speculation.verify": 1}, {"speculation.verify": 1}]
    spec = {"runs": []}
    for i, want in enumerate(stated):
        wall, got, out = _timed_syncs(q3.collect_batches)
        require(got == want, f"adaptive Q3 run {i}: syncs {got}, "
                f"expected {want}")
        spec["runs"].append({"wall_s": wall, "syncs": got,
                             "max_rel_err": check_q3(_frame_of(out),
                                                     q3_want)})
    reruns0 = sess.capacity_spec_reruns
    key = next(k for k, e in sess.capacity_cache.items()
               if e.get("sizes") and any(sz[0] > 4 for sz in e["sizes"]))
    sess.capacity_cache[key]["sizes"] = [
        [max(sz[0] // 4, 1)] + sz[1:]
        for sz in sess.capacity_cache[key]["sizes"]]
    # the miss: the verify finds the cut capacity short, the query re-runs
    # without speculation (both joins' totals, both shrinks)
    want = {"speculation.verify": 1, "join.expandTotals": 2,
            "exchange.shrink": 2}
    wall, got, out = _timed_syncs(q3.collect_batches)
    require(sess.capacity_spec_reruns == reruns0 + 1,
            f"adaptive Q3 miss: {sess.capacity_spec_reruns - reruns0} "
            "re-executions")
    require(got == want, f"adaptive Q3 miss: syncs {got}, expected {want}")
    spec["miss"] = {"wall_s": wall, "syncs": got,
                    "max_rel_err": check_q3(_frame_of(out), q3_want)}
    require(key not in sess.capacity_cache, "the missed entry stayed")
    # the relearn: the cut join reads its totals again (its entry back in
    # the cache) while the other speculates; the miss dropped both shrink
    # entries too (their counts followed the truncated join), so both
    # exchanges read theirs again
    want = {"join.expandTotals": 1, "exchange.shrink": 2,
            "speculation.verify": 1}
    wall, got, out = _timed_syncs(q3.collect_batches)
    require(key in sess.capacity_cache and got == want,
            f"adaptive Q3 relearn: syncs {got}, expected {want}")
    spec["relearn"] = {"wall_s": wall, "syncs": got,
                       "reruns": sess.capacity_spec_reruns - reruns0,
                       "max_rel_err": check_q3(_frame_of(out), q3_want)}
    rec["speculation"] = spec
    log(f"adaptive speculation Q3: {spec}")

    # 2. dense keys: the Q18 group-by over SF1 lineitem
    ds = session_of(batch_rows)
    li = {"lineitem": ds.create_dataframe(li1)}
    q18 = T.q18_groupby(ds, li)
    sums = li1.groupby("l_orderkey").l_quantity.sum()
    sums = sums[sums > 300]
    want18 = pd.DataFrame({"l_orderkey": sums.index,
                           "sum_qty": sums.to_numpy()})
    # the first run (with the upload) marks the plan as seen; a warm run
    # with dense keys off times the sorted-payload branch beside the
    # second run, which takes the dense composite
    dense = {"runs": []}
    for i, keys in enumerate((True, False, True)):
        ds.set_conf("spark.rapids.sql.agg.denseKeys", keys)
        A.reset_branches()
        wall, got, out = _timed_syncs(q18.collect_batches)
        taken = dict(A.BRANCHES)
        dense["runs"].append({"wall_s": wall, "syncs": got,
                              "branches": taken, "dense_keys": keys})
        same_by_key(_frame_of(out), want18, ["l_orderkey"],
                    f"adaptive dense run {i}")
    ds.reset_conf()
    taken = dense["runs"][2]["branches"]
    require(taken.get("dense", 0) > 0 and not any(
        taken.get(b) for b in ("hash", "sorted_payload", "rowspace_sort")),
        f"adaptive dense: second run's branches {taken}")
    lo, hi = ds.column_stats["l_orderkey"]
    ds.column_stats["l_orderkey"] = (hi + 10000, hi + 40000)
    reruns0 = ds.capacity_spec_reruns
    blocked0 = len(ds.capacity_spec_blocklist)
    same_by_key(q18.collect(), want18, ["l_orderkey"],
                "adaptive dense stale bound")
    require(ds.capacity_spec_reruns == reruns0 + 1
            and len(ds.capacity_spec_blocklist) == blocked0 + 1,
            f"adaptive dense stale bound: {ds.capacity_spec_reruns - reruns0}"
            " re-executions")
    same_by_key(q18.collect(), want18, ["l_orderkey"],
                "adaptive dense after the blocklist")
    require(ds.capacity_spec_reruns == reruns0 + 1,
            "adaptive dense: a blocklisted plan re-executed")
    ds.clear_device_cache()
    rec["dense"] = dense
    log(f"adaptive dense: {dense}")

    # 4. shrink: rollup_q1 on the SF10 upload (the expression phase's
    # cell, which measures its peak device bytes: recorded there)

    # 5. shared subtrees: the TPC-H cells' records
    if shared:
        out = {}
        for qname in ("q2", "q11", "q17"):
            r = queries[f"session_{qname}"]
            require(r.get("shared_subtrees") == 1,
                    f"adaptive {qname}: {r.get('shared_subtrees')} reuse "
                    "nodes")
            out[qname] = {"wall_s": r["wall_s"], "reuse_nodes": 1}
        rec["shared_subtrees"] = out
        log(f"adaptive shared subtrees: {out}")

    # 6. AQE: Q3 at SF1, and a skewed-key join. The broadcast threshold
    # sits just below the smaller of customer's and orders' static size
    # estimates, so the static planner shuffles both joins and only the
    # measured (filtered) build side can demote one
    aq = session_of(batch_rows, **{"spark.rapids.sql.adaptive.enabled":
                                   True})
    t1 = {"lineitem": aq.create_dataframe(li1),
          "orders": aq.create_dataframe(o1),
          "customer": aq.create_dataframe(c1)}
    threshold = min(t1[n]._plan.estimated_size_bytes()
                    for n in ("orders", "customer")) - 1
    aq.set_conf("spark.rapids.sql.autoBroadcastJoinThreshold", threshold)
    q3a = T.q3(aq, t1)
    q3a.collect()  # the uploads
    wall, got, out = _timed_syncs(q3a.collect_batches)
    last = aq.last_aqe
    stages = last["stages"]
    rules = [d["rule"] for d in last["decisions"]]
    require(got.get("aqe.stageFetch") == stages and stages >= 1,
            f"adaptive AQE Q3: {stages} stages, syncs {got}")
    require("broadcastDemotion" in rules,
            f"adaptive AQE Q3: no broadcast demotion: {last['decisions']}")
    aq.reset_conf()
    aqe = {"q3": {"wall_s": wall, "syncs": got, "stages": stages,
                  "threshold_bytes": threshold,
                  "decisions": last["decisions"],
                  "max_rel_err": check_q3(_frame_of(out),
                                          q3_reference(li1, o1, c1))}}
    rng = np.random.default_rng(7)
    fact, dim = gen_skewed_join_frames(rng, n_fact=ADAPTIVE_SKEW_ROWS,
                                       n_dim=1000, hot_prob=0.8)
    for k, v in ADAPTIVE_SKEW_CONFS.items():
        aq.set_conf(k, v)
    sk = (aq.create_dataframe(fact, 4)
          .join(aq.create_dataframe(dim.rename(columns={"k": "k2"}), 2),
                left_on=["k"], right_on=["k2"])
          .group_by("k").agg(SF_.sum(SF_.col("v") + SF_.col("w"))
                             .alias("sv")))
    sk.collect()  # the uploads
    wall, got, out = _timed_syncs(sk.collect_batches)
    skew_out = _frame_of(out)
    splits = [d for d in aq.last_aqe["decisions"]
              if d["rule"] == "skewSplit"]
    require(splits and any(e["kind"] == "aqeSkewSplit"
                           for e in EVENTS.flight_events()),
            f"adaptive skew join: no split {aq.last_aqe['decisions']}")
    require(got.get("aqe.stageFetch") == aq.last_aqe["stages"],
            f"adaptive skew join: syncs {got}")
    m = fact.merge(dim.rename(columns={"k": "k2"}), left_on="k",
                   right_on="k2")
    m = m.assign(s=m.v + m.w).groupby("k", as_index=False).s.sum()
    same_by_key(skew_out.rename(columns={"sv": "s"}), m, ["k"],
                "adaptive skew join")
    aqe["skew"] = {"wall_s": wall, "syncs": got,
                   "stages": aq.last_aqe["stages"],
                   "decisions": aq.last_aqe["decisions"]}
    aq.clear_device_cache()
    rec["aqe"] = aqe
    log(f"adaptive AQE: {aqe}")

    # 7. whole-stage fusion over SF1 lineitem
    ws = session_of(batch_rows)
    wl = ws.create_dataframe(li1[["l_quantity", "l_extendedprice",
                                  "l_discount", "l_tax"]])
    chain = (wl.filter(SF_.col("l_quantity") > 10)
             .with_column("x", SF_.col("l_extendedprice")
                          * (1 - SF_.col("l_discount")))
             .with_column("y", SF_.col("x") * (1 + SF_.col("l_tax")))
             .filter(SF_.col("y") > 20000.0)
             .with_column("z", SF_.col("y") - SF_.col("x")))
    off = chain.collect()  # the upload
    # the same chain's warm wall unfused and fused, up to the collect,
    # median of 3 each, the two alternated
    walls: dict = {False: [], True: []}
    for _ in range(3):
        for on_ in (False, True):
            ws.set_conf("spark.rapids.sql.fusion.stageEnabled", on_)
            walls[on_].append(_median_wall(chain.collect_batches, 1)[0])
    ws.set_conf("spark.rapids.sql.fusion.stageEnabled", True)
    fused = [n for n in ws.physical_plan(chain._plan).walk()
             if type(n).__name__ == "TpuFusedStageExec"]
    require(len(fused) == 1, f"adaptive whole stage: {len(fused)} fused "
            "stages")
    wall, got, out = _timed_syncs(chain.collect_batches)
    on = _frame_of(out)
    require(got == {}, f"adaptive whole stage: syncs {got}")
    same_by_key(on.assign(i=range(len(on))), off.assign(i=range(len(off))),
                ["i"], "adaptive whole stage")
    ws.clear_device_cache()
    rec["whole_stage"] = {"wall_s": float(np.median(walls[True])),
                          "wall_runs_s": walls[True],
                          "unfused_wall_s": float(np.median(walls[False])),
                          "unfused_wall_runs_s": walls[False],
                          "checked_wall_s": wall,
                          "members": fused[0].member_ops, "rows": len(on)}
    log(f"adaptive whole stage: {rec['whole_stage']}")
    rec["phase_s"] = time.perf_counter() - phase0
    report["adaptive_phase_s"] = rec["phase_s"]
    log(f"adaptive phase: {rec['phase_s']:.1f} s")


def _rollup_q1(li):
    """TPC-H Q1's filter and eight aggregates as a rollup of
    (l_returnflag, l_linestatus)."""
    from spark_rapids_tpu_torch.sql import functions as SF_
    q1_cols = ["l_returnflag", "l_linestatus", "l_quantity",
               "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    ep, d, tx = (SF_.col("l_extendedprice"), SF_.col("l_discount"),
                 SF_.col("l_tax"))
    return (li.filter(SF_.col("l_shipdate") <= datetime.date(1998, 9, 2))
            .select(*q1_cols).rollup("l_returnflag", "l_linestatus")
            .agg(SF_.sum("l_quantity").alias("sum_qty"),
                 SF_.sum("l_extendedprice").alias("sum_base_price"),
                 SF_.sum(ep * (1 - d)).alias("sum_disc_price"),
                 SF_.sum(ep * (1 - d) * (1 + tx)).alias("sum_charge"),
                 SF_.avg("l_quantity").alias("avg_qty"),
                 SF_.avg("l_extendedprice").alias("avg_price"),
                 SF_.avg("l_discount").alias("avg_disc"),
                 SF_.count("*").alias("count_order")))



# ---------------------------------------------------------------------------
# Serving (A.11's serving half): scheduler, caches, monitor, fleet
# ---------------------------------------------------------------------------

SERVING_DIR = os.path.join("spark_rapids_tpu_torch", "build", "serving")
SERVING_WORKERS = 2
# tenant -> weight; jobs go round the tenants
SERVING_WEIGHTS = {"a": 1.0, "b": 1.0, "c": 3.0}
# each round submits one job of every kind: 6 rounds, 24 jobs
SERVING_ROUNDS = 6
SERVING_KINDS = ("q1", "q6", "q3", "q6_parquet")
# the fleet workers' share of the card each: with the parent's uploads
# the three processes stay well inside the 80 GB
SERVING_FLEET_FRACTION = 0.1
SERVING_FLEET_SF = 1
# where the fleet workers run (a rehearsal off the card sets "cpu")
SERVING_FLEET_DEVICE = "cuda"
_PROM_SAMPLE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*='
                r'"(?:\\.|[^"\\])*"(,[a-zA-Z_][a-zA-Z0-9_]*='
                r'"(?:\\.|[^"\\])*")*\})? -?[0-9]+(\.[0-9]+)?'
                r'([eE][+-]?[0-9]+)?$')


def _http_get(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        require(r.status == 200, f"{url}: HTTP {r.status}")
        return r.read().decode()


def _read_monitor(base: str, expect_scheduler: bool) -> dict:
    """/healthz, /metrics (every line parsed as Prometheus text),
    /api/status (the card's name and memory) and /api/scheduler."""
    import re
    health = json.loads(_http_get(base + "/healthz"))
    require(health["status"] == "ok", f"/healthz: {health}")
    body = _http_get(base + "/metrics")
    families = 0
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            families += 1
        else:
            require(bool(re.match(_PROM_SAMPLE, line)),
                    f"/metrics: not Prometheus text: {line!r}")
    status = json.loads(_http_get(base + "/api/status"))
    dev = status.get("device") or {}
    require(dev.get("name") == torch.cuda.get_device_name(0)
            and 0 < dev.get("freeBytes", 0) <= dev.get("totalBytes", 0),
            f"/api/status: device {dev}")
    sched = json.loads(_http_get(base + "/api/scheduler"))["schedulers"]
    require(not expect_scheduler or any(
        s["workers"] == SERVING_WORKERS for s in sched),
        f"/api/scheduler: {sched}")
    return {"families": families, "device": dev,
            "memory": status.get("memory"),
            "running": [len(s["running"]) for s in sched]}


# the fleet's queries: generated and run once in each worker as it boots
# (its prime queries), then submitted by two tenants
FLEET_QUERIES = {q: {"kind": "suite", "suite": "tpch", "query": q,
                     "sf": SERVING_FLEET_SF} for q in ("q1", "q6")}


class _FleetBoot:
    """``launch_process_fleet(2, ...)`` on a thread of its own, so that
    the two workers boot (imports, CUDA context, session, their SF1
    tables and a first run of each query) while the in-process part of
    the serving phase runs; the nvcc build directory is seeded with this
    process's libraries first."""

    def __init__(self):
        import shutil
        import threading

        from spark_rapids_tpu_torch.models import tpch as T
        from spark_rapids_tpu_torch.ops import cudalib
        self.rec: dict = {}
        self.router = None
        self.error = None
        fleet_dir = os.path.abspath(os.path.join(SERVING_DIR, "fleet"))
        shutil.rmtree(fleet_dir, ignore_errors=True)
        cc = os.path.join(fleet_dir, "compilecache")
        os.makedirs(cc)
        seeded = [f for f in os.listdir(cudalib.BUILD)
                  if f.startswith("lib")
                  and (f.endswith(".so") or f.endswith(".so.json"))]
        for f in seeded:
            shutil.copy2(os.path.join(cudalib.BUILD, f),
                         os.path.join(cc, f))
        self.rec["seeded_files"] = sorted(seeded)
        self.conf = dict(T.HASH_AGG_CONFS, **{
            "spark.rapids.memory.tpu.allocFraction": SERVING_FLEET_FRACTION,
            "spark.rapids.sql.cacheDeviceScans": True,
            "spark.rapids.sql.test.enabled": True})
        self._dir = fleet_dir
        self._thread = threading.Thread(target=self._boot, daemon=True)
        self._t0 = time.perf_counter()
        self._thread.start()

    def _boot(self) -> None:
        from spark_rapids_tpu_torch.serving.fleet.router import (
            launch_process_fleet,
        )
        try:
            # a tenant on each worker, carol pinned to r0 for the kill
            self.router = launch_process_fleet(
                2, self._dir, base_conf=self.conf,
                spec_extras={"device": SERVING_FLEET_DEVICE,
                             "schedulerWorkers": 2,
                             "primeQueries": list(FLEET_QUERIES.values())},
                overrides="alice=r0,bob=r1,carol=r0", start_timeout=180.0)
        except BaseException as e:  # noqa: BLE001 — raised by join
            self.error = e
        self.rec["launch_s"] = time.perf_counter() - self._t0

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.router


def _serving_fleet(boot: _FleetBoot, li1, report: dict) -> dict:
    """Two ``fleet/worker.py`` processes on this card from one seeded
    nvcc build directory (``_FleetBoot``): their answers against their
    oracles and pandas, a rolling restart and a killed worker."""
    import threading

    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.serving.fleet.worker import (
        deserialize_frame,
    )
    t_wait = time.perf_counter()
    router = boot.join()
    rec = boot.rec
    rec["boot_wait_s"] = time.perf_counter() - t_wait
    try:
        rec["boot"] = {}
        for rid in ("r0", "r1"):
            st = router.worker(rid).status()
            rec["boot"][rid] = {"boot_s": st.get("bootSeconds"),
                                "compiles": st["compiles"]}
            require(st["compiles"]["backend"] == 0,
                    f"fleet {rid} ran nvcc at boot: {st['compiles']}")
        log(f"serving fleet: 2 workers up in {rec['launch_s']:.1f} s "
            f"(waited {rec['boot_wait_s']:.1f} s for them) {rec['boot']}")
        queries = FLEET_QUERIES
        t0 = time.perf_counter()
        jobs = [router.submit(spec, tenant=t, want_result=True,
                              description=q)
                for t in ("alice", "bob") for q, spec in queries.items()]
        require(router.drain(timeout=300), "fleet jobs did not finish")
        rec["jobs_s"] = time.perf_counter() - t0
        oracles: dict = {}

        def oracle(rid, q):
            got = router.worker(rid).oracle(queries[q], timeout=300)
            oracles[(rid, q)] = deserialize_frame(got["result"])
        pairs = {(j.replica, j.description) for j in jobs}
        threads = [threading.Thread(target=oracle, args=p) for p in pairs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        want = {"q1": q1_reference(li1), "q6": q6_reference(li1)}
        for j in jobs:
            require(j.status == "succeeded", f"fleet {j.description} "
                    f"{j.tenant}: {j.status} {j.error}")
            got, ora = j.result(), oracles[(j.replica, j.description)]
            if j.description == "q1":
                check_q1(got, ora)
                check_q1(got, want["q1"])
            else:
                for other in (float(ora.revenue[0]), want["q6"]):
                    require(_rel_err([got.revenue[0]], [other])
                            <= F64_RTOL, f"fleet q6 differs: {got}")
        rec["placement"] = {j.tenant: j.replica for j in jobs}
        log(f"serving fleet: {len(jobs)} jobs on "
            f"{sorted(set(rec['placement'].values()))} in "
            f"{rec['jobs_s']:.1f} s, equal to the oracles and pandas")
        # a rolling restart of r1, pre-warmed from the fleet's manifest,
        # jobs in flight around it
        before = [router.submit(spec, tenant=t) for t in ("alice", "bob")
                  for spec in queries.values()]
        t0 = time.perf_counter()
        out = router.restart_process_worker("r1", prewarm=True,
                                            drain_timeout=120.0,
                                            ready_timeout=120.0)
        rec["restart_s"] = time.perf_counter() - t0
        after = [router.submit(spec, tenant=t) for t in ("alice", "bob")
                 for spec in queries.values()]
        require(router.drain(timeout=300), "fleet jobs did not finish")
        for j in before + after:
            require(j.status == "succeeded",
                    f"fleet job around the restart: {j.status} {j.error}")
        st = router.worker("r1").status()
        rec["restart"] = {"aot": out["aot"], "ready": out["ready"],
                          "compiles": st["compiles"],
                          "boot_s": st.get("bootSeconds"),
                          "shed": router.snapshot(
                              include_workers=False)["shedTotal"]}
        aot = out["aot"] or {}
        require(out["ready"] and rec["restart"]["shed"] == 0
                and st["compiles"]["backend"] == 0
                and aot.get("failed", 0) == 0 and aot.get("warmed", 0) > 0,
                f"rolling restart: {rec['restart']}")
        log(f"serving fleet: r1 restarted in {rec['restart_s']:.1f} s, "
            f"pre-warm warmed {aot.get('warmed')} skipped "
            f"{aot.get('skipped')} pending {aot.get('pending')}, "
            f"{rec['restart']['compiles']} compiles, shed 0")
        # a worker killed with a job in flight
        seq = max((e["seq"] for e in EVENTS.flight_events()), default=0)
        hang = router.submit({"kind": "sleep", "seconds": 30},
                             tenant="carol")
        deadline = time.monotonic() + 30
        while hang.status == "queued" and time.monotonic() < deadline:
            time.sleep(0.01)
        require(hang.replica == "r0", f"carol not on r0: {hang.replica}")
        time.sleep(0.2)
        router.worker("r0").proc.kill()
        require(hang.wait(60) == "lost" and "lost" in (hang.error or ""),
                f"killed worker's job: {hang.status} {hang.error}")
        again = router.submit(queries["q6"], tenant="carol",
                              want_result=True)
        require(again.wait(300) == "succeeded" and again.replica == "r1",
                f"carol after the kill: {again.status} {again.replica} "
                f"{again.error}")
        lost = [e for e in EVENTS.flight_events()
                if e["seq"] > seq and e["kind"] == "workerLost"]
        require(lost and lost[0]["replica"] == "r0"
                and lost[0]["inflightFailed"] == 1,
                f"no workerLost event: {lost}")
        rec["kill"] = {"status": hang.status, "error": hang.error,
                       "replaced_on": again.replica}
        log("serving fleet: r0 killed, its job lost, carol re-placed on r1")
    finally:
        router.shutdown(timeout=30.0)
    return rec


def serving_phase(q1_cell, q3_frames: dict, wants: dict, pq_path: str,
                  li1, report: dict, hash_joins: bool = True) -> None:
    """A.11's serving half on the card, on the session Q1 cell (its SF10
    lineitem with Q1's and Q6's uploads cached; orders and customer added
    from ``q3_frames``, uploaded by the first Q3; ``HASH_AGG_CONFS`` for
    the phase, its confs and its cache put back after; ``wants``: the
    pandas answers by kind):

      1. the live monitor on port 0, and each job kind once single
         threaded: Q1, Q6 and Q3 on the SF10 tables, Q6 over a fresh read
         of the Parquet file (so each run decodes it: B5-B7), cold, then
         two warm walls, its launches and its counted syncs by site under
         the sync debug mode "error" (the SF10 kinds' warm syncs: one
         ``speculation.verify``);
      2. a ``QueryScheduler`` of ``SERVING_WORKERS`` workers, tenants a, b
         and c at weights 1, 1 and 3, takes 24 jobs (every kind six times)
         under the sync debug mode "error", with the plan cache cleared:
         every answer equals pandas, the launches by kernel and the syncs
         by site are the sum of the jobs' single-threaded ones, plan-cache
         hits are jobs - distinct plans with no tag and convert on a hit;
         /healthz, /metrics, /api/status and /api/scheduler read meanwhile;
      3. the result cache: a repeat of Q3 makes no launch and no sync;
      4. one running Q3 cancelled and one past its deadline: statuses,
         events, and the catalog's and the meter's bytes back where they
         were; a burst past ``maxQueuedQueries`` shed;
      5. the fleet (``_serving_fleet``), booted from the phase's start
         (``_FleetBoot``).
    ``hash_joins``: Q3's lineitem join takes B3/B4 (at SF10 its
    l_orderkey range passes the dense route's 2^24; at SF1 it is dense).
    Records go to ``report["serving"]``."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.obs import monitor
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.obs.progress import PROGRESS
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    from spark_rapids_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    sess, q1_tables = q1_cell
    tables = dict(q1_tables, **{n: sess.create_dataframe(f)
                                for n, f in q3_frames.items()})
    rec: dict = {"workers": SERVING_WORKERS, "weights": SERVING_WEIGHTS}
    report["serving"] = rec
    # the fleet's workers boot meanwhile (their imports and CUDA contexts
    # share the host with the walls below: PERF.md §6)
    boot = _FleetBoot()
    saved = dict(sess.conf._settings)
    for k, v in T.HASH_AGG_CONFS.items():
        sess.set_conf(k, v)
    permits = sess.semaphore.permits
    sess.semaphore.resize(SERVING_WORKERS)
    for t, w in SERVING_WEIGHTS.items():
        sess.set_conf(f"spark.rapids.tpu.serving.tenant.{t}.weight", w)
    sess.set_conf("spark.rapids.tpu.ui.enabled", True)
    sess.set_conf("spark.rapids.tpu.ui.port", 0)
    make = {
        "q1": lambda s: T.q1(s, tables),
        "q6": lambda s: T.q6(s, tables),
        "q3": lambda s: T.q3(s, tables),
        "q6_parquet": lambda s: T.q6(
            s, {"lineitem": s.read.parquet(pq_path)}),
    }

    def check(kind, out) -> float:
        if kind == "q1":
            return check_q1(out, wants["q1"])
        if kind == "q3":
            return check_q3(out, wants["q3"])
        err = _rel_err([out.revenue[0]], [wants[kind]])
        require(len(out) == 1 and err <= F64_RTOL,
                f"served {kind} differs: {err}")
        return err

    def counts_of(fn) -> tuple:
        K.reset_launches()
        syncs = _syncs_by_site(fn)
        return dict(K.LAUNCHES), syncs
    try:
        # 1. single-threaded
        single = {}
        for kind in SERVING_KINDS:
            make[kind](sess).collect()  # cold: uploads, speculation
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = make[kind](sess).collect()
                walls.append(time.perf_counter() - t0)
            err = check(kind, out)
            launches, syncs = counts_of(lambda: make[kind](sess).collect())
            again = counts_of(lambda: make[kind](sess).collect())
            require((launches, syncs) == again,
                    f"serving {kind}: launches or syncs differ between "
                    f"runs: {launches} {syncs} / {again}")
            if kind != "q6_parquet":
                require({k: v for k, v in syncs.items()
                         if k == "speculation.verify"} == VERIFY,
                        f"serving {kind}: warm syncs {syncs}")
            single[kind] = {"wall_s": float(np.median(walls)),
                            "walls_s": walls, "launches": launches,
                            "syncs": syncs, "max_rel_err": err}
            log(f"serving {kind} single-threaded: {np.median(walls):.4f} s,"
                f" launches {launches}, syncs {syncs}")
        rec["single"] = single
        base = monitor.server().url
        # 2. the served run
        sess.clear_serving_caches()

        def plan_hits() -> int:
            return sum(m.value for m in REGISTRY.metrics()
                       if m.name == "plancache.hits")
        hits0 = plan_hits()
        conversions = []
        orig_convert = sess._convert_cpu

        def counting_convert(plan):
            # a miss's tag and convert, timed: what a hit saves
            t0 = time.perf_counter()
            out = orig_convert(plan)
            conversions.append(time.perf_counter() - t0)
            return out
        sess._convert_cpu = counting_convert
        sched = sess.serving_scheduler(workers=SERVING_WORKERS)
        tenants = list(SERVING_WEIGHTS)
        plan = [SERVING_KINDS[i % len(SERVING_KINDS)]
                for i in range(SERVING_ROUNDS * len(SERVING_KINDS))]
        mid = None
        try:
            K.reset_launches()
            syncs0 = dict(SYNCS.syncs)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                jobs = [(kind, sched.submit(make[kind],
                                            tenant=tenants[i % 3],
                                            description=kind))
                        for i, kind in enumerate(plan)]
                while mid is None and not all(j.done() for _, j in jobs):
                    if any(j.status == "running" for _, j in jobs):
                        mid = _read_monitor(base, True)
                    time.sleep(0.005)
                require(sched.drain(timeout=600), "served jobs unfinished")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            served_s = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            syncs = {k: v - syncs0.get(k, 0) for k, v in SYNCS.syncs.items()
                     if v != syncs0.get(k, 0)}
            snap = sched.snapshot()
        finally:
            sched.close()
            del sess._convert_cpu
        if mid is None:
            mid = _read_monitor(base, False)
        by_kind: dict = {k: [] for k in SERVING_KINDS}
        for kind, j in jobs:
            require(j.status == "succeeded",
                    f"served {kind} ({j.tenant}): {j.status} {j.error}")
            check(kind, j.get())
            by_kind[kind].append(j.finished_ts - j.started_ts)
        want_launches = {k: sum(single[kind]["launches"][k]
                                for kind in plan) for k in launches}
        want_syncs: dict = {}
        for kind in plan:
            for site, n in single[kind]["syncs"].items():
                want_syncs[site] = want_syncs.get(site, 0) + n
        require(launches == want_launches,
                f"served launches {launches}, stated {want_launches}")
        require(syncs == want_syncs,
                f"served syncs {syncs}, stated {want_syncs}")
        for name in ("compact_permutation", "hash_grouped_aggregate",
                     "hybrid_expand", "plain_fixed") + (
                         ("hash_table_build", "hash_table_probe")
                         if hash_joins else ()):
            require(launches[name] > 0, f"served jobs never ran {name}")
        distinct = len(set(SERVING_KINDS) - {"q6_parquet"}) \
            + plan.count("q6_parquet")
        hits = plan_hits() - hits0
        require(hits == len(plan) - distinct
                and len(conversions) == distinct,
                f"plan cache: {hits} hits, {len(conversions)} conversions "
                f"for {len(plan)} jobs of {distinct} plans")
        require(snap["peakRunning"] == SERVING_WORKERS,
                f"served jobs never ran {SERVING_WORKERS} at once: {snap}")
        rec["served"] = {
            "jobs": len(plan), "wall_s": served_s,
            "single_sum_s": sum(single[k]["wall_s"] for k in plan),
            "per_kind_wall_s": {k: float(np.median(v))
                                for k, v in by_kind.items()},
            "launches": launches, "syncs": syncs, "plan_cache_hits": hits,
            "conversions": len(conversions),
            "convert_ms": [round(1e3 * c, 3) for c in conversions],
            "monitor": mid,
            "tenants": {t: {k: snap["tenants"][t][k]
                            for k in ("succeeded", "weight")}
                        for t in tenants}}
        report["serving_launches"] = launches
        log(f"serving: {len(plan)} jobs on {SERVING_WORKERS} workers in "
            f"{served_s:.3f} s (single-threaded sum "
            f"{rec['served']['single_sum_s']:.3f} s); per query served "
            f"{rec['served']['per_kind_wall_s']} against single "
            f"{ {k: round(v['wall_s'], 4) for k, v in single.items()} }; "
            f"plan-cache hits {hits}, conversions {len(conversions)} "
            f"(tag and convert median {1e3 * np.median(conversions):.2f} "
            f"ms, max {1e3 * max(conversions):.2f} ms); "
            f"syncs {syncs}; monitor {mid['families']} families")
        # 3. the result cache
        sess.set_conf("spark.rapids.tpu.serving.resultCache.enabled", True)
        make["q3"](sess).collect()
        launches, syncs = counts_of(lambda: check("q3", make["q3"](
            sess).collect()))
        require(not any(launches.values()) and not syncs,
                f"result-cache repeat: launches {launches} syncs {syncs}")
        sess.set_conf("spark.rapids.tpu.serving.resultCache.enabled",
                      False)
        rec["result_cache_repeat"] = {"launches": 0, "syncs": 0}
        # 4. cancel, deadline, shed
        cat, dm = sess.buffer_catalog, sess.device_manager
        sched = sess.serving_scheduler(workers=SERVING_WORKERS)
        try:
            stops = {}
            for what in ("cancelled", "timeout"):
                seq = max((e["seq"] for e in EVENTS.flight_events()),
                          default=0)
                torch.cuda.synchronize()
                before = (cat.device_store.total_size, dm.allocated)
                if what == "cancelled":
                    job = sched.submit(make["q3"], tenant="stop")
                    # cancelled once its query has pulled a batch
                    deadline = time.monotonic() + 60
                    while not job.done() and time.monotonic() < deadline:
                        live = [q for q in PROGRESS.queries()
                                if q["tenant"] == "stop"
                                and q["status"] == "running"
                                and q["heartbeats"] > 0]
                        if live:
                            job.cancel("stopped by the smoke")
                            break
                        time.sleep(0.0005)
                else:
                    job = sched.submit(
                        make["q3"], tenant="stop",
                        deadline_s=0.1 * min(by_kind["q3"]))
                require(job.wait(120) == what,
                        f"the {what} job ended {job.status} {job.error}")
                torch.cuda.synchronize()
                after = (cat.device_store.total_size, dm.allocated)
                kind = "queryCancelled" if what == "cancelled" \
                    else "queryTimeout"
                evs = [e for e in EVENTS.flight_events()
                       if e["seq"] > seq and e["kind"] == kind]
                require(evs and "events" in evs[-1],
                        f"no {kind} event with its flight tail")
                require(after == before, f"the {what} job left buffers: "
                        f"catalog and meter {before} -> {after}")
                stops[what] = {"error": job.error, "bytes": after}
            rec["stops"] = stops
        finally:
            sched.close()
        sched = sess.serving_scheduler(workers=1, max_queue=2)
        try:
            burst = [sched.submit(make["q3"], tenant="burst")] + [
                sched.submit(make["q6"], tenant="burst") for _ in range(5)]
            require(sched.drain(timeout=300), "burst unfinished")
            statuses = [j.status for j in burst]
            shed = statuses.count("shed")
            require(shed >= 1 and statuses.count("succeeded")
                    == len(burst) - shed
                    and sched.snapshot()["shedTotal"] == shed
                    and any(e["kind"] == "queryShed"
                            for e in EVENTS.flight_events()),
                    f"burst past maxQueuedQueries: {statuses}")
            rec["shed"] = {"statuses": statuses}
        finally:
            sched.close()
        log(f"serving: result-cache repeat 0 launches 0 syncs; cancel "
            f"{rec['stops']['cancelled']['error']!r}, timeout "
            f"{rec['stops']['timeout']['error']!r}, buffers back; burst "
            f"{rec['shed']['statuses']}")
    except BaseException:
        # no worker process outlives a failed phase
        try:
            router = boot.join()
            if router is not None:
                router.shutdown(timeout=30.0)
        except BaseException:  # noqa: BLE001 — the first error stands
            pass
        raise
    finally:
        sess.set_conf("spark.rapids.tpu.ui.enabled", False)
        monitor.stop()
        sess.conf._settings = saved
        sess.semaphore.resize(permits)
        sess.clear_serving_caches()
        # the phase's uploads go (Q3's tables, Q6, the Parquet reads):
        # Q1's stays for the later phases
        keep_scans_of(sess, T.q1(sess, q1_tables))
        torch.cuda.set_sync_debug_mode("default")
    rec["in_process_s"] = time.perf_counter() - t_phase
    # 5. the fleet
    rec["fleet"] = _serving_fleet(boot, li1, report)
    rec["phase_s"] = time.perf_counter() - t_phase
    report["serving_phase_s"] = rec["phase_s"]
    log(f"serving phase: {rec['phase_s']:.1f} s (in process "
        f"{rec['in_process_s']:.1f} s)")
    print(json.dumps({"serving_launches": report["serving_launches"]}))


def serving_only() -> int:
    """The serving phase alone, on SF1 frames and an SF 0.5 Parquet
    lineitem made here (its Q1 cell at SF1 in place of SF10). Details go
    to ``chiprun_out/chip_smoke_serving.json``."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    frames = {"lineitem": G.gen_lineitem(1), "orders": G.gen_orders(1),
              "customer": G.gen_customer(1)}
    sfh = SESSION_PARQUET_SF
    lih = G.gen_lineitem(sfh)
    pq = G.write_parquet(os.path.join(SERVING_DIR, f"sf{sfh}"), sfh,
                         tables=["lineitem"],
                         frames={"lineitem": lih})["lineitem"]
    sess = session_of(1 << 23)
    tables = {"lineitem": sess.create_dataframe(frames["lineitem"])}
    for q in (T.q1, T.q6):
        q(sess, tables).collect()  # the cold runs: the cached uploads
    li = frames["lineitem"]
    log(f"frames, file and uploads: {time.perf_counter() - t0:.1f} s")
    report: dict = {}
    serving_phase((sess, tables),
                  {n: frames[n] for n in ("orders", "customer")},
                  {"q1": q1_reference(li), "q6": q6_reference(li),
                   "q3": q3_reference(li, frames["orders"],
                                      frames["customer"]),
                   "q6_parquet": q6_reference(lih)},
                  pq, li, report, hash_joins=False)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_serving.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0

def export_only() -> int:
    """The export phase alone: the Mortgage ETL at SF 50 through a session
    of its own (one cold run, its uploads cached), then ``export_phase``.
    Details go to ``chiprun_out/chip_smoke_export.json``."""
    from spark_rapids_tpu_torch.models import mortgage as M
    from spark_rapids_tpu_torch.models import mortgage_data as MD
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    perf = MD.gen_performance(MORTGAGE_ETL_SF)
    acq = MD.gen_acquisition(MORTGAGE_ETL_SF)
    sess = session_of(MORTGAGE_BATCH_ROWS, **M.ETL_CONFS)
    qdf = M.run_query("etl", sess, sess.create_dataframe(perf),
                      sess.create_dataframe(acq))
    out = qdf.collect()
    log(f"ETL SF{MORTGAGE_ETL_SF}: tables and the cold collect "
        f"({len(out)} rows): {time.perf_counter() - t0:.1f} s")
    report: dict = {}
    export_phase((sess, qdf, out), report)
    sess.stop()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_export.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def adaptive_only() -> int:
    """The adaptive phase alone, on SF1 frames made here (its Q3 cell at
    SF1 with shuffled joins in place of SF10, its Q1 cell and rollup at
    SF1; the shared-subtree cells need the TPC-H cells and are skipped).
    Details go to ``chip_smoke_adaptive.json`` beside the other phases'
    reports."""
    from spark_rapids_tpu_torch.models import tpch as T
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    frames = {"lineitem": G.gen_lineitem(1), "orders": G.gen_orders(1),
              "customer": G.gen_customer(1)}
    sess = session_of(1 << 23, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": -1}))
    tables = {n: sess.create_dataframe(f) for n, f in frames.items()}
    T.q3(sess, tables).collect()  # the cold run: the cached uploads
    qs = session_of(1 << 23)
    qt = {"lineitem": qs.create_dataframe(frames["lineitem"])}
    queries, report = {}, {}
    fusion_cells(qs, qt, q1_reference(frames["lineitem"]),
                 q6_reference(frames["lineitem"]),
                 -(-len(frames["lineitem"]) // (1 << 23)), 3, report)
    log(f"frames and uploads: {time.perf_counter() - t0:.1f} s")
    adaptive_phase((sess, tables, q3_reference(frames["lineitem"],
                                               frames["orders"],
                                               frames["customer"])),
                   frames["lineitem"], frames["orders"],
                   frames["customer"], 1 << 23, queries, report,
                   shared=False)
    out_dir = os.path.dirname(OBS_OUT)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_adaptive.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def scan_write_only() -> int:
    """The scan-and-write phase alone, on SF1 frames and files made here.
    Details go to ``chiprun_out/chip_smoke_scan_write.json``."""
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    frames = {"lineitem": G.gen_lineitem(1), "orders": G.gen_orders(1),
              "customer": G.gen_customer(1)}
    paths = G.write_parquet(os.path.join(SCAN_WRITE_DIR + "_src"), 1,
                            frames=frames)
    log(f"frames and files: {time.perf_counter() - t0:.1f} s")
    queries, report = {}, {}
    t0 = time.perf_counter()
    scan_write_phase(frames["lineitem"], frames["orders"],
                     frames["customer"], paths["lineitem"], 1 << 23,
                     queries, report)
    report["scan_write_phase_s"] = time.perf_counter() - t0
    log(f"scan_write phase: {report['scan_write_phase_s']:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_scan_write.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes: build and check the kernels and "
                         "the queries, no full-size timing")
    ap.add_argument("--window-cpu", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--expr-cpu", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--memory-only", action="store_true",
                    help="build the kernels and run only the memory phase "
                         "(its frames generated here); prints no result")
    ap.add_argument("--scan-write-only", action="store_true",
                    help="build the kernels and run only the scan-and-write "
                         "phase (SF1 frames and files made here); prints no "
                         "result")
    ap.add_argument("--obs-only", action="store_true",
                    help="build the kernels and run only the observability "
                         "phase (SF1 Q3 uploads, SF 0.5 files made here); "
                         "prints no result")
    ap.add_argument("--shuffle-only", action="store_true",
                    help="build the kernels and run only the shuffle phase "
                         "(SF1 frames made here); prints no result")
    ap.add_argument("--adaptive-only", action="store_true",
                    help="build the kernels and run only the adaptive "
                         "phase (SF1 frames made here); prints no result")
    ap.add_argument("--export-only", action="store_true",
                    help="build the kernels and run only the export phase "
                         "(the Mortgage ETL's tables at SF 50 made here); "
                         "prints no result")
    ap.add_argument("--serving-only", action="store_true",
                    help="build the kernels and run only the serving "
                         "phase (SF1 frames, an SF 0.5 file and the fleet "
                         "made here); prints no result")
    args = ap.parse_args()
    if args.window_cpu:
        return window_cpu_child(args.window_cpu)
    if args.expr_cpu:
        return expr_cpu_child(args.expr_cpu)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port first: a checkout without it fails here, before any file
    # is written
    import spark_rapids_tpu_torch.session  # noqa: F401
    # the window phase's CPU side, started by ``run`` after the kernels
    # are timed, runs meanwhile in a process of its own
    if args.memory_only:
        return memory_only()
    if args.scan_write_only:
        return scan_write_only()
    if args.obs_only:
        return obs_only()
    if args.shuffle_only:
        return shuffle_only()
    if args.adaptive_only:
        return adaptive_only()
    if args.serving_only:
        return serving_only()
    if args.export_only:
        return export_only()
    children: list = []
    try:
        return run(args, children)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()


def memory_only() -> int:
    """The memory phase alone, on frames generated here (SF10 TPC-H, SF 500
    Mortgage): a quicker check of that phase. Details go to
    ``chiprun_out/chip_smoke_memory.json``."""
    from spark_rapids_tpu_torch.models import mortgage_data as MD
    from spark_rapids_tpu_torch.models import tpch_data as G
    from spark_rapids_tpu_torch.ops import cudalib
    log(f"card: {card_line()}")
    log(f"build: {cudalib.build()}")
    t0 = time.perf_counter()
    frames = {"lineitem": G.gen_lineitem(10), "orders": G.gen_orders(10),
              "customer": G.gen_customer(10)}
    mortgage = ((MD.gen_performance(MORTGAGE_SF),
                 MD.gen_acquisition(MORTGAGE_SF)), {})
    log(f"frames: {time.perf_counter() - t0:.1f} s")
    queries, report = {}, {}
    t0 = time.perf_counter()
    memory_phase(frames, mortgage, 1 << 23, queries, report, {})
    report["memory_phase_s"] = time.perf_counter() - t0
    log(f"memory phase: {report['memory_phase_s']:.1f} s")
    report["queries"] = queries
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_memory.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


# cut from 2^23, then 2^22, then 2^21, for the smoke's time (PERF.md §4)
WINDOW_ROWS = 1 << 20
# the session's Parquet cells and Q9 from files: cut from SF1 for the
# smoke's time (PERF.md)
SESSION_PARQUET_SF = 0.5
WINDOW_ROWS_QUICK = 1 << 16
# the ETL at SF 50, the other three at SF 500: the smoke keeps within
# its time limit (the ETL at SF 500 on one H100: 7.46 s warm, 31.0 GiB
# peak, equal to pandas; PERF.md); the ETL cut from SF 250 once the
# shuffle phase came, to SF 50 once the serving phase did (PERF.md §4)
MORTGAGE_SF = 500
MORTGAGE_ETL_SF = 50
# cut from SF 250 for the smoke's time once the plain-strings phase came
# in, to SF 150 once the expression phase did, to SF 50 once the
# scan-and-write phase did, to SF 30 once the observability phase did,
# to SF 20 once the shuffle phase did, then to SF 10 once the serving
# phase did (PERF.md §4)
TPCXBB_SF = 10
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
    expr_child = start_expr_cpu(EXPR_CASE_ROWS_QUICK if args.quick
                                else EXPR_CASE_ROWS)
    children.append(expr_child)

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

    # the same queries through the port's TpuSparkSession; its spill files
    # (the memory phase's spill cell reuses this session) go to the build
    # directory
    sess = session_of(q1_batch, **{
        "spark.rapids.memory.spill.diskDir": MEMORY_SPILL_DIR})
    tables = {"lineitem": sess.create_dataframe(df)}
    out, rec = run_session_query("session Q1", T.q1(sess, tables), runs,
                                 queries["q1"], sf_q1, len(df), VERIFY)
    earlier = {"q1_want": q1_want, "session_q1": out}
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
                                 queries["q6"], sf_q1, len(df), VERIFY)
    err = _rel_err([out.revenue[0]], [q6_want])
    require(len(out) == 1 and err <= F64_RTOL,
            f"session Q6 revenue differs: {err}")
    rec["max_rel_err"] = max(err, same_by_key(out, q6_runner, ["revenue"],
                                              "session Q6 against the "
                                              "runner"))
    queries["session_q6"] = rec
    # the adaptive phase's fusion cells: Q1 and Q6 with the filter fused
    # into the partial aggregate and without, on these cached uploads
    t0 = time.perf_counter()
    fusion_cells(sess, tables, q1_want, q6_want,
                 -(-len(df) // q1_batch), 1 if args.quick else 3, report)
    report["adaptive_fusion_s"] = time.perf_counter() - t0
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
    # the memory phase's spill cell runs Q1 again on this session's cached
    # upload (4.07 GB on the card until then), the serving phase Q1 and Q6:
    # the rest of its cache goes (Q6's after the serving phase)
    keep_scans_of(sess, T.q1(sess, tables), T.q6(sess, tables))
    earlier["q1_session"] = (sess, tables)
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
    earlier["q3_want"] = q3_want
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
                                 sf_q1, q3_rows, VERIFY, syncs=2)
    rec["max_rel_err"] = max(check_q3(out, q3_want),
                             check_q3(out, q3_runner))
    require(joined_on_device(rec) and all(rec["launches"][k] > 0 for k in (
        "hash_grouped_aggregate", "compact_permutation")),
        f"session Q3 did not run B1, B2, and B3/B4 or the dense route: "
        f"{rec['launches']} {rec['routes']}")
    queries["session_q3"] = rec
    session_q3 = out
    # the semi join's stream side (the filtered orders) is the collapsed
    # exchange's one masked concat of its two 2^23-row upload batches
    # (exchange.fuseFilter), so the partial after the semi join gets one
    # batch of 2^24 rows' capacity, whose B2 table (``hash_table_size``)
    # passes maxTableSlots (2^24): it splits by key hash, one
    # outofcore.partitionCounts (with the fusion off the collapse passes
    # the two batches on, each within the limit, and nothing splits)
    out, rec = run_session_query("session Q4", T.q4(sess, tables), runs,
                                 queries["q4"], sf_q1, q4_rows,
                                 dict(VERIFY, **{
                                     "outofcore.partitionCounts": 1}))
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
                                 queries["q3"], sf_q1, q3_rows, VERIFY,
                                 syncs=2)
    rec["max_rel_err"] = max(check_q3(out, q3_want),
                             check_q3(out, session_q3))
    rec["threshold_bytes"] = threshold
    queries["session_q3_broadcast"] = rec

    sorted_branch_cells(sess, tables, frames, sf_q1, runs_new, queries,
                        report, q3_want, session_q3)
    t0 = time.perf_counter()
    tpch_cells(sess, tables, frames, sf_q1, runs_new, queries, report)
    report["tpch_cells_s"] = time.perf_counter() - t0
    # the observability phase runs the session Q3 cell again on its
    # cached uploads (HASH_AGG_CONFS, shuffled joins): the rest goes
    sess.reset_conf()
    q3_tables = {n: tables[n] for n in ("lineitem", "orders", "customer")}
    keep_scans_of(sess, T.q3(sess, q3_tables))
    q3_cell = (sess, q3_tables, q3_want)
    del sess, tables, q3_df, q3_tables
    for name in ("supplier", "part", "nation"):
        del frames[name]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # 2^20 rows: cut from 2^22, then 2^21, for the smoke's time (PERF.md)
    # cut from 2^20 rows for the smoke's time (PERF.md §4)
    string_phase(1 << 16 if args.quick else 1 << 19, runs_new, report)
    report["string_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain_strings_phase(args.quick, 1, report)
    report["plain_strings_phase_s"] = time.perf_counter() - t0
    log(f"plain-strings phase: {report['plain_strings_phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # the device Parquet scan: SF1 lineitem, orders and customer files (the
    # runners' Parquet cells, cut from SF10 to SF1 for the smoke's time),
    # and the SF10 customer file (B8's timed chunk, a 2^20-row row group,
    # and the customer collect)
    memory_frames = {"lineitem": df, "orders": frames["orders"],
                     "customer": frames["customer"]}
    cust = frames["customer"]
    del frames, df
    t0 = time.perf_counter()
    df = G.gen_lineitem(sf_q18)
    frames1 = {"lineitem": df, "orders": G.gen_orders(sf_q18),
               "customer": G.gen_customer(sf_q18)}
    report["gen_sf1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = G.write_parquet(os.path.join(pq_dir, f"sf{sf_q18}"), sf_q18,
                            frames=frames1)
    path_cust = G.write_parquet(os.path.join(pq_dir, f"sf{sf_q1}"), sf_q1,
                                tables=["customer"],
                                frames={"customer": cust})["customer"]
    edge = write_edge_files(os.path.join(pq_dir, "edge"))
    report["write_parquet_s"] = time.perf_counter() - t0
    log(f"parquet SF{sf_q18} (customer also SF{sf_q1}): "
        f"{report['write_parquet_s']:.1f} s, "
        + ", ".join(f"{t} {os.path.getsize(p) / 1e6:.1f} MB "
                    f"{praw.file_metadata(p).num_row_groups} row groups"
                    for t, p in dict(paths, customer_sf10=path_cust).items()))
    report["encodings"] = check_encodings(dict(paths, customer=path_cust))
    decode = check_decode(dict(paths, customer=path_cust), edge,
                          G.ROW_GROUP_ROWS)
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
    o1, c1 = frames1["orders"], frames1["customer"]

    def collect(batch, full):
        return batch.to_pandas() if full else batch

    out, rec = run_parquet_query(
        "Q1 parquet", lambda: S.scan_table(paths["lineitem"], Q.Q1_COLUMNS),
        lambda t, full: collect(Q.q1_from_batches(t), full), runner_pq_runs,
        rgs["lineitem"], 0)
    rec.update(sf=sf_q18, rows=len(df),
               max_rel_err=check_q1(out, q1_reference(df)))
    queries["q1_parquet"] = rec

    out, rec = run_parquet_query(
        "Q6 parquet", lambda: S.scan_table(paths["lineitem"], Q.Q6_COLUMNS),
        lambda t, full: collect(Q.q6_from_batches(t), full), runner_pq_runs,
        rgs["lineitem"], 0)
    err = _rel_err([out.revenue[0]], [q6_reference(df)])
    require(len(out) == 1 and err <= F64_RTOL, f"Q6 parquet differs: {err}")
    rec.update(sf=sf_q18, rows=len(df), max_rel_err=err)
    queries["q6_parquet"] = rec
    torch.cuda.empty_cache()

    out, rec = run_parquet_query(
        "Q3 parquet", lambda: S.scan_tables(paths, J.Q3_COLUMNS),
        lambda t, full: collect(J.q3_from_batches(t), full), runner_pq_runs,
        sum(rgs.values()), 2)
    rec.update(sf=sf_q18, rows=len(df) + len(o1) + len(c1),
               max_rel_err=check_q3(out, q3_reference(df, o1, c1)))
    require(rec["launches"]["hash_table_build"] > 0,
            "Q3 parquet ran no join")
    queries["q3_parquet"] = rec
    torch.cuda.empty_cache()

    out, rec = run_parquet_query(
        "Q4 parquet", lambda: S.scan_tables(paths, J.Q4_COLUMNS),
        lambda t, full: collect(J.q4_from_batches(t), full), runner_pq_runs,
        rgs["lineitem"] + rgs["orders"], 0)
    want = q4_reference(df, o1)
    require(list(out.o_orderpriority) == list(want.o_orderpriority)
            and list(out.order_count) == list(want.order_count),
            f"Q4 parquet differs from pandas: {out} vs {want}")
    rec.update(sf=sf_q18, rows=len(df) + len(o1), max_rel_err=0.0)
    queries["q4_parquet"] = rec
    torch.cuda.empty_cache()

    out, rec = run_parquet_query(
        "customer collect parquet",
        lambda: S.scan_table(path_cust),
        lambda t, full: collect(S.customer_segment_batches(t), full),
        runner_pq_runs, praw.file_metadata(path_cust).num_row_groups, 0)
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
    del cust, out, want
    torch.cuda.empty_cache()

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
    # runner that collects the same rows; dense keys off, which outrank
    # the hash table on a bounded integer key (the next cell takes them)
    sess = session_of(q18_batch, **dict(T.HASH_AGG_CONFS, **{
        "spark.rapids.sql.agg.denseKeys": False}))
    li_q18 = {"lineitem": sess.create_dataframe(df)}
    out, rec = run_session_query(
        "session Q18 group-by", T.q18_groupby(sess, li_q18), runs,
        {"wall_s": queries["q18_groupby"]["having_only_wall_s"]}, sf_q18,
        len(df), VERIFY)
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
    # the same query and upload at the default confs: the dense composite
    # key beside B2 (before agg.denseKeys came: the sorted-payload branch)
    sess.set_conf("spark.rapids.sql.agg.hashAggEnabled", False)
    sess.set_conf("spark.rapids.sql.agg.denseKeys", True)
    out, rec = run_session_cell(
        "session Q18 group-by default confs", T.q18_groupby(sess, li_q18),
        runs_new, sf_q18, len(df), 0, ("dense",))
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

    path18 = paths["lineitem"]
    del frames1
    # the session's Parquet cells and Q9 from files of their own at
    # SESSION_PARQUET_SF: lineitem, orders and customer, and part,
    # partsupp, supplier and nation beside them
    t0 = time.perf_counter()
    sfh = sf_q18 if args.quick else SESSION_PARQUET_SF
    framesh = {"lineitem": G.gen_lineitem(sfh), "orders": G.gen_orders(sfh),
               "customer": G.gen_customer(sfh),
               "supplier": G.gen_supplier(sfh), "part": G.gen_part(sfh),
               "partsupp": G.gen_partsupp(sfh), "nation": G.gen_nation()}
    pathsh = G.write_parquet(os.path.join(pq_dir, f"sf{sfh}"), sfh,
                             tables=list(framesh), frames=framesh)
    report["write_parquet_session_s"] = time.perf_counter() - t0
    log(f"parquet SF{sfh} for the session's cells: "
        f"{report['write_parquet_session_s']:.1f} s")
    session_parquet_cells({n: pathsh[n] for n in
                           ("lineitem", "orders", "customer")},
                          framesh, sfh, q1_batch, pq_runs, queries)
    report["encodings"].update(check_encodings(
        {n: pathsh[n] for n in ("part", "partsupp", "supplier", "nation")}))
    q9_out = q9_parquet_cell(pathsh, framesh, sfh, q1_batch, pq_runs,
                             queries)
    torch.cuda.empty_cache()
    # observability, on the session Q3 cell's uploads and these files
    # (at SF10 Q3 plans two shuffled joins: its three filters, customer
    # segment, order date and ship date, each with the coalesce above it,
    # fold into their join exchanges' concats: 6 nodes)
    obs_phase(q3_cell, pathsh, q9_out, framesh["lineitem"], q1_batch,
              1 if args.quick else 3, queries, report,
              claims=None if args.quick else 6)
    torch.cuda.empty_cache()
    # the exchange's routes and the shuffle manager, on the same cell and
    # the SF1 frames
    shuffle_phase(q3_cell, df, o1, c1, q1_batch, 1 if args.quick else 3,
                  queries, report)
    torch.cuda.empty_cache()
    # the adaptive slice, on the same Q3 cell, the session Q1 cell's
    # upload, the SF1 frames and the TPC-H cells' records
    adaptive_phase(q3_cell, df, o1, c1, q1_batch, queries, report)
    report["adaptive_phase_s"] += report["adaptive_fusion_s"]
    torch.cuda.empty_cache()
    # serving, on the session Q1 cell's cached uploads (Q3's tables added:
    # the Q3 cell's cache holds none of Q1's and Q6's columns, 52 s of
    # SF10 uploads), the SF 0.5 Parquet lineitem and, in the fleet, SF1
    # lineitem
    serving_phase(earlier["q1_session"],
                  {n: memory_frames[n] for n in ("orders", "customer")},
                  {"q1": earlier["q1_want"], "q6": q6_want,
                   "q3": earlier["q3_want"],
                   "q6_parquet": q6_reference(framesh["lineitem"])},
                  pathsh["lineitem"], df, report)
    q3_cell[0].clear_device_cache()
    del framesh, q3_cell
    torch.cuda.empty_cache()

    # the expression phase: rollup and cube on the session Q1 cell's
    # upload, explode, the ids, input_file_name over these Parquet files
    t0 = time.perf_counter()
    expression_phase(
        args.quick, earlier["q1_session"], earlier["q1_want"],
        memory_frames["lineitem"], df, (sf_q1, sf_q18),
        {"lineitem": ([pathsh["lineitem"], path18], "l_orderkey"),
         "customer": ([pathsh["customer"], path_cust], "c_custkey")},
        expr_child, queries, report)
    report["expression_phase_s"] = time.perf_counter() - t0
    log(f"expression phase: {report['expression_phase_s']:.1f} s")
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
        pq_runs, queries["q18_groupby_parquet"], sf_q18, len(df), rg18, 0,
        VERIFY)
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
    torch.cuda.empty_cache()

    # scan and write: sorted and partitioned writes of SF1
    # lineitem, pruned Q6 and Q1 over them, ORC and CSV, the page cache
    t0 = time.perf_counter()
    scan_write_phase(df, o1, c1, path18, q1_batch, queries, report)
    report["scan_write_phase_s"] = time.perf_counter() - t0
    log(f"scan_write phase: {report['scan_write_phase_s']:.1f} s")
    del df, o1, c1
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tpcxbb_phase(1 if args.quick else TPCXBB_SF, q1_batch, runs_new,
                 queries, report)
    report["tpcxbb_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mortgage, etl = mortgage_phase(1 if args.quick else MORTGAGE_SF,
                                   1 if args.quick else MORTGAGE_ETL_SF,
                                   1 if args.quick else MORTGAGE_RUNS,
                                   queries, report)
    report["mortgage_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    export_phase(etl, report)
    report["export_phase_s"] = time.perf_counter() - t0
    log(f"export phase: {report['export_phase_s']:.1f} s")
    etl[0].stop()
    del etl
    torch.cuda.empty_cache()
    # out-of-core off and the default budget in every phase before this
    # one: nothing may have spilled
    spilled = _memory_counters()
    require(spilled["spill_events_device_to_host"] == 0
            and spilled["spill_events_host_to_disk"] == 0,
            f"the earlier phases spilled: {spilled}")
    t0 = time.perf_counter()
    if args.quick:
        log("memory phase: skipped (--quick: nothing passes its budget)")
    else:
        memory_phase(memory_frames, mortgage, q1_batch, queries, report,
                     earlier)
    report["memory_phase_s"] = time.perf_counter() - t0
    log(f"memory phase: {report['memory_phase_s']:.1f} s")
    del memory_frames, mortgage
    torch.cuda.empty_cache()
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
