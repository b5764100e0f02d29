"""Summarize an observability artifact of the port: top exclusive-time
spans and event counts (the port's copy of the repository's
``tools/trace_summary.py``, reading through the port's ``obs/events``).

Reads any artifact ``spark_rapids_tpu_torch/obs`` emits:

  * a Chrome trace JSON (``spark.rapids.tpu.trace.path``): per-span
    exclusive time (duration minus directly nested child spans on the same
    thread) by span name, the sync track's ``sync.<site>`` spans
    (``obs/syncledger.py``) ranked as the device's idle gaps, and the
    instant events;
  * a per-query profile JSON (``session.profile_json()``): the plan tree's
    exclusive operator time and the summary sections, with the occupancy
    line of the ``syncs`` section;
  * a JSONL event log (``spark.rapids.tpu.eventLog.path``,
    ``obs/events.py``; rotations and gzip segments included): per-kind
    event counts and a line per query (status, wall, coverage).

Usage:
    python -m spark_rapids_tpu_torch.tools.trace_summary FILE [-n TOP_N]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _exclusive_times(events: List[Dict[str, Any]]) -> Dict[str, List[float]]:
    """name -> list of exclusive durations (seconds), from "X" events.
    Spans nest per thread; a sweep with a stack attributes each span's
    child time to its innermost enclosing span."""
    out: Dict[str, List[float]] = {}
    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            by_tid.setdefault(ev.get("tid"), []).append(ev)
    for evs in by_tid.values():
        # children start at or after the parent and end no later; sorting
        # by (start, -dur) yields parents before their children
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []  # open spans, with child_us accum
        for ev in evs:
            end = ev["ts"] + ev["dur"]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ev["ts"]:
                done = stack.pop()
                out.setdefault(done["name"], []).append(
                    max(done["dur"] - done.get("_child_us", 0.0), 0.0) / 1e6)
            if stack:
                stack[-1]["_child_us"] = (stack[-1].get("_child_us", 0.0)
                                          + ev["dur"])
            stack.append(dict(ev, _end=end))
        while stack:
            done = stack.pop()
            out.setdefault(done["name"], []).append(
                max(done["dur"] - done.get("_child_us", 0.0), 0.0) / 1e6)
    return out


def _summarize_trace(doc: Dict[str, Any], top_n: int) -> None:
    events = doc.get("traceEvents", [])
    excl = _exclusive_times(events)
    rows = sorted(((sum(v), len(v), name) for name, v in excl.items()),
                  reverse=True)
    print(f"{'exclusive_s':>12}  {'count':>6}  span")
    for total, count, name in rows[:top_n]:
        print(f"{total:12.4f}  {count:6d}  {name}")
    # the sync track (obs/syncledger.py): every ``sync.<site>`` span is
    # a host-blocking device round-trip - an idle gap on the device
    # timeline. Rank the individual longest gaps and name the site so
    # "where did the device sit idle" reads straight off the summary.
    gaps = [ev for ev in events
            if ev.get("ph") == "X" and "dur" in ev
            and str(ev.get("name", "")).startswith("sync.")]
    if gaps:
        total_s = sum(ev["dur"] for ev in gaps) / 1e6
        print(f"-- idle gaps (host syncs): {len(gaps)} gaps, "
              f"{total_s:.4f}s device-idle")
        print(f"{'gap_s':>10}  site")
        for ev in sorted(gaps, key=lambda e: -e["dur"])[:top_n]:
            site = str(ev["name"])[len("sync."):]
            args_ = ev.get("args") or {}
            extra = ""
            if args_.get("bytes"):
                extra = f" ({int(args_['bytes'])}B)"
            print(f"{ev['dur'] / 1e6:10.4f}  {site}{extra}")
    instants: Dict[str, int] = {}
    for ev in events:
        if ev.get("ph") == "i":
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
    if instants:
        print("-- events")
        for name, n in sorted(instants.items()):
            print(f"  {name}: {n}")
    dropped = doc.get("otherData", {}).get("droppedEvents")
    if dropped:
        print(f"-- WARNING: {dropped} events dropped (tracer cap)")


def _walk_profile(node: Dict[str, Any],
                  acc: List[Dict[str, Any]]) -> None:
    acc.append(node)
    for c in node.get("children", []):
        _walk_profile(c, acc)


def _summarize_profile(doc: Dict[str, Any], top_n: int) -> None:
    nodes: List[Dict[str, Any]] = []
    _walk_profile(doc["plan"], nodes)
    nodes.sort(key=lambda n: n.get("exclusive_s", 0.0), reverse=True)
    if "wall_s" in doc:
        print(f"query wall: {doc['wall_s']:.3f}s")
    print(f"{'exclusive_s':>12}  {'rows':>10}  {'batches':>7}  operator")
    for n in nodes[:top_n]:
        print(f"{n.get('exclusive_s', 0.0):12.4f}  "
              f"{n.get('rows', 0):10d}  {n.get('batches', 0):7d}  "
              f"{n['op']}")
    for section, vals in doc.get("summary", {}).items():
        if not vals:
            continue
        print(f"-- {section}")
        for k, v in sorted(vals.items()):
            print(f"  {k}: {v}")
    cc = doc.get("summary", {}).get("compileCache") or {}
    if cc:
        # warmup attribution at a glance: compile time that ran vs
        # compile time the persistent cache avoided (the port's: nvcc
        # runs and libraries found built, obs/compilecache.py)
        ran = cc.get("compileCache.backendCompileTime", 0.0)
        n = cc.get("compileCache.backendCompiles", 0)
        hits = cc.get("compileCache.persistentHits", 0)
        saved = cc.get("compileCache.timeSaved", 0.0)
        print(f"-- warmup attribution: {ran:.1f}s backend compile "
              f"({n} compiles), {hits} persistent-cache hits "
              f"({saved:.1f}s saved)")
    sy = doc.get("summary", {}).get("syncs") or {}
    if sy:
        # device-occupancy at a glance: wall share NOT blocked on host
        # round-trips, with the dominant sync site named
        # (obs/syncledger.py)
        occ = sy.get("occupancyPct")
        top_site = (sy.get("bySite") or [{}])[0]
        print(f"-- occupancy: "
              + (f"{occ:.1f}% device-busy estimate, "
                 if occ is not None else "")
              + f"{sy.get('count', 0)} host syncs "
              f"{sy.get('seconds', 0.0):.4f}s blocked"
              + (f" (top site {top_site.get('site')} "
                 f"{top_site.get('seconds', 0.0):.4f}s)"
                 if top_site.get("site") else ""))


def _summarize_event_log(path: str, top_n: int) -> None:
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from spark_rapids_tpu_torch.obs.events import read_events
    events = read_events(path)
    kinds: Dict[str, int] = {}
    for ev in events:
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    print(f"event log: {len(events)} events")
    print(f"{'count':>7}  kind")
    for kind, n in sorted(kinds.items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"{n:7d}  {kind}")
    ends = [ev for ev in events if ev["kind"] == "queryEnd"]
    if ends:
        print("-- queries")
        for ev in ends:
            wall = ev.get("wall_s")
            cov = ev.get("coveragePct")
            print(f"   {ev.get('query', '?')}: {ev.get('status')}"
                  + (f" wall={wall:.3f}s" if wall is not None else "")
                  + (f" coverage={cov:.0f}%" if cov is not None else "")
                  + (f" error={ev.get('error')}"[:120]
                     if ev.get("error") else ""))
        print("(full report: python tools/qualification.py "
              f"{path})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Top exclusive-time spans and event counts of a trace "
                    "JSON, profile JSON, or JSONL event log")
    ap.add_argument("file", help="Chrome trace JSON, profile JSON, or "
                                 "event-log JSONL")
    ap.add_argument("-n", "--top", type=int, default=15,
                    help="rows to print (default 15)")
    args = ap.parse_args(argv)
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    # gzip-transparent open (eventLog.compress rotations and hand-gzipped
    # archives summarize like plaintext)
    from spark_rapids_tpu_torch.obs.events import open_event_file
    with open_event_file(args.file) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError:
            doc = None  # not one JSON document: try JSONL event log
    if doc is None or (isinstance(doc, dict) and "kind" in doc):
        # a single-event file is still a (one-line) event log
        _summarize_event_log(args.file, args.top)
    elif "traceEvents" in doc:
        _summarize_trace(doc, args.top)
    elif "plan" in doc:
        _summarize_profile(doc, args.top)
    else:
        print("unrecognized artifact: expected 'traceEvents' (Chrome "
              "trace), 'plan' (profile JSON), or JSONL event lines",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `| head` closed the pipe: not an error
        sys.exit(0)
