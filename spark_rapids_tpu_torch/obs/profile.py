"""Per-query profile report (counterpart of the JAX package's
``obs/profile.py``): the executed plan tree annotated with inclusive and
exclusive time, rows and batches, plus the query's deltas of the
process-wide counters (scan, page cache, spill, shuffle fetches and the
shuffle-skew record of ``obs/shuffleobs.py``), its host syncs by site
with the occupancy estimate, and the observability truncation counters.

``session.profile_report()`` renders it, ``session.profile_json()`` is the
machine shape ``tools/trace_summary.py`` reads.

Operator time is host wall time measured around each batch pull in
``PhysicalPlan.executed_partitions``, so a parent's time includes the
children it pulls through; exclusive time subtracts the children's
inclusive time (clamped at zero). CUDA launches are asynchronous: without
``spark.rapids.sql.profile.syncEachOp`` a node's time is its dispatch, and
its device work lands on whichever later node waits for the device. Under
syncEachOp the wrapper waits after each batch, so each node's
``breakdown`` splits its exclusive time into ``device_s`` (the wait),
``transfer_s`` (host<->device copies reported by the transfer sites) and
``dispatch_s`` (the rest). A node's ``rows`` are those the host knows
without a sync (an upload's, a host frame's), and every batch's under
syncEachOp, whose wait reads them.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

_DEVICE_NOTE = ("times are host wall; device_s is the device's only under "
                "spark.rapids.sql.profile.syncEachOp (launches are "
                "asynchronous)")


def _node_profile(node, ctx, op_metrics: Dict[str, Any]) -> Dict[str, Any]:
    st = ctx.node_stats.get(id(node))
    incl = st["time"] if st else 0.0
    children = [_node_profile(c, ctx, op_metrics) for c in node.children]
    excl = max(incl - sum(c["inclusive_s"] for c in children), 0.0)
    out: Dict[str, Any] = {
        "op": node.describe(),
        "inclusive_s": round(incl, 6),
        "exclusive_s": round(excl, 6),
        "rows": st["rows"] if st else 0,
        "batches": st["batches"] if st else 0,
        "children": children,
    }
    bd = _node_breakdown(node, ctx)
    if bd is not None:
        out["breakdown"] = bd
    metrics = op_metrics.get(node.describe())
    if metrics:
        out["metrics"] = dict(metrics)
    return out


def _node_breakdown(node, ctx) -> Optional[Dict[str, float]]:
    """One operator's EXCLUSIVE time as ``device_s`` (the syncEachOp wait
    after its batches: every child waited before yielding, so the queue
    held only this operator's work), ``transfer_s`` (seconds the transfer
    sites reported against it) and ``dispatch_s`` (the rest of its pull
    time). None where nothing was recorded for the node."""
    bd = getattr(ctx, "node_breakdown", None)
    st = bd.get(id(node)) if bd else None
    if not st:
        return None
    device = st.get("sync_s", 0.0)
    transfer = st.get("transfer_s", 0.0)
    pull = st.get("pull_s")
    if pull is not None:
        # the children's pulls and waits ran inside this node's pull
        child_s = 0.0
        for c in node.children:
            cst = bd.get(id(c)) or {}
            child_s += cst.get("pull_s", 0.0) + cst.get("sync_s", 0.0)
        dispatch = max(pull - child_s - transfer, 0.0)
    else:
        dispatch = 0.0
    return {"device_s": round(device, 6),
            "transfer_s": round(transfer, 6),
            "dispatch_s": round(dispatch, 6),
            "total_s": round(device + transfer + dispatch, 6)}


def scan_decode_mode(scan: Dict[str, Any]) -> str:
    """A query's decode verdict from its scan counter delta: ``device``
    when every column of every split was decoded on the device, ``mixed``
    when any fell back to the host decode, ``host`` when no split took the
    device path."""
    def n(key: str) -> int:
        try:
            return int(scan.get(key, 0) or 0)
        except (TypeError, ValueError):
            return 0
    if not n("scan.device.splits"):
        return "host"
    if n("scan.device.fallbackColumns"):
        return "mixed"
    return "device"


def build_profile(plan, ctx, global_delta: Optional[Dict[str, Any]] = None,
                  wall_s: Optional[float] = None,
                  obs_before: Optional[tuple] = None) -> "ProfileReport":
    """The report of an executed plan and its ExecContext.
    ``global_delta`` is the query's ``registry_delta`` of the process-wide
    registry; ``obs_before`` the query-start snapshot of (tracer dropped,
    journal dropped, journal rotations, journal rotate failures, sync
    ledger seq), so truncation reports as the query's delta and the
    ``syncs`` section covers exactly its ledger entries."""
    from spark_rapids_tpu_torch.obs.events import EVENTS
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    from spark_rapids_tpu_torch.obs.syncledger import (
        SYNC_LEDGER, occupancy_pct, rollup,
    )
    from spark_rapids_tpu_torch.obs.trace import TRACER
    op_metrics = ctx.op_metrics()
    tree = _node_profile(plan, ctx, op_metrics)
    summary: Dict[str, Any] = {}
    delta = dict(global_delta or {})

    def take(prefix: str) -> Dict[str, Any]:
        got = {k: v for k, v in delta.items() if k.startswith(prefix)}
        for k in got:
            del delta[k]
        return got

    def gauges(section: Dict[str, Any], prefix: str) -> None:
        # gauges are state, not flow: absent from the delta, but the
        # pipeline's depth and the cache's bytes belong in the section
        for m in REGISTRY.metrics():
            if m.kind == "gauge" and m.name.startswith(prefix):
                section.setdefault(m.name, m.value)

    summary["spill"] = take("spill.")
    # the skew section before the generic shuffle take, so the skew
    # counters land in their own section (obs/shuffleobs.py); its ratio
    # gauges join only when this query materialized a measured shuffle
    summary["shuffleSkew"] = take("shuffle.skew.")
    summary["shuffle"] = take("shuffle.")
    summary["scan"] = take("scan.")
    summary["pageCache"] = take("pagecache.")
    # the nvcc build's counters of this query (obs/compilecache.py): the
    # warm-up the trace summary attributes
    summary["compileCache"] = take("compileCache.")
    if summary["shuffleSkew"]:
        gauges(summary["shuffleSkew"], "shuffle.skew.")
    if summary["scan"]:
        gauges(summary["scan"], "scan.prefetch.")
        summary["scan"]["scan.decode.mode"] = scan_decode_mode(
            summary["scan"])
    if summary["pageCache"]:
        gauges(summary["pageCache"], "pagecache.")
    if delta:
        summary["other"] = delta
    mem = op_metrics.get("memory")
    if mem:
        summary["memory"] = dict(mem)
    t0, e0, r0, f0, sync0 = (tuple(obs_before) + (0,) * 5)[:5] \
        if obs_before else (0, 0, 0, 0, 0)
    sync_entries = SYNC_LEDGER.entries(since_seq=sync0)
    if sync_entries:
        roll = rollup(sync_entries)
        summary["syncs"] = {
            "count": roll["count"],
            "seconds": roll["seconds"],
            "bytes": roll["bytes"],
            "occupancyPct": occupancy_pct(roll["seconds"], wall_s),
            "bySite": roll["bySite"][:8],
        }
        # per-node sync rows: entries name their operator's describe()
        by_op: Dict[str, List[float]] = {}
        for e in sync_entries:
            if e.get("op"):
                acc = by_op.setdefault(e["op"], [0, 0.0])
                acc[0] += 1
                acc[1] += float(e.get("seconds", 0.0) or 0.0)

        def annotate(node: Dict[str, Any]) -> None:
            got = by_op.get(node["op"])
            if got:
                node["syncs"] = got[0]
                node["sync_s"] = round(got[1], 6)
            for c in node["children"]:
                annotate(c)
        annotate(tree)
    obs = {}
    if TRACER.dropped - t0 > 0:
        obs["trace.droppedEvents"] = TRACER.dropped - t0
    if EVENTS.dropped - e0 > 0:
        obs["eventLog.droppedEvents"] = EVENTS.dropped - e0
    if EVENTS.rotations - r0 > 0:
        obs["eventLog.rotations"] = EVENTS.rotations - r0
    if EVENTS.rotate_failures - f0 > 0:
        obs["eventLog.rotateFailures"] = EVENTS.rotate_failures - f0
    if obs:
        summary["observability"] = obs
    return ProfileReport(tree, summary, wall_s=wall_s)


class ProfileReport:
    def __init__(self, tree: Dict[str, Any], summary: Dict[str, Any],
                 wall_s: Optional[float] = None):
        self.tree = tree
        self.summary = summary
        self.wall_s = wall_s

    # -- machine shape ------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"version": 1, "plan": self.tree,
                               "summary": self.summary}
        if self.wall_s is not None:
            doc["wall_s"] = round(self.wall_s, 6)
        return doc

    def save(self, path: str) -> None:
        import os
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    # -- human shape --------------------------------------------------------
    def render(self) -> str:
        lines: List[str] = []
        if self.wall_s is not None:
            lines.append(f"query wall: {self.wall_s:.3f}s")
        lines.append(f"({_DEVICE_NOTE})")

        def rec(node: Dict[str, Any], indent: int) -> None:
            line = ("  " * indent
                    + f"{node['op']}  "
                    + f"[incl {node['inclusive_s']:.3f}s "
                    + f"excl {node['exclusive_s']:.3f}s "
                    + f"rows {node['rows']} batches {node['batches']}]")
            bd = node.get("breakdown")
            if bd:
                line += (f" [device {bd['device_s']:.3f}s "
                         f"transfer {bd['transfer_s']:.3f}s "
                         f"dispatch {bd['dispatch_s']:.3f}s]")
            if node.get("syncs"):
                line += (f" [syncs {node['syncs']} "
                         f"{node.get('sync_s', 0.0):.3f}s]")
            lines.append(line)
            for c in node["children"]:
                rec(c, indent + 1)
        rec(self.tree, 0)
        for section, vals in self.summary.items():
            if not vals:
                continue
            lines.append(f"-- {section}")
            for k, v in sorted(vals.items()):
                if isinstance(v, list):
                    lines.append(f"   {k}:")
                    for item in v:
                        if isinstance(item, dict):
                            body = " ".join(f"{ik}={iv}" for ik, iv
                                            in item.items())
                            lines.append(f"     - {body}")
                        else:
                            lines.append(f"     - {item}")
                    continue
                if isinstance(v, float):
                    v = round(v, 6)
                lines.append(f"   {k}: {v}")
        return "\n".join(lines)
