"""The fleet's shared warm state: one directory (counterpart of the JAX
package's ``serving/fleet/warmstate.py``).

A fleet shares its warmth through ``spark.rapids.tpu.fleet.dir``:

  ``<dir>/compilecache/``      the nvcc build directory of every worker
                               (``spark.rapids.tpu.compile.sharedCache.dir``,
                               ``obs/compilecache.py``): the libraries,
                               built once under their flocks and loaded by
                               every worker; seeded from an earlier build
                               it makes a worker boot with no nvcc run;
  ``<dir>/warm.jsonl``         the warm manifest: each kernel wrapper's
                               first launch of a signature in any worker,
                               one flock-serialized replayable record
                               (``note_launch``), a
                               ``compile.aot.manifest`` as it stands;
  ``<dir>/events-<rid>.jsonl`` per-replica event journals;
  ``<dir>/worker-<rid>.json``  the spec a worker process boots from
                               (``"device"``: where its session runs).

A rolling restart's replacement boots with the warm manifest as its
pre-warm manifest (``serving/prewarm.py``): it loads every library and
replays the fleet's first launches before it takes traffic.

Standard library only: the router and the tests import it without the
session.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


def fleet_paths(fleet_dir: str) -> Dict[str, str]:
    return {
        "dir": fleet_dir,
        "compileCache": os.path.join(fleet_dir, "compilecache"),
        "warmManifest": os.path.join(fleet_dir, "warm.jsonl"),
    }


def event_log_path(fleet_dir: str, replica: str) -> str:
    return os.path.join(fleet_dir, f"events-{replica}.jsonl")


def worker_conf(base_conf: Optional[Dict[str, Any]], fleet_dir: str,
                replica: str, prewarm: bool = False,
                event_log: bool = True) -> Dict[str, Any]:
    """The conf one worker session boots from: the caller's settings and
    the shared-warmth wiring. ``prewarm=True`` (a rolling restart's
    replacement) also points ``compile.aot.manifest`` at the warm
    manifest, so the worker pre-warms from the fleet's history before it
    takes traffic."""
    paths = fleet_paths(fleet_dir)
    conf: Dict[str, Any] = dict(base_conf or {})
    conf.setdefault("spark.rapids.tpu.compile.sharedCache.dir",
                    paths["compileCache"])
    conf.setdefault("spark.rapids.tpu.fleet.warmManifest",
                    paths["warmManifest"])
    if prewarm:
        conf.setdefault("spark.rapids.tpu.compile.aot.manifest",
                        paths["warmManifest"])
    if event_log:
        conf.setdefault("spark.rapids.tpu.eventLog.path",
                        event_log_path(fleet_dir, replica))
    return conf


def write_worker_spec(fleet_dir: str, replica: str,
                      conf: Dict[str, Any],
                      **extras: Any) -> str:
    """Write ``<dir>/worker-<rid>.json``, the argument of ``python -m
    spark_rapids_tpu_torch.serving.fleet.worker``. Extras land at the top
    of the spec (``device="cpu"`` for a worker off the card,
    ``schedulerWorkers=2``)."""
    os.makedirs(fleet_dir, exist_ok=True)
    spec = {"replica": replica, "conf": conf}
    spec.update(extras)
    path = os.path.join(fleet_dir, f"worker-{replica}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, default=str)
    os.replace(tmp, path)  # a booting worker never reads a torn spec
    return path
