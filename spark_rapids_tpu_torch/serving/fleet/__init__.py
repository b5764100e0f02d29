"""The fleet serving tier (counterpart of the JAX package's
``serving/fleet/``): one router process spreads tenants over N worker
processes, each a whole session from a shared conf, on one card or
several.

  * ``placement.py`` sticky tenant -> replica placement: override map,
    consistent-hash ring, least-loaded spill-over;
  * ``worker.py``    the worker process: a session and an admission
    scheduler behind a JSON-lines stdin/stdout protocol;
  * ``router.py``    the front end: dispatch, deadline and shed
    propagation, rolling restarts, crash handling, ``/api/fleet``;
  * ``warmstate.py`` the shared fleet directory: the nvcc build directory
    (``obs/compilecache.py``), the warm manifest, per-replica journals.

Everything resolves lazily: importing ``spark_rapids_tpu_torch.serving.
fleet`` never loads the session, and a session with the fleet confs at
their defaults never imports this package.
"""

_EXPORTS = {
    "FleetRouter": "router",
    "FleetJob": "router",
    "FleetMonitor": "router",
    "ProcessWorker": "router",
    "LocalWorker": "router",
    "launch_process_fleet": "router",
    "snapshot_all": "router",
    "PlacementPolicy": "placement",
    "HashRing": "placement",
    "parse_overrides": "placement",
    "fleet_paths": "warmstate",
    "event_log_path": "warmstate",
    "worker_conf": "warmstate",
    "write_worker_spec": "warmstate",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    module = importlib.import_module(
        f"spark_rapids_tpu_torch.serving.fleet.{mod}")
    return getattr(module, name)


def __dir__():
    return sorted(_EXPORTS)
