"""Adaptive query execution (AQE; counterpart of the JAX package's
``sql/adaptive``): stage-based runtime re-planning from shuffle
statistics.

  * ``stats``    — map-output statistics + canonical hash splitting
  * ``stages``   — query stages, stage refs and the stage readers
  * ``rules``    — coalesce / broadcast-demotion / skew-split planning
  * ``executor`` — the stage-at-a-time executor (the session dispatches
                   here under spark.rapids.sql.adaptive.enabled)

Import submodules explicitly; this package init stays import-light so
exec-layer call sites can reach ``stats`` without pulling the rewrite
engine (sql/overrides.py) into their import cycle.
"""
