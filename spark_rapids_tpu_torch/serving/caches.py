"""Cross-query serving caches: plan cache, result cache, exchange reuse
(counterpart of the JAX package's ``serving/caches.py``).

All three key on the same identity triple

    (plan identity, conf fingerprint, source data versions)

where the *plan identity* (``plan_identity``) hashes every semantic
attribute of every node of the CPU physical plan (literals included), the
*conf fingerprint* is the explicit-settings hash every query already
journals, and the *source versions* pin the data behind every scan. A
file versions by ``sql/parquet_raw.file_stamp`` (mtime in ns, size,
inode), as the port's footer and page caches do: the JAX package keys a
file by ``os.path.getmtime`` alone, so an overwrite of equal length that
keeps the old mtime hits there and misses here (ROADMAP C). An in-memory
source versions by ``DataSource.data_uid()`` (a process-unique counter).

  * **PlanCache** (``spark.rapids.tpu.serving.planCache.enabled``, on by
    default): a repeat submission skips the tag and convert rewrite
    (TpuOverrides, TransitionOverrides, the fused count distinct, subtree
    reuse) and runs a **clone** of the cached tree, node for node with
    DAG sharing kept, so two concurrent queries never run the same plan
    objects. The port keeps a run's state in its ``ExecContext`` keyed by
    ``id(node)`` (shared subtrees, the broadcast table, node stats); the
    one node that keeps it on itself, ``CpuBroadcastExchangeExec._cache``,
    gets a fresh dict per clone. Clones have the master's structure, so a
    hit keeps the capacity speculation's keys (``plan_fingerprint``).
  * **ResultCache** (``...resultCache.enabled``, opt-in): an identical
    query answers from the cached host frames with no execution (no
    launch, no sync). Only deterministic plans that write nothing are
    cached; hits return copies.
  * **ExchangeReuseCache** (``...exchangeReuse.enabled``, opt-in): an
    adaptive query whose exchange subtree matches an already
    materialized ``ShuffleStage`` adopts its map output
    (``sql/adaptive/executor.py``). Stages are reference-counted: an
    eviction never frees frames a running query still reads.

Hits and misses land in the process registry as ``plancache.*``,
``resultcache.*`` and ``exchangereuse.*`` by tenant.
"""

from __future__ import annotations

import copy
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

PLAN_CACHE_ENABLED = "spark.rapids.tpu.serving.planCache.enabled"
PLAN_CACHE_MAX = "spark.rapids.tpu.serving.planCache.maxEntries"
RESULT_CACHE_ENABLED = "spark.rapids.tpu.serving.resultCache.enabled"
RESULT_CACHE_MAX = "spark.rapids.tpu.serving.resultCache.maxEntries"
RESULT_CACHE_MAX_BYTES = "spark.rapids.tpu.serving.resultCache.maxBytes"
EXCHANGE_REUSE_ENABLED = "spark.rapids.tpu.serving.exchangeReuse.enabled"
EXCHANGE_REUSE_MAX_BYTES = \
    "spark.rapids.tpu.serving.exchangeReuse.maxBytes"


# ---------------------------------------------------------------------------
# Source data versions
# ---------------------------------------------------------------------------

def source_version(source) -> Tuple:
    """Identity of the data behind one scan source: per file its
    ``file_stamp`` (a rewritten table misses every cache keyed over it);
    an in-memory source its ``data_uid``."""
    from spark_rapids_tpu_torch.sql.parquet_raw import file_stamp
    base = getattr(source, "_base", source)
    paths = getattr(base, "paths", None)
    if paths:
        return tuple((str(p), file_stamp(str(p))) for p in paths)
    try:
        return (source.data_uid(),)
    except Exception:  # noqa: BLE001 — unversionable: never cacheable
        return (object(),)  # unequal to everything


def source_versions(logical) -> Tuple:
    """Versions of every scanned source of a logical plan, in walk order
    (two scans of different tables must not commute)."""
    out: List[Tuple] = []
    for node in logical.walk():
        src = getattr(node, "source", None)
        if src is not None:
            out.append(source_version(src))
    return tuple(out)


# ---------------------------------------------------------------------------
# Plan identity
# ---------------------------------------------------------------------------
#
# The journal's ``plan_digest`` (describe() of every node) is a shape key:
# it collapses queries that differ only in literals. A cache key must be
# exact, so the serving caches hash every attribute of every node,
# recursing through the engine's own value objects (expressions, sort
# orders, aggregate plans, schemas), where the literals live.

_IDENT_MAX_DEPTH = 64
_ENGINE = "spark_rapids_tpu_torch"


def _value_identity(v, depth: int = 0) -> str:
    """Deterministic identity string of one attribute value: scalars and
    the engine's value objects in full, foreign objects (frames, tensors)
    by class only (their data is the source versions' part)."""
    if depth > _IDENT_MAX_DEPTH:
        return "<deep>"
    if v is None or isinstance(v, (str, int, float, bool, bytes)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_value_identity(x, depth + 1)
                              for x in v) + "]"
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_value_identity(x, depth + 1)
                                     for x in v)) + "}"
    if isinstance(v, dict):
        items = sorted(
            (repr(k), _value_identity(x, depth + 1))
            for k, x in v.items()
            if isinstance(k, (str, int, float, bool, bytes)) or k is None)
        return "{" + ",".join(f"{k}:{x}" for k, x in items) + "}"
    from spark_rapids_tpu_torch.columnar.dtype import DType
    if isinstance(v, DType):
        return f"dtype:{v.name}"
    from spark_rapids_tpu_torch.exec.base import PhysicalPlan
    from spark_rapids_tpu_torch.sql.sources import DataSource
    if isinstance(v, DataSource):
        # structure only: the data is pinned by source_version
        return f"source:{v.describe()}"
    if isinstance(v, PhysicalPlan):
        return f"plan:{type(v).__name__}"  # children are walked
    mod = type(v).__module__ or ""
    if mod.startswith(_ENGINE) and hasattr(v, "__dict__"):
        parts = [f"{k}={_value_identity(a, depth + 1)}"
                 for k, a in sorted(vars(v).items())]
        return f"{type(v).__name__}({','.join(parts)})"
    return f"<{type(v).__name__}>"


def node_identity(node) -> str:
    """Identity of ONE plan node: class, describe(), fingerprint and every
    public attribute (expressions with their literals). Children are
    appended by the tree walkers."""
    parts = [type(node).__name__, node.describe(),
             node.fingerprint_extra()]
    for k, v in sorted(vars(node).items()):
        # underscore attributes are node-private state, not semantics
        if k == "children" or k.startswith("_"):
            continue
        parts.append(f"{k}={_value_identity(v)}")
    return "|".join(parts)


def plan_identity(plan) -> str:
    """Exact structural hash of a physical plan tree, the plan part of the
    serving caches' key: plans differing in any literal differ here."""
    parts: List[str] = []

    def rec(n) -> None:
        parts.append(node_identity(n))
        parts.append("(")
        for c in n.children:
            rec(c)
        parts.append(")")
    rec(plan)
    return hashlib.sha1(
        "\n".join(parts).encode("utf-8", "replace")).hexdigest()


def clone_plan(plan):
    """Node-for-node copy of a physical plan with DAG sharing kept (a
    shared subtree is cloned once, so the in-query reuse stays). A node's
    ``_cache`` dict (``CpuBroadcastExchangeExec``'s collected frame) is
    fresh per clone: shared, one query's broadcast would serve another's
    run."""
    memo: Dict[int, Any] = {}

    def rec(node):
        got = memo.get(id(node))
        if got is not None:
            return got
        c = copy.copy(node)
        memo[id(node)] = c
        if "_cache" in vars(c):
            c._cache = {}
        c.children = [rec(ch) for ch in node.children]
        return c
    return rec(plan)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _count(name: str, tenant: Optional[str]) -> None:
    from spark_rapids_tpu_torch.obs.metrics import REGISTRY
    REGISTRY.counter(name, tenant=tenant or "default").add(1)


class PlanCache:
    """LRU of converted physical plans keyed by the identity triple."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    def get(self, key, conf, tenant: Optional[str] = None):
        if not conf.get_bool(PLAN_CACHE_ENABLED, True):
            return None
        with self._lock:
            plan = self._entries.get(key)
            if plan is not None:
                self._entries.move_to_end(key)
        if plan is None:
            _count("plancache.misses", tenant)
            return None
        _count("plancache.hits", tenant)
        return clone_plan(plan)

    def put(self, key, plan, conf) -> None:
        if not conf.get_bool(PLAN_CACHE_ENABLED, True):
            return
        cap = max(1, conf.get_int(PLAN_CACHE_MAX, 256))
        with self._lock:
            self._entries[key] = plan
            self._entries.move_to_end(key)
            while len(self._entries) > cap:
                self._entries.popitem(last=False)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


class ResultCache:
    """Opt-in LRU of (plan, output frames), bounded in bytes (pandas
    ``memory_usage(deep=True)``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (plan, outs, n)
        self._bytes = 0

    @staticmethod
    def _outs_bytes(outs) -> int:
        total = 0
        for df in outs:
            try:
                total += int(df.memory_usage(deep=True).sum())
            except (TypeError, ValueError, AttributeError):
                return -1
        return total

    @staticmethod
    def cacheable(cpu_plan) -> bool:
        """Deterministic plans that write nothing: a write commits files
        (a replay would skip it), and a rand() must run again."""
        if any(n.name in ("CpuWriteExec", "TpuWriteExec")
               for n in cpu_plan.walk()):
            return False
        from spark_rapids_tpu_torch.exec.reuse import subtree_deterministic
        return subtree_deterministic(cpu_plan)

    def get(self, key, conf, tenant: Optional[str] = None):
        if not conf.get_bool(RESULT_CACHE_ENABLED, False):
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
        if ent is None:
            _count("resultcache.misses", tenant)
            return None
        _count("resultcache.hits", tenant)
        plan, outs, _nbytes = ent
        return plan, [df.copy() for df in outs]

    def maybe_put(self, key, cpu_plan, plan, outs, conf,
                  tenant: Optional[str] = None) -> bool:
        if not conf.get_bool(RESULT_CACHE_ENABLED, False) \
                or not self.cacheable(cpu_plan):
            return False
        nbytes = self._outs_bytes(outs)
        max_bytes = int(conf.get(RESULT_CACHE_MAX_BYTES, 256 << 20))
        if nbytes < 0 or nbytes > max_bytes:
            return False
        cap = max(1, conf.get_int(RESULT_CACHE_MAX, 64))
        # copies in: the caller may change the frames it got back
        outs = [df.copy() for df in outs]
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
            self._entries[key] = (plan, outs, nbytes)
            self._bytes += nbytes
            while self._entries and (len(self._entries) > cap
                                     or self._bytes > max_bytes):
                _k, (_p, _o, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
        return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class ExchangeReuseCache:
    """Opt-in registry of materialized AQE shuffle stages
    (``sql/adaptive/stages.ShuffleStage``) keyed by the exchange
    subtree's digest, conf fingerprint and source versions. The cache
    holds one reference of a stage and every adopting query another."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> ShuffleStage
        self._bytes = 0

    def get(self, key, tenant: Optional[str] = None):
        with self._lock:
            stage = self._entries.get(key)
            if stage is not None:
                self._entries.move_to_end(key)
                stage.retain()  # the adopting query's reference
        _count("exchangereuse.hits" if stage is not None
               else "exchangereuse.misses", tenant)
        return stage

    def put(self, key, stage, max_bytes: int) -> bool:
        """Offer a freshly materialized stage; whether the cache took a
        reference (the caller releases its own either way)."""
        if stage.map_outputs is None or stage.total_bytes > max_bytes:
            return False
        evicted = []
        with self._lock:
            if key in self._entries:
                return False  # an equivalent stage is already cached
            stage.retain()
            self._entries[key] = stage
            self._bytes += stage.total_bytes
            while self._entries and self._bytes > max_bytes:
                _k, old = self._entries.popitem(last=False)
                self._bytes -= old.total_bytes
                evicted.append(old)
        for old in evicted:
            old.release()
        return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}

    def clear(self) -> None:
        with self._lock:
            entries, self._entries = list(self._entries.values()), \
                OrderedDict()
            self._bytes = 0
        for st in entries:
            st.release()


class ServingCaches:
    """The session's serving-cache bundle (``session._serving()``)."""

    def __init__(self):
        self.plan_cache = PlanCache()
        self.result_cache = ResultCache()
        self.exchange_cache = ExchangeReuseCache()

    def key_for(self, cpu_plan, conf, logical) -> Tuple:
        from spark_rapids_tpu_torch.obs.events import conf_fingerprint
        return (plan_identity(cpu_plan),
                conf_fingerprint(conf._settings),
                source_versions(logical))

    def clear(self) -> None:
        self.plan_cache.clear()
        self.result_cache.clear()
        self.exchange_cache.clear()


# ---------------------------------------------------------------------------
# Exchange subtree digests (adaptive executor)
# ---------------------------------------------------------------------------

def exchange_reuse_key(exchange, conf) -> Tuple:
    """Cross-query identity of one exchange subtree about to materialize.
    A ``ShuffleStageRef`` leaf stands for its stage's own reuse key (stage
    2 over a reused stage 1 digests alike in both queries); a stage
    without one contributes its process-unique uid, so the key never
    matches across queries."""
    from spark_rapids_tpu_torch.obs.events import conf_fingerprint
    from spark_rapids_tpu_torch.sql.adaptive.stages import ShuffleStageRef
    parts: List[str] = []

    def rec(n) -> None:
        if isinstance(n, ShuffleStageRef):
            rk = getattr(n.stage, "reuse_key", None)
            parts.append("stageref:"
                         + (str(rk) if rk is not None
                            else "vol%d" % n.stage.uid))
            return
        parts.append(node_identity(n))
        src = getattr(n, "source", None)
        if src is not None:
            parts.append(repr(source_version(src)))
        parts.append("(")
        for c in n.children:
            rec(c)
        parts.append(")")
    rec(exchange)
    digest = hashlib.sha1("|".join(parts).encode("utf-8",
                                                 "replace")).hexdigest()
    return (digest[:16], conf_fingerprint(conf._settings))
