"""Tenant -> replica placement: consistent hash, overrides, spill-over
(counterpart of the JAX package's ``serving/fleet/placement.py``, with
its hash, so a tenant lands on the same replica in both packages).

Sticky placement is the point: a tenant's repeat submissions land on the
same replica, whose plan cache, exchange-reuse cache and loaded kernels
stay warm for it. Three layers, in order:

  1. **override map** (``spark.rapids.tpu.fleet.placement.overrides``,
     ``tenantA=r0,tenantB=r2``): the operator's pins;
  2. **consistent hash**: a sha1 ring with virtual nodes, so adding or
     removing a replica re-places about 1/N of the tenants;
  3. **least-loaded spill-over**: once the sticky replica's queue depth
     reaches ``fleet.spillover.queueDepth`` the job goes to the
     least-loaded eligible replica instead.

Standard library only: the router imports it without the session.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

# virtual nodes per replica: enough that a 3-replica ring spreads
# tenants near-uniformly, cheap enough to rebuild on membership change
VNODES = 64


def parse_overrides(spec: str) -> Dict[str, str]:
    """``"tenantA=r0, tenantB=r2"`` -> ``{"tenantA": "r0", ...}``.
    Malformed entries are dropped, not fatal — a typo in one pin must
    not take the router down."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, _, rid = part.partition("=")
        tenant, rid = tenant.strip(), rid.strip()
        if tenant and rid:
            out[tenant] = rid
    return out


def _hash(s: str) -> int:
    return int.from_bytes(
        hashlib.sha1(s.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over replica ids (sha1, ``VNODES`` virtual
    nodes per replica). ``lookup`` walks clockwise from the tenant's
    point to the first vnode owned by an eligible replica."""

    def __init__(self, replica_ids: Iterable[str]):
        self._points: List[Tuple[int, str]] = []
        for rid in replica_ids:
            for v in range(VNODES):
                self._points.append((_hash(f"{rid}#{v}"), rid))
        self._points.sort()
        self._keys = [p for p, _ in self._points]

    def lookup(self, tenant: str,
               eligible: Optional[Set[str]] = None) -> Optional[str]:
        if not self._points:
            return None
        i = bisect.bisect(self._keys, _hash(tenant))
        for off in range(len(self._points)):
            _, rid = self._points[(i + off) % len(self._points)]
            if eligible is None or rid in eligible:
                return rid
        return None


class PlacementPolicy:
    """The router's placement decision, one call per dispatch:
    ``place(tenant, depths)`` -> ``(replica_id, reason)`` with reason in
    ``override`` | ``sticky`` | ``spillover``. ``depths`` is the
    router-side queue depth per ELIGIBLE replica (quiesced and lost
    replicas are simply absent from it)."""

    def __init__(self, replica_ids: Iterable[str],
                 overrides: Optional[Dict[str, str]] = None,
                 spillover_depth: int = 4):
        self._replicas: List[str] = list(replica_ids)
        self.overrides = dict(overrides or {})
        self.spillover_depth = max(1, int(spillover_depth))
        self._ring = HashRing(self._replicas)

    @property
    def replicas(self) -> List[str]:
        return list(self._replicas)

    def add_replica(self, rid: str) -> None:
        if rid not in self._replicas:
            self._replicas.append(rid)
            self._ring = HashRing(self._replicas)

    def remove_replica(self, rid: str) -> None:
        if rid in self._replicas:
            self._replicas.remove(rid)
            self._ring = HashRing(self._replicas)

    def place(self, tenant: str,
              depths: Dict[str, int]) -> Optional[Tuple[str, str]]:
        """``None`` when no replica is eligible (all draining/lost) —
        the router keeps the job queued rather than inventing a target."""
        eligible = set(depths)
        if not eligible:
            return None
        pinned = self.overrides.get(tenant)
        if pinned is not None and pinned in eligible:
            return pinned, "override"
        sticky = self._ring.lookup(tenant, eligible)
        if sticky is None:
            return None
        if depths.get(sticky, 0) < self.spillover_depth:
            return sticky, "sticky"
        least = min(eligible, key=lambda r: (depths.get(r, 0), r))
        if least == sticky:
            return sticky, "sticky"  # everyone is equally backed up
        return least, "spillover"
