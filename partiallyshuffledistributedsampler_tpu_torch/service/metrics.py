"""Service observability: per-client counters over the shared registry.

The daemon's numbers ride the same :class:`~..utils.metrics.MetricsRegistry`
surface the rest of the framework exports through, so ``bench.py``, the
``make service-smoke`` gate and an operator ``METRICS`` poll all read one
report produced one way.  Counter vocabulary (the service metric set):

* ``batches_served``   — BATCH replies carrying indices
* ``resends``          — BATCH replies for a seq already served to that
                         rank (a reconnected client replaying its cursor)
* ``reconnects``       — HELLOs re-claiming a rank this server already
                         served (client came back after a drop)
* ``heartbeat_gaps``   — gaps between a client's messages that exceeded
                         the lease timeout but the client returned
* ``evictions``        — rank leases revoked for missed heartbeats
* ``throttled``        — GET_BATCHs refused by backpressure
* ``epoch_regen_ms``   — timer: per-(epoch, rank) index generation

Elastic membership (docs/RESILIENCE.md "Elastic membership"):

* ``leaves``           — LEAVE requests accepted (preemption drains)
* ``reshard_triggers`` — barriers frozen (LEAVE, RESHARD RPC, eviction)
* ``reshards``         — barriers committed (generation bumps)
* ``orphaned``         — samples converted to orphan descriptors at a
                         commit (dead ranks' un-drained allocations)

Client-side additions with the same vocabulary: ``reshards_ridden``
(memberships adopted mid-stream), ``reshard_waits`` (requests paused on
a draining barrier), ``membership_lost`` (rejoin found no free rank).

Per-client copies of the counters live under ``clients[rank]``; the
registry holds the totals.  Per-client entries are pruned when the rank
departs for good — lease eviction or a reshard commit that removes the
rank — and their totals are folded into one aggregate ``departed``
entry, so a long-lived daemon's report does not grow with every rank
that ever connected (docs/OBSERVABILITY.md).  The epoch regen timer is
the same :class:`RegenTimer` every sampler uses, so "epoch regen ms"
means the same thing here as in a local training loop.

Multi-tenant daemons (docs/SERVICE.md "Tenancy") key per-client counters
by ``(tenant, client)``: :meth:`scoped` derives one child view per tenant
with a private registry and a private ``clients``/``departed`` table, so
one tenant's churn can't pollute another's counters and a tenant METRICS
poll sees only its own numbers.  Child totals are mirrored into the
parent registry (the operator's daemon-wide view) and child reports are
rolled up under ``report()["tenants"][tenant_id]``.
"""

from __future__ import annotations

import threading

from ..utils.metrics import MetricsRegistry
from ..analysis.lockorder import new_lock

#: counter names with a per-client breakdown
_PER_CLIENT = (
    "batches_served", "resends", "reconnects", "heartbeat_gaps", "evictions",
    "throttled", "leaves",
)


class ServiceMetrics:
    """Counters for one daemon (or one client, with the same vocabulary).

    ``registry`` defaults to a private :class:`MetricsRegistry`; pass a
    shared one to fold several daemons into one report."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = new_lock("service.metrics")
        self.clients: dict[int, dict[str, int]] = {}  # guarded by: self._lock
        self.departed: dict[str, int] = {}  # guarded by: self._lock
        self.tenant: str | None = None
        self._parent: ServiceMetrics | None = None
        self._tenants: dict[str, ServiceMetrics] = {}  # guarded by: self._lock

    def scoped(self, tenant: str) -> "ServiceMetrics":
        """Per-tenant child view: private registry, private ``clients``
        table (so per-client counters are effectively keyed by
        ``(tenant, client)``), totals mirrored into this parent."""
        tenant = str(tenant)
        with self._lock:
            child = self._tenants.get(tenant)
            if child is None:
                child = ServiceMetrics()
                child.tenant = tenant
                child._parent = self
                self._tenants[tenant] = child
            return child

    def inc(self, name: str, rank: int | None = None, value: int = 1) -> None:
        self.registry.inc(name, value)
        if self._parent is not None:
            # mirror tenant totals into the daemon-wide operator view
            self._parent.registry.inc(name, value)
        if rank is not None and name in _PER_CLIENT:
            with self._lock:
                per = self.clients.setdefault(
                    int(rank), {k: 0 for k in _PER_CLIENT}
                )
                per[name] += value

    def drop_client(self, rank: int) -> bool:
        """Prune rank's per-client entry, folding its counts into the
        aggregate ``departed`` entry.  Called at lease eviction and at a
        reshard commit that removes the rank; a later reconnect under the
        same rank number starts a fresh entry.  Returns True if an entry
        was dropped."""
        with self._lock:
            per = self.clients.pop(int(rank), None)
            if per is None:
                return False
            self.departed["clients"] = self.departed.get("clients", 0) + 1
            for name, v in per.items():
                if v:
                    self.departed[name] = self.departed.get(name, 0) + v
            return True

    @property
    def regen_timer(self):
        return self.registry.timer("epoch_regen_ms")

    def report(self) -> dict:
        out = self.registry.report()
        with self._lock:
            out["clients"] = {
                str(r): dict(c) for r, c in sorted(self.clients.items())
            }
            if self.departed:
                out["departed"] = dict(self.departed)
            if self.tenant is not None:
                out["tenant"] = self.tenant
            tenants = dict(self._tenants)
        if tenants:
            out["tenants"] = {t: m.report() for t, m in sorted(tenants.items())}
        return out
