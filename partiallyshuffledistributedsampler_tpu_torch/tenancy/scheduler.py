"""Weighted fair-share scheduling for epoch-index regeneration.

Start-time fair queueing (a stride scheduler): each tenant carries a
virtual time that advances by ``cost / weight`` per admitted job, and the
queue dispatches the waiter with the smallest start tag.  A tenant that
floods the queue pushes its *own* virtual time far ahead; a quiet tenant's
next job enters at the global virtual clock and therefore sorts in front
of the flood's backlog.  The starvation bound follows: a newly arriving
tenant waits for at most the jobs already *running*, never for the
aggressor's queued backlog.

The scheduler bounds concurrency two ways: a global ``concurrency`` (how
many regens may run at once across all tenants — regen is CPU/device
bound, so this is usually small) and an optional per-tenant cap set via
:meth:`set_quota` (``TenantQuota.regen_concurrency``).  A tenant at its
cap is skipped over, not blocking the queue head.

Deliberately dependency-free and lock-cheap: acquire/release are O(log n)
heap operations under one mutex; the regen itself runs outside the lock.
"""

from __future__ import annotations

import heapq
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..analysis.lockorder import new_lock

__all__ = ["FairShareScheduler"]


class FairShareScheduler:
    def __init__(self, concurrency: int = 2, default_weight: float = 1.0,
                 metrics=None):
        self.concurrency = max(1, int(concurrency))
        self.default_weight = float(default_weight)
        self._metrics = metrics  # MetricsRegistry or None
        self._lock = new_lock("tenancy.scheduler")
        self._cond = threading.Condition(self._lock)
        self._waiters: List[tuple] = []  # guarded by: self._lock — heap of (tag, seq, entry)
        self._seq = 0  # guarded by: self._lock
        self._running = 0  # guarded by: self._lock
        self._running_by_tenant: Dict[str, int] = {}  # guarded by: self._lock
        self._vt: Dict[str, float] = {}  # guarded by: self._lock — tenant -> next start tag
        self._clock = 0.0  # guarded by: self._lock — last dispatched start tag
        self._weights: Dict[str, float] = {}  # guarded by: self._lock
        self._caps: Dict[str, int] = {}  # guarded by: self._lock
        self.dispatched = 0  # guarded by: self._lock

    def set_quota(self, tenant: str, weight: Optional[float] = None,
                  concurrency: Optional[int] = None) -> None:
        with self._lock:
            if weight is not None:
                self._weights[str(tenant)] = max(1e-6, float(weight))
            if concurrency is not None:
                self._caps[str(tenant)] = max(1, int(concurrency))

    def stats(self) -> dict:
        with self._lock:
            return {
                "queued": len(self._waiters),
                "running": int(self._running),
                "dispatched": int(self.dispatched),
                "tenants": dict(self._running_by_tenant),
            }

    @contextmanager
    def slot(self, tenant: str, cost: float = 1.0, clock=None):
        """Block until this tenant holds a fair-share regen slot."""
        tenant = str(tenant)
        self._acquire(tenant, float(cost), clock)
        try:
            yield
        finally:
            self._release(tenant)

    # -- internals ---------------------------------------------------------

    def _acquire(self, tenant: str, cost: float, clock=None) -> None:
        ev = threading.Event()
        t0 = clock() if clock is not None else None
        with self._lock:
            weight = self._weights.get(tenant, self.default_weight)
            # a tenant idle since the clock moved on re-enters at the
            # current virtual time — no banked credit, no banked debt
            tag = max(self._vt.get(tenant, 0.0), self._clock)
            self._vt[tenant] = tag + max(0.0, cost) / weight
            self._seq += 1
            entry = {"tenant": tenant, "ev": ev}
            heapq.heappush(self._waiters, (tag, self._seq, entry))
            self._pump_locked()
        ev.wait()
        if t0 is not None and self._metrics is not None:
            self._metrics.histogram("regen_queue_ms").observe(
                (clock() - t0) * 1000.0)

    def _release(self, tenant: str) -> None:
        with self._lock:
            self._running -= 1
            left = self._running_by_tenant.get(tenant, 1) - 1
            if left <= 0:
                self._running_by_tenant.pop(tenant, None)
            else:
                self._running_by_tenant[tenant] = left
            self._pump_locked()

    def _pump_locked(self) -> None:
        # dispatch eligible waiters in start-tag order while slots remain;
        # tenants at their per-tenant cap are skipped, not head-blocking
        skipped = []
        while self._running < self.concurrency and self._waiters:
            tag, seq, entry = heapq.heappop(self._waiters)
            tenant = entry["tenant"]
            cap = self._caps.get(tenant)
            if cap is not None and self._running_by_tenant.get(tenant, 0) >= cap:
                skipped.append((tag, seq, entry))
                continue
            self._running += 1
            self._running_by_tenant[tenant] = (
                self._running_by_tenant.get(tenant, 0) + 1)
            self._clock = max(self._clock, tag)
            self.dispatched += 1
            entry["ev"].set()
        for item in skipped:
            heapq.heappush(self._waiters, item)
