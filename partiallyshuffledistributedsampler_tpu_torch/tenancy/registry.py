"""Tenant identity and admission quotas.

A tenant *is* a world-stripped spec fingerprint: two jobs that shuffle the
same dataset with the same window/seed/mode share one namespace regardless
of how many ranks each runs, while any parameter difference (seed, window,
mixture weights, shard table) yields a distinct tenant.  The fingerprint is
a sorted-JSON string — long and unfriendly as a wire/file token — so the
public tenant id is a short stable digest of it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

__all__ = ["TenantQuota", "tenant_id_for"]


def tenant_id_for(fingerprint: str) -> str:
    """Short, filename- and JSON-safe tenant id for a spec fingerprint."""
    digest = hashlib.sha1(fingerprint.encode("utf-8")).hexdigest()
    return "t" + digest[:10]


@dataclass(frozen=True)
class TenantQuota:
    """Admission-control caps applied to one tenant.

    ``None`` means uncapped.  ``max_ranks`` bounds concurrently leased
    ranks (a HELLO past the cap gets a retryable ``tenant_admission``
    error — a lease may free); ``max_inflight`` clamps the server-side
    un-acked batch window below the daemon default; ``regen_concurrency``
    caps how many of this tenant's epoch regens may occupy fair-share
    slots at once; ``weight`` scales the tenant's share of the regen
    queue (2.0 drains twice as fast as 1.0 under contention).
    """

    max_ranks: Optional[int] = None
    max_inflight: Optional[int] = None
    regen_concurrency: Optional[int] = None
    weight: float = 1.0

    def clamp_inflight(self, server_max: int) -> int:
        if self.max_inflight is None:
            return int(server_max)
        return max(1, min(int(server_max), int(self.max_inflight)))
