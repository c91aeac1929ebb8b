"""Multi-tenant namespaces for the index-serving daemon.

A copy of the JAX package's ``tenancy/`` (pure standard library): the
same tenants, quotas and fair-share dispatch order in both packages.

PRs 1-5 built a one-job-one-port daemon: each :class:`IndexServer` owns a
single :class:`PartialShuffleSpec` and HELLO hard-rejects any client whose
fingerprint differs.  This package turns that into a shared service
(docs/SERVICE.md "Tenancy"): namespaces are keyed by the world-stripped
spec fingerprint (``PartialShuffleSpec.fingerprint(include_world=False)``),
a HELLO carrying an unknown fingerprint creates or attaches to a tenant,
and every piece of per-job state — leases, epoch/ack watermarks, reshard
barriers, snapshot files, replication WAL records, metrics, trace streams —
lives per tenant.

Two mechanisms keep tenants from hurting each other:

* :class:`FairShareScheduler` — a weighted start-time fair queue that all
  epoch-index regeneration runs through, so one tenant's 1B-sample regen
  cannot starve another's heartbeats or GET_BATCHes.
* :class:`TenantQuota` admission control — per-tenant caps (max ranks,
  max inflight, regen concurrency) enforced at HELLO with the existing
  typed ``retry_ms`` backpressure, plus a server-wide ``max_tenants`` cap
  (the ``tenant.admission`` fault site covers this path in the chaos
  matrix).
"""

from .registry import TenantQuota, tenant_id_for  # noqa: F401
from .scheduler import FairShareScheduler  # noqa: F401
