"""Shared index-serving service: one sampler daemon, many loader clients.

A copy of the JAX package's ``service/`` (docs/SERVICE.md):
:class:`IndexServer` owns one :class:`PartialShuffleSpec` (plain, mixture,
shard-mode, a ``StreamSpec`` or a ``SamplingSpec``), generates each
``(epoch, rank)`` once through the spec's backend — on ``"cuda"`` one
launch of the hand-written kernels and one readback — and streams
disjoint per-rank index ranges to N :class:`ServiceIndexClient` s over
loopback TCP, with backpressure, rank leases, reconnect/resume,
snapshots, metrics, elastic membership (docs/RESILIENCE.md "Elastic
membership"), hot-standby replication with fencing (docs/RESILIENCE.md
"Replication & failover"), multi-tenancy (docs/SERVICE.md "Tenancy") and
signed epoch capabilities (docs/CAPABILITY.md).  Frames, snapshots, WAL
segments and grants are byte-equal to the JAX package's for the same
inputs: a client of either package streams from a server of either, and
each package's recovery reads the other's WAL.  The backend stays
outside the wire form.
"""

from ..tenancy import FairShareScheduler, TenantQuota  # noqa: F401
from .client import (  # noqa: F401
    FencedError,
    ReshardInProgress,
    ServiceError,
    ServiceIndexClient,
    ServiceUnavailable,
    SpecMismatchError,
)
from .metrics import ServiceMetrics  # noqa: F401
from .protocol import PROTOCOL_VERSION, ProtocolError  # noqa: F401
from .server import IndexServer  # noqa: F401
from .spec import PartialShuffleSpec  # noqa: F401
