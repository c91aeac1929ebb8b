"""``capability/`` — serve seeds, not indices (docs/CAPABILITY.md).

The paper's core property makes the permutation a pure function of
``(spec, seed, epoch, rank)``, so the steady-state data path need not
ship a single index: the daemon issues a compact signed
:class:`EpochCapability` (spec fingerprint, epoch seed, membership
generation + cascade trail, tenant, HMAC) and the client regenerates
its stream on-device with the existing sub-ms kernels, reporting only
ack watermarks back.  Wire bytes per epoch drop from O(samples) to
O(1) per rank — the shape that serves millions of concurrent ranks.

This package is the pure core: the token format/signing
(:mod:`.token`) and the membership-trail replay shared with the
degraded fallback (:mod:`.regen`), ported from the JAX package's
``capability/``.  The canonical bytes, signatures and wire dicts are
byte-equal to the JAX package's, so a capability signed by one package
verifies in the other; the replay of a trail is bit-identical to the JAX
package's for the same spec.  On a spec with ``backend="cuda"`` each
membership of a trail is one kernel regen on the card and one readback.
It imports nothing from ``service`` beyond the spec it is handed.
"""

from .regen import membership_stream, orphan_slice, replay_trail
from .token import CapabilityError, EpochCapability, secret_bytes

__all__ = [
    "CapabilityError",
    "EpochCapability",
    "membership_stream",
    "orphan_slice",
    "replay_trail",
    "secret_bytes",
]
