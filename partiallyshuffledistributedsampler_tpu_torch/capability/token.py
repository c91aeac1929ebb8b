"""The signed epoch capability: the O(1)-per-rank serve artifact.

An :class:`EpochCapability` is everything a client needs to regenerate
its epoch stream on-device without another byte from the daemon
(docs/CAPABILITY.md): the world-stripped spec fingerprint (proof both
sides evaluate the same stream), the epoch and its seed, the membership
generation plus the full §6 cascade ``layers`` trail, the orphan
descriptors rank 0 must prepend, the tenant the grant is scoped to, and
an HMAC-SHA256 signature over the canonical encoding keyed by a
per-deployment secret.  The signature makes the grant *unforgeable* and
*tamper-evident* — a client cannot widen its grant to another tenant's
fingerprint or a revoked generation — while staying a pure-stdlib
construct (``hmac`` + ``hashlib``; no new dependencies).

Revocation is by generation: a reshard bumps the server's generation,
so every outstanding capability fails the client-side generation check
and the server answers re-issue requests for the stale generation with
the typed retryable ``capability_stale`` error carrying a fresh
capability (service/protocol.py "Capability frames").
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
from typing import Optional


class CapabilityError(RuntimeError):
    """A capability failed verification (bad signature, wrong
    fingerprint/tenant/epoch, or revoked generation) or could not be
    obtained (server has no signing secret).  The loader's fallback
    ladder treats this as "use the served-batch path for this epoch"
    (docs/CAPABILITY.md "Fallback ladder")."""


def secret_bytes(secret) -> bytes:
    """Normalise a deployment secret (str or bytes) to key bytes."""
    if isinstance(secret, bytes):
        return secret
    if isinstance(secret, str):
        return secret.encode("utf-8")
    raise TypeError(
        f"capability secret must be str or bytes, got "
        f"{type(secret).__name__}")


@dataclasses.dataclass(frozen=True)
class EpochCapability:
    """One rank-agnostic, epoch-scoped regeneration grant (see module
    doc).  ``layers``/``orphans`` describe the *current* membership —
    per-client delivery trails stay client-side, exactly as on the
    served path."""

    fingerprint: str
    epoch: int
    seed: int
    generation: int
    world: int
    layers: tuple = ()
    elastic_epoch: Optional[int] = None
    orphans: tuple = ()
    tenant: Optional[str] = None
    #: moving-horizon streams only (docs/STREAMING.md): the horizon's
    #: effective mixture weights, signed into the grant so on-device
    #: regen folds a re-weighted horizon bit-identically; None on frozen
    #: datasets and plain-base streams (and absent from the canonical
    #: encoding then, so pre-streaming capabilities verify unchanged)
    stream_weights: Optional[tuple] = None
    #: federated issuance (docs/FEDERATION.md): the issuing cell and its
    #: signing-key id, so a cross-cell verifier can pick the right key
    #: from its trust bundle; None on unfederated deployments (and
    #: absent from the canonical encoding then, so every pre-federation
    #: capability's signature verifies unchanged)
    cell: Optional[str] = None
    kid: Optional[int] = None
    sig: str = ""

    # ------------------------------------------------------------- encoding
    def body(self) -> dict:
        """The signed fields — everything except the signature itself."""
        out = {
            "fingerprint": str(self.fingerprint),
            "epoch": int(self.epoch),
            "seed": int(self.seed),
            "generation": int(self.generation),
            "world": int(self.world),
            "layers": [[int(a), int(b)] for a, b in self.layers],
            "elastic_epoch": (None if self.elastic_epoch is None
                              else int(self.elastic_epoch)),
            "orphans": [dict(o) for o in self.orphans],
            "tenant": self.tenant,
        }
        if self.stream_weights is not None:
            # additive: only present on mixture-base streams, keeping
            # every pre-streaming capability's canonical bytes (and
            # therefore its signature) byte-identical
            out["stream_weights"] = [int(x) for x in self.stream_weights]
        if self.cell is not None:
            # additive, same rule: only federated issuers stamp their
            # cell and key id into the signed bytes
            out["cell"] = str(self.cell)
        if self.kid is not None:
            out["kid"] = int(self.kid)
        return out

    def canonical(self) -> bytes:
        """The canonical signing encoding: sorted-key compact JSON of
        :meth:`body` — stable across dict orderings and transports."""
        return json.dumps(self.body(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    # -------------------------------------------------------------- signing
    def signed(self, secret) -> "EpochCapability":
        """A copy of this capability carrying the HMAC over
        :meth:`canonical` keyed by ``secret``."""
        mac = hmac.new(secret_bytes(secret), self.canonical(),
                       hashlib.sha256).hexdigest()
        return dataclasses.replace(self, sig=mac)

    def verify(self, secret) -> bool:
        """Constant-time signature check (``hmac.compare_digest``)."""
        if not self.sig:
            return False
        want = hmac.new(secret_bytes(secret), self.canonical(),
                        hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, str(self.sig))

    def tampered(self) -> "EpochCapability":
        """A copy with one signature nibble flipped — the chaos matrix's
        deterministic 'corrupt capability' artifact."""
        sig = str(self.sig) or "0"
        flipped = format(int(sig[0], 16) ^ 0x1, "x") + sig[1:]
        return dataclasses.replace(self, sig=flipped)

    # ----------------------------------------------------------------- wire
    def to_wire(self) -> dict:
        wire = self.body()
        wire["sig"] = str(self.sig)
        return wire

    @classmethod
    def from_wire(cls, wire: dict) -> "EpochCapability":
        try:
            return cls(
                fingerprint=str(wire["fingerprint"]),
                epoch=int(wire["epoch"]),
                seed=int(wire["seed"]),
                generation=int(wire["generation"]),
                world=int(wire["world"]),
                layers=tuple((int(a), int(b))
                             for a, b in (wire.get("layers") or ())),
                elastic_epoch=(None if wire.get("elastic_epoch") is None
                               else int(wire["elastic_epoch"])),
                orphans=tuple(dict(o) for o in (wire.get("orphans") or ())),
                tenant=wire.get("tenant"),
                stream_weights=(
                    None if wire.get("stream_weights") is None
                    else tuple(int(x) for x in wire["stream_weights"])),
                cell=(None if wire.get("cell") is None
                      else str(wire["cell"])),
                kid=(None if wire.get("kid") is None
                     else int(wire["kid"])),
                sig=str(wire.get("sig", "")),
            )
        except (KeyError, TypeError, ValueError) as exc:
            raise CapabilityError(
                f"malformed capability wire: {exc!r}") from exc
