"""Federated capability keys: per-cell signing keyrings + trust bundles.

A copy of the JAX package's ``federation/keys.py``: the per-cell key
derivation and the signatures are byte-equal across the two packages.

Unfederated deployments share ONE ``capability_secret`` between daemon
and clients (docs/CAPABILITY.md).  A federation gives every cell its
own :class:`CellKeyring` — versioned signing keys addressed by ``kid``
— and hands clients a :class:`TrustBundle` mapping ``(cell, kid)`` to
the verifying secret.  A capability signed by cell ``east`` at key 2
carries ``cell="east", kid=2`` inside its signed bytes (additive
fields, capability/token.py), so after a failover the promoted DR cell
can keep HONORING outstanding grants (the verifier still holds east's
key) while issuing new ones under its own key; a grant whose key was
rotated away fails verification LOUDLY (``CapabilityError`` naming the
missing key) and the client re-issues against the new home cell —
never a silent acceptance, never a silent drop
(docs/FEDERATION.md "Federated capabilities").
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..analysis.lockorder import new_lock
from ..capability import CapabilityError, EpochCapability, secret_bytes


def _derived(cell_id: str, kid: int, root) -> bytes:
    """A deterministic per-(cell, kid) key from one root secret — lets
    tests build symmetric keyrings/bundles without shipping key
    material around."""
    return hashlib.sha256(
        b"psds-cell-key:" + secret_bytes(root)
        + f":{cell_id}:{kid}".encode("utf-8")).digest()


class CellKeyring:
    """One cell's capability signing keys, versioned by ``kid``.

        ring = CellKeyring("east", root="deployment-secret")
        kid, secret = ring.current()      # (1, <derived key>)
        ring.rotate()                     # kid 2 becomes the signer
        ring.retire(1)                    # old grants now fail loudly

    ``rotate`` keeps the superseded key verifiable until ``retire`` —
    rotation must not orphan every outstanding grant at once."""

    def __init__(self, cell_id: str, *, root=None,
                 secret=None) -> None:
        self.cell_id = str(cell_id)
        self._root = root
        self._lock = new_lock("federation.keyring")
        first = (secret_bytes(secret) if secret is not None
                 else _derived(self.cell_id, 1, root if root is not None
                               else self.cell_id))
        self._keys = {1: first}   # guarded by: self._lock
        self._kid = 1             # guarded by: self._lock — signing key

    @property
    def kid(self) -> int:
        with self._lock:
            return self._kid

    def current(self) -> tuple:
        """``(kid, secret)`` of the active signing key."""
        with self._lock:
            return self._kid, self._keys[self._kid]

    def rotate(self, secret=None) -> int:
        """Install a new signing key (returns its ``kid``).  The old
        key stays verifiable until explicitly retired."""
        with self._lock:
            kid = self._kid + 1
            self._keys[kid] = (
                secret_bytes(secret) if secret is not None
                else _derived(self.cell_id, kid,
                              self._root if self._root is not None
                              else self.cell_id))
            self._kid = kid
            return kid

    def retire(self, kid: int) -> None:
        """Drop key ``kid`` — every grant it signed now fails loudly.
        The active signing key cannot be retired."""
        with self._lock:
            if int(kid) == self._kid:
                raise ValueError(
                    f"kid {kid} is the active signing key; rotate first")
            self._keys.pop(int(kid), None)

    def secret_for(self, kid: int) -> bytes:
        with self._lock:
            try:
                return self._keys[int(kid)]
            except KeyError:
                raise CapabilityError(
                    f"cell {self.cell_id!r} holds no key kid={kid} "
                    "(rotated away?); re-issue the capability") from None

    def kids(self) -> list:
        with self._lock:
            return sorted(self._keys)


class TrustBundle:
    """The verifier side: every cell's keyring a client trusts.

    ``verify(cap)`` resolves ``(cap.cell, cap.kid)`` to the right
    secret and checks the HMAC; an unknown cell or a retired kid is a
    loud :class:`CapabilityError` telling the client to RE-ISSUE, never
    a silent pass/fail ambiguity."""

    def __init__(self, keyrings=()) -> None:
        self._rings = {}
        for r in keyrings:
            self.add(r)

    def add(self, keyring: CellKeyring) -> "TrustBundle":
        self._rings[keyring.cell_id] = keyring
        return self

    def ring(self, cell_id: str) -> CellKeyring:
        try:
            return self._rings[str(cell_id)]
        except KeyError:
            raise CapabilityError(
                f"no trusted keyring for cell {cell_id!r}") from None

    def secret_for(self, cell_id: str, kid: int) -> bytes:
        return self.ring(cell_id).secret_for(kid)

    def verify(self, cap: EpochCapability) -> bool:
        """Signature check against the issuing cell's key.  A grant
        without cell/kid stamps is not a federated grant — refuse it
        here rather than guessing a key (the caller's unfederated
        secret path handles those)."""
        if cap.cell is None or cap.kid is None:
            raise CapabilityError(
                "capability carries no cell/kid stamp; a TrustBundle "
                "cannot pick a verifying key for it")
        return cap.verify(self.secret_for(cap.cell, cap.kid))

    def cells(self) -> list:
        return sorted(self._rings)


def sign_capability(keyring: CellKeyring,
                    cap: EpochCapability) -> EpochCapability:
    """Stamp ``cap`` with the ring's cell + active kid and sign it —
    the federated issuance primitive ``IndexServer._capability_locked``
    rides when its ``capability_secret`` is a keyring."""
    import dataclasses

    kid, secret = keyring.current()
    stamped = dataclasses.replace(cap, cell=keyring.cell_id, kid=kid)
    return stamped.signed(secret)


def verify_capability(trust, cap: EpochCapability) -> bool:
    """Verify with either a plain secret (unfederated) or a
    :class:`TrustBundle`/:class:`CellKeyring` (federated) — the one
    call sites use so a client's ``capability_secret`` knob accepts
    every shape."""
    if isinstance(trust, TrustBundle):
        return trust.verify(cap)
    if isinstance(trust, CellKeyring):
        if cap.kid is None:
            raise CapabilityError(
                "capability carries no kid; a keyring cannot pick a "
                "verifying key for it")
        return cap.verify(trust.secret_for(cap.kid))
    return cap.verify(trust)
