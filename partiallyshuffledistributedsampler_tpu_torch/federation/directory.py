"""The global cell namespace: tenant → home cell, versioned.

A copy of the JAX package's ``federation/directory.py``: the wire and
its fingerprint are byte-equal across the two packages.

A :class:`CellDirectory` is the federation's counterpart of the
sharding plane's ``ShardMap`` (docs/SHARDING.md): an immutable,
versioned, CRC-fingerprinted value object that every cell's servers and
routers consult at HELLO time.  A client whose tenant is homed
elsewhere gets the typed retryable ``wrong_cell`` refusal carrying the
directory wire form, mirrors ``wrong_shard`` exactly, and re-dials the
home cell's entry address (docs/FEDERATION.md "Cell directory").

Mutation is replacement: a failover promotion or a tenant migration
builds a NEW directory with ``version + 1`` via :meth:`flip` /
:meth:`flip_cell` and installs it in the shared :class:`DirectoryRef`.
Adoption everywhere (client and server alike) is version-gated, so a
stale wire copy riding a delayed refusal can never roll the namespace
back — the same rule ``ServiceIndexClient._adopt_shard_map`` enforces
for shard maps.
"""

from __future__ import annotations

import json
import zlib
from typing import Optional

from ..analysis.lockorder import new_lock


def _addr(a) -> tuple:
    return (str(a[0]), int(a[1]))


class CellDirectory:
    """Immutable tenant → home-cell mapping plus the cell address book.

        d = CellDirectory({"east": ("127.0.0.1", 7001),
                           "west": ("127.0.0.1", 7002)},
                          default="east", dr={"east": "west"})
        d.home("t-abc123")        # "east" (the default: no explicit row)
        d2 = d.flip("t-abc123", "west")   # version + 1

    ``cells`` maps cell id → that cell's client entry address (its
    router on a sharded cell, the daemon itself otherwise); ``tenants``
    holds only the explicit rows — every unmapped tenant is homed at
    ``default``; ``dr`` names each cell's disaster-recovery partner.
    """

    __slots__ = ("cells", "tenants", "dr", "default", "version")

    def __init__(self, cells: dict, *, tenants: Optional[dict] = None,
                 dr: Optional[dict] = None, default: Optional[str] = None,
                 version: int = 1) -> None:
        if not cells:
            raise ValueError("a CellDirectory needs at least one cell")
        self.cells = {str(c): _addr(a) for c, a in cells.items()}
        self.tenants = {str(t): str(c)
                        for t, c in (tenants or {}).items()}
        self.dr = {str(c): str(p) for c, p in (dr or {}).items()}
        self.default = (str(default) if default is not None
                        else sorted(self.cells)[0])
        self.version = int(version)
        for c in self.tenants.values():
            if c not in self.cells:
                raise ValueError(f"tenant homed at unknown cell {c!r}")
        for c, p in self.dr.items():
            if c not in self.cells or p not in self.cells:
                raise ValueError(f"dr pairing {c!r}->{p!r} names an "
                                 "unknown cell")
        if self.default not in self.cells:
            raise ValueError(f"default cell {self.default!r} is unknown")

    # ------------------------------------------------------------- queries
    def home(self, tenant: Optional[str]) -> str:
        """The cell serving ``tenant`` (the default cell when the
        directory holds no explicit row, or for the anonymous tenant)."""
        if tenant is None:
            return self.default
        return self.tenants.get(str(tenant), self.default)

    def dr_for(self, cell: str) -> Optional[str]:
        return self.dr.get(str(cell))

    def addr(self, cell: str) -> tuple:
        return self.cells[str(cell)]

    # ----------------------------------------------------------- evolution
    def flip(self, tenant: str, new_home: str) -> "CellDirectory":
        """A copy homing ``tenant`` at ``new_home``, ``version + 1`` —
        the migration commit's directory half."""
        if str(new_home) not in self.cells:
            raise ValueError(f"unknown cell {new_home!r}")
        tenants = dict(self.tenants)
        tenants[str(tenant)] = str(new_home)
        return CellDirectory(self.cells, tenants=tenants, dr=self.dr,
                             default=self.default,
                             version=self.version + 1)

    def flip_cell(self, dead: str, to: str) -> "CellDirectory":
        """A copy re-homing EVERY tenant of cell ``dead`` (explicit rows
        and, when ``dead`` was the default, the default itself) at
        ``to`` — the disaster-recovery promotion's directory half."""
        if str(to) not in self.cells:
            raise ValueError(f"unknown cell {to!r}")
        dead, to = str(dead), str(to)
        tenants = {t: (to if c == dead else c)
                   for t, c in self.tenants.items()}
        default = to if self.default == dead else self.default
        return CellDirectory(self.cells, tenants=tenants, dr=self.dr,
                             default=default, version=self.version + 1)

    # ----------------------------------------------------------------- wire
    def to_wire(self) -> dict:
        return {
            "version": self.version,
            "cells": {c: list(a) for c, a in sorted(self.cells.items())},
            "tenants": dict(sorted(self.tenants.items())),
            "dr": dict(sorted(self.dr.items())),
            "default": self.default,
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "CellDirectory":
        return cls({c: _addr(a) for c, a in wire["cells"].items()},
                   tenants=wire.get("tenants"),
                   dr=wire.get("dr"),
                   default=wire.get("default"),
                   version=int(wire.get("version", 1)))

    def fingerprint(self) -> str:
        """CRC32 over the canonical wire encoding — cheap equality for
        traces and tests, exactly like ``ShardMap.fingerprint``."""
        blob = json.dumps(self.to_wire(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        return format(zlib.crc32(blob) & 0xFFFFFFFF, "08x")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CellDirectory(v{self.version}, cells="
                f"{sorted(self.cells)}, default={self.default!r})")


class DirectoryRef:
    """The one mutable cell in the federation: a thread-safe holder all
    of a deployment's servers, routers and the coordinator share.  The
    directory VALUE stays immutable; ``set`` only ever installs a newer
    version (monotonic), so a racing stale flip loses loudly."""

    def __init__(self, directory: Optional[CellDirectory] = None) -> None:
        self._lock = new_lock("federation.directory")
        # empty construction is deliberate: servers receive the ref
        # BEFORE any cell address exists; the coordinator installs the
        # first directory once every cell has bound its port
        self._directory = directory  # guarded by: self._lock

    def current(self) -> Optional[CellDirectory]:
        with self._lock:
            return self._directory

    def set(self, directory: CellDirectory) -> CellDirectory:
        with self._lock:
            if (self._directory is not None
                    and directory.version <= self._directory.version):
                raise ValueError(
                    f"directory version {directory.version} does not "
                    f"advance past {self._directory.version}")
            self._directory = directory
            return directory
