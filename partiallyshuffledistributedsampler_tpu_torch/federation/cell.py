"""``Cell`` and ``Federation``: the multi-cell global plane.

A copy of the JAX package's ``federation/cell.py``.

A **cell** is one self-contained serving deployment — a
:class:`~..sharding.ShardPlane` (N shards + router) with its own WAL
tree, snapshot tree and capability keyring.  A **federation** is two or
more cells under one global namespace (docs/FEDERATION.md):

* the :class:`~.directory.CellDirectory` maps tenant → home cell and is
  served over the existing HELLO protocol (WELCOME fields + the typed
  retryable ``wrong_cell`` redirect, mirroring ``wrong_shard``);
* one :class:`~.shipper.WalShipper` per home shard streams the
  sequenced WAL to the DR cell's mirror standby, which write-throughs
  every applied record into its OWN segment WAL — a cell that loses
  primary, standby and router together is recoverable from the remote
  tail alone;
* fencing terms extend across the cell boundary: when the DR cell
  promotes, the whole superseded home cell fences (every shard refuses
  every write with the typed ``fenced`` error) — a zombie cell can
  never double-serve a span;
* live tenant migration reuses the two-phase reshard barrier shape as
  its cutover primitive: **prepare** = freeze the home cell's mutating
  ops + drain the WAL tail to the target, **commit** = promote the
  target, flip the directory, fence the old home; any failure before
  commit **aborts** to a clean unfrozen rollback
  (:class:`MigrationAborted` — the caller's retry starts over).

Fault sites: ``cell.ship`` (every shipped frame, in shipper.py),
``cell.fence`` (fencing one server of a superseded cell) and
``cell.migrate`` (the cutover, armed before any state changes).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .. import faults as F
from .. import telemetry
from ..service.metrics import ServiceMetrics
from ..sharding import ShardPlane, ShardRouter, ShardServer
from ..sharding.shardmap import ShardMap
from .directory import CellDirectory, DirectoryRef
from .keys import CellKeyring, TrustBundle
from .shipper import WalShipper


class MigrationAborted(RuntimeError):
    """A cross-cell tenant migration rolled back cleanly before commit
    (an injected ``cell.migrate`` fault, or the WAL tail not draining
    within the deadline).  Nothing moved: the home cell is unfrozen and
    still serving — retrying the migration starts over."""


class Cell:
    """One cell of a federation (see module doc).

    ``role="primary"`` wraps a full :class:`ShardPlane`;
    ``role="dr"`` stays empty until :meth:`start_mirror` builds one
    standby per HOME shard (each with its own ``wal_dir`` for the
    receive-side write-through) behind this cell's own router.
    """

    def __init__(self, cell_id: str, spec, *, n_shards: int = 1,
                 host: str = "127.0.0.1", root: Optional[str] = None,
                 standby: bool = False, directory: Optional[DirectoryRef] = None,
                 keyring: Optional[CellKeyring] = None,
                 metrics: Optional[ServiceMetrics] = None,
                 server_kwargs: Optional[dict] = None) -> None:
        self.cell_id = str(cell_id)
        self.spec = spec
        self.n_shards = int(n_shards)
        self.host = host
        self.root = root
        self.with_standby = bool(standby)
        self.directory = directory
        self.keyring = keyring
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.server_kwargs = dict(server_kwargs or {})
        self.plane: Optional[ShardPlane] = None   # primary role
        self.mirrors: list = []                   # DR role: one per home shard
        self.router: Optional[ShardRouter] = None  # DR role's router
        self.map: Optional[ShardMap] = None       # DR role's mirror map
        self.address: Optional[tuple] = None

    # ------------------------------------------------------------ plumbing
    def _cell_kw(self) -> dict:
        kw = dict(self.server_kwargs)
        kw["cell_id"] = self.cell_id
        kw["cell_directory"] = self.directory
        if self.keyring is not None:
            kw.setdefault("capability_secret", self.keyring)
        return kw

    def _path(self, *parts) -> Optional[str]:
        if self.root is None:
            return None
        p = os.path.join(str(self.root), *parts)
        return p

    # ----------------------------------------------------------- lifecycle
    def start(self) -> tuple:
        """Start this cell as a HOME (primary) cell: a full plane with
        per-shard WALs under ``root/wal/``.  Returns the entry address
        (the cell's router)."""
        if self.root is not None:
            os.makedirs(os.path.join(str(self.root), "snap"), exist_ok=True)
        self.plane = ShardPlane(
            self.spec, self.n_shards, host=self.host,
            standby=self.with_standby,
            wal_dir=self._path("wal"),
            snapshot_dir=self._path("snap"),
            multi_tenant=bool(self.server_kwargs.get("multi_tenant",
                                                     False)),
            server_kwargs=self._cell_kw(),
            router_kwargs={"cell_id": self.cell_id,
                           "cell_directory": self.directory})
        self.address = self.plane.start()
        return self.address

    def start_mirror(self, home: "Cell", *,
                     repl_feed_timeout: float = 0.2) -> tuple:
        """Start this cell as the DR side: one standby mirror per home
        shard — each with its OWN ``wal_dir`` (the shipped tail's
        durable copy) — behind this cell's own router.  Returns the DR
        entry address the client dial ladder ends at."""
        if home.plane is None:
            raise RuntimeError(
                f"home cell {home.cell_id!r} is not started")
        if self.root is not None:
            os.makedirs(os.path.join(str(self.root), "snap"), exist_ok=True)
        n = home.plane.map.n_shards
        self.map = ShardMap.for_world(self.spec.world, n)
        kw = self._cell_kw()
        for sid in range(n):
            srv = ShardServer(
                self.spec, sid, self.map, self.host, 0,
                role="standby",
                repl_feed_timeout=float(repl_feed_timeout),
                wal_dir=self._path("wal"),
                snapshot_path=(None if self.root is None else
                               self._path("snap", f"shard-{sid}.json")),
                **kw)
            srv.start()
            self.map.set_addr(sid, srv.address)
            self.mirrors.append(srv)
        self.router = ShardRouter(
            self.spec, self.map, self.host, 0,
            snapshot_path=(None if self.root is None else
                           self._path("snap", "router.json")),
            multi_tenant=bool(self.server_kwargs.get("multi_tenant",
                                                     False)),
            cell_id=self.cell_id,
            cell_directory=self.directory)
        self.address = self.router.start()
        return self.address

    def servers(self) -> list:
        """Every server process of this cell (shards + in-cell standbys
        on a primary cell; the mirrors on a DR cell)."""
        if self.plane is not None:
            return list(self.plane.shards) + list(self.plane.standbys)
        return list(self.mirrors)

    def fence(self, term: int) -> None:
        """Fence EVERY server of this cell at ``term`` — the whole-cell
        zombie guard a cross-cell promotion leaves behind.  The
        ``cell.fence`` fault site arms per server; a server whose fence
        call was injected away still self-fences at its first
        newer-term request (``_term_refusal``), so the end state —
        exactly one writable cell — is reached either way."""
        for srv in self.servers():
            try:
                F.fire("cell.fence")
            except F.InjectedThreadDeath:
                raise
            except Exception:  # lint: allow-broad-except(injected fence fault; the server self-fences on its next newer-term write)
                self.metrics.inc("cell_fence_faults")
                continue
            srv._fence(int(term))
            self.metrics.inc("cell_fenced")
        telemetry.event("cell_fenced", cell=self.cell_id, term=int(term))

    def freeze(self, on: bool = True) -> None:
        """Freeze/unfreeze mutating client ops on every server of this
        cell (the migration cutover barrier)."""
        for srv in self.servers():
            srv.freeze_writes(on)

    def kill(self) -> None:
        """Abrupt whole-cell death for DR drills: primary + standby +
        router all at once, no snapshots, no goodbyes."""
        if self.router is not None:
            self.router.kill()
        if self.plane is not None and self.plane.router is not None:
            self.plane.router.kill()
        for srv in self.servers():
            srv.kill()
        telemetry.event("cell_killed", cell=self.cell_id)

    def stop(self) -> None:
        if self.plane is not None:
            self.plane.stop()
            self.plane = None
        if self.router is not None:
            self.router.stop()
            self.router = None
        for srv in self.mirrors:
            srv.stop()
        self.mirrors.clear()


class Federation:
    """A two-cell federation: one home cell serving, one DR cell
    mirroring it over cross-cell WAL shipping (see module doc).

        fed = Federation(spec, root=tmp, home="east", dr="west")
        addr = fed.start()                  # east's router: dial here
        fed.wait_synced()                   # shippers bootstrapped
        fed.kill_cell("east")               # the whole home cell dies
        fed.promote("west")                 # DR promotes + directory flips
        ...                                 # clients ladder to west

    ``capability_root`` turns on federated issuance: each cell signs
    with its own :class:`CellKeyring` and clients verify against the
    :class:`TrustBundle` (``fed.trust``)."""

    def __init__(self, spec, *, root: str, home: str = "east",
                 dr: str = "west", n_shards: int = 1,
                 host: str = "127.0.0.1", standby: bool = False,
                 capability_root=None, repl_feed_timeout: float = 0.2,
                 server_kwargs: Optional[dict] = None) -> None:
        self.spec = spec
        self.metrics = ServiceMetrics()
        self.directory_ref = DirectoryRef()
        self.home_id, self.dr_id = str(home), str(dr)
        if self.home_id == self.dr_id:
            raise ValueError("home and dr must be distinct cells")
        self.keyrings: dict = {}
        self.trust: Optional[TrustBundle] = None
        if capability_root is not None:
            self.keyrings = {c: CellKeyring(c, root=capability_root)
                             for c in (self.home_id, self.dr_id)}
            self.trust = TrustBundle(self.keyrings.values())
        self.repl_feed_timeout = float(repl_feed_timeout)
        self.cells = {
            cid: Cell(cid, spec, n_shards=n_shards, host=host,
                      root=os.path.join(str(root), cid),
                      standby=standby, directory=self.directory_ref,
                      keyring=self.keyrings.get(cid),
                      metrics=self.metrics, server_kwargs=server_kwargs)
            for cid in (self.home_id, self.dr_id)
        }
        self.shippers: list = []

    # ----------------------------------------------------------- lifecycle
    def start(self) -> tuple:
        """Home plane up → DR mirrors up → directory installed → one
        cross-cell shipper per home shard.  Returns the home entry
        address."""
        home = self.cells[self.home_id]
        drc = self.cells[self.dr_id]
        home.start()
        drc.start_mirror(home, repl_feed_timeout=self.repl_feed_timeout)
        self.directory_ref.set(CellDirectory(
            {self.home_id: home.address, self.dr_id: drc.address},
            default=self.home_id,
            dr={self.home_id: self.dr_id, self.dr_id: self.home_id}))
        # pre-register the shipping metric family so a zero stays
        # visible in report() (docs/OBSERVABILITY.md "Federation
        # metrics") — the shipper itself counts through class attrs
        self.metrics.inc("cell_shipped", value=0)
        self.metrics.inc("cell_ship_resyncs", value=0)
        self.metrics.registry.histogram("cell_ship_lag_ms")
        for src, dst in zip(home.plane.shards, drc.mirrors):
            sh = WalShipper(
                src._repl_log, dst.address,
                cell_id=self.home_id, target_cell=self.dr_id,
                state_fn=src._repl_sync_state,
                term_fn=(lambda s=src: s.term),
                on_fenced=(lambda term: home.fence(term)),
                metrics=src.metrics)
            sh.start()
            self.shippers.append(sh)
        return home.address

    @property
    def address(self) -> tuple:
        """The home cell's entry address (clients dial here first)."""
        return self.cells[self.home_id].address

    def directory(self) -> CellDirectory:
        return self.directory_ref.current()

    def wait_synced(self, timeout: float = 5.0) -> bool:
        """Block until every cross-cell shipper has bootstrapped its
        SYNC at least once."""
        ok = True
        for sh in self.shippers:
            ok = sh.synced.wait(timeout) and ok
        return ok

    def wait_shipped(self, timeout: float = 5.0) -> bool:
        """Block until every shipper's acked prefix reaches its log's
        current lsn — the WAL tail is fully at the DR cell."""
        home = self.cells[self.home_id]
        deadline = time.monotonic() + float(timeout)
        for src, sh in zip(home.plane.shards, self.shippers):
            while sh.shipped_lsn < src._repl_log.lsn:
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.005)
        return True

    def stop(self) -> None:
        for sh in self.shippers:
            sh.stop(join=False)
        self.shippers.clear()
        for cell in self.cells.values():
            cell.stop()

    def __enter__(self) -> "Federation":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------- disaster recovery
    def kill_cell(self, cell_id: str) -> None:
        """The DR drill: kill EVERY process of one cell at once
        (primary shards, in-cell standbys, router).  Killing the home
        cell also stops the now-pointless shippers."""
        if str(cell_id) == self.home_id:
            for sh in self.shippers:
                sh.stop(join=False)
        self.cells[str(cell_id)].kill()

    def promote(self, cell_id: str, *, dead: Optional[str] = None
                ) -> CellDirectory:
        """Force-promote ``cell_id``'s mirrors, flip every tenant of the
        dead cell (default: the home cell) to it in a version-bumped
        directory, and fence the superseded cell.  Returns the installed
        directory."""
        cell = self.cells[str(cell_id)]
        dead = self.home_id if dead is None else str(dead)
        term = 0
        for srv in cell.mirrors:
            srv._try_promote(force=True)
            term = max(term, int(srv.term))
        d = self.directory_ref.current()
        nd = self.directory_ref.set(d.flip_cell(dead, str(cell_id)))
        # the zombie guard: even if the dead cell is not actually dead
        # (an operator-driven switchover), every one of its servers now
        # refuses every write with the typed ``fenced`` error
        self.cells[dead].fence(term)
        self.metrics.inc("federation_failovers")
        telemetry.event("federation_failover", cell=str(cell_id),
                        dead=dead, term=term,
                        directory_version=nd.version)
        return nd

    # ------------------------------------------------------ live migration
    def migrate_tenant(self, tenant: str, to: str, *,
                       deadline_s: float = 5.0) -> CellDirectory:
        """Two-phase cross-cell tenant cutover (see module doc).

        prepare: freeze the home cell's mutating ops (HELLO stays live)
        and drain the WAL tail to the target cell; commit: promote the
        target's mirrors, flip the directory, fence the old home; any
        failure before commit aborts to a clean unfrozen rollback."""
        to = str(to)
        if to not in self.cells:
            raise ValueError(f"unknown target cell {to!r}")
        home = self.cells[self.home_id]
        target = self.cells[to]
        # ---- prepare: freeze + ship the tail
        home.freeze(True)
        try:
            F.fire("cell.migrate")
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:
            home.freeze(False)
            self.metrics.inc("federation_migrate_aborts")
            raise MigrationAborted(
                f"cell migration of tenant {tenant!r} aborted cleanly "
                f"({exc!r}); the home cell is unfrozen — retry") from exc
        if not self.wait_shipped(timeout=deadline_s):
            home.freeze(False)
            self.metrics.inc("federation_migrate_aborts")
            raise MigrationAborted(
                f"WAL tail did not drain to cell {to!r} within "
                f"{deadline_s}s; the home cell is unfrozen — retry")
        # ---- commit: promote target, flip directory, fence old home
        term = 0
        for srv in target.mirrors:
            srv._try_promote(force=True)
            term = max(term, int(srv.term))
        d = self.directory_ref.current()
        nd = self.directory_ref.set(d.flip(str(tenant), to))
        home.fence(term)
        home.freeze(False)  # fenced anyway; leave no stray barrier
        self.metrics.inc("federation_migrations")
        telemetry.event("federation_migrated", tenant=str(tenant), to=to,
                        term=term, directory_version=nd.version)
        return nd
