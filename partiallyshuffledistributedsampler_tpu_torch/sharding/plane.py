"""``ShardPlane``: one-call deployment of a sharded serving plane.

A copy of the JAX package's ``sharding/plane.py``.

The production topology (docs/SHARDING.md "Deployment topology") is N
``ShardServer`` processes plus one ``ShardRouter``; this helper builds
the same thing in-process for tests, benchmarks and single-host runs:
construct the canonical :class:`~.shardmap.ShardMap`, start every shard
(each optionally paired with a hot standby and given its own
``wal_dir/<shard_id>/`` + snapshot file), record the bound addresses in
the shared map, then start the router over it.  ``stop()`` tears down in
reverse.  The plane object is a context manager, mirroring
``IndexServer``'s ergonomics.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import faults as F
from .router import ShardRouter
from .shardmap import ShardMap
from .shards import ShardServer


class ShardPlane:
    """N shards (+ optional standbys) behind one router (see module doc)."""

    def __init__(self, spec, n_shards: int, *, host: str = "127.0.0.1",
                 router_port: int = 0, standby: bool = False,
                 wal_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 multi_tenant: bool = False,
                 server_kwargs: Optional[dict] = None,
                 router_kwargs: Optional[dict] = None):
        self.spec = spec
        self.map = ShardMap.for_world(spec.world, n_shards)
        self.host, self.router_port = host, int(router_port)
        self.with_standby = bool(standby)
        self.wal_dir = wal_dir
        self.snapshot_dir = snapshot_dir
        self.multi_tenant = bool(multi_tenant)
        self.server_kwargs = dict(server_kwargs or {})
        #: extra ShardRouter kwargs — a federated Cell threads its
        #: ``cell_id``/``cell_directory`` through here (docs/FEDERATION.md)
        self.router_kwargs = dict(router_kwargs or {})
        self.shards: list = []
        self.standbys: list = []
        self.router: Optional[ShardRouter] = None

    def _snap(self, name: str) -> Optional[str]:
        if self.snapshot_dir is None:
            return None
        return os.path.join(self.snapshot_dir, name)

    def start(self) -> tuple:
        """Start shards (+standbys), then the router; returns the router
        address clients HELLO first."""
        kw = dict(self.server_kwargs)
        kw.setdefault("multi_tenant", self.multi_tenant)
        for sid in range(self.map.n_shards):
            standby_addr = None
            if self.with_standby:
                sb = ShardServer(self.spec, sid, self.map, self.host, 0,
                                 role="standby",
                                 snapshot_path=self._snap(
                                     f"shard-{sid}-standby.json"),
                                 **kw)
                sb.start()
                self.standbys.append(sb)
                standby_addr = sb.address
            srv = ShardServer(self.spec, sid, self.map, self.host, 0,
                              wal_dir=self.wal_dir,
                              snapshot_path=self._snap(f"shard-{sid}.json"),
                              standby=standby_addr,
                              **kw)
            srv.start()
            self.shards.append(srv)
            self.map.set_addr(sid, srv.address)
        self.router = ShardRouter(
            self.spec, self.map, self.host, self.router_port,
            snapshot_path=self._snap("router.json"),
            multi_tenant=self.multi_tenant,
            **self.router_kwargs)
        return self.router.start()

    @property
    def address(self) -> tuple:
        return self.router.address

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
        for srv in self.shards:
            srv.stop()
        for sb in self.standbys:
            sb.stop()
        self.shards.clear()
        self.standbys.clear()
        self.router = None

    def __enter__(self) -> "ShardPlane":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------- elastic topology
    # The autopilot's shard-map arm (docs/AUTOPILOT.md) drives these;
    # each composes a ShardMap transform with the router's two-phase
    # remap, so clients ride a ``wrong_shard`` redirect — never a
    # generation bump — and folded streams stay bit-identical.
    def _server(self, shard_id: int) -> ShardServer:
        for srv in self.shards:
            if srv.shard_id == int(shard_id):
                return srv
        raise KeyError(f"no live shard {shard_id}")

    def _adopt_standby_maps(self, new_map: ShardMap) -> None:
        for sb in self.standbys:
            sb.adopt_map(new_map)

    def split_shard(self, shard_id: int, at: Optional[int] = None) -> int:
        """Split a hot shard: start a NEW server over the upper half of
        its slice, then hand those ranks over via the router's
        two-phase remap.  Returns the new shard's id."""
        F.fire("shard.split")
        new_map = self.map.split(shard_id, at)
        new_sid = new_map.n_shards - 1
        kw = dict(self.server_kwargs)
        kw.setdefault("multi_tenant", self.multi_tenant)
        standby_addr = None
        sb = None
        if self.with_standby:
            sb = ShardServer(self.spec, new_sid, new_map, self.host, 0,
                             role="standby",
                             snapshot_path=self._snap(
                                 f"shard-{new_sid}-standby.json"),
                             **kw)
            sb.start()
            standby_addr = sb.address
        srv = ShardServer(self.spec, new_sid, new_map, self.host, 0,
                          wal_dir=self.wal_dir,
                          snapshot_path=self._snap(f"shard-{new_sid}.json"),
                          standby=standby_addr,
                          **kw)
        srv.start()
        new_map.set_addr(new_sid, srv.address)
        try:
            self.router.remap(new_map)
        except Exception:
            srv.stop()
            if sb is not None:
                sb.stop()
            raise
        self.shards.append(srv)
        if sb is not None:
            self.standbys.append(sb)
        self.map = new_map
        self._adopt_standby_maps(new_map)
        return new_sid

    def merge_shards(self, into_id: int, from_id: int) -> ShardMap:
        """Fold a cold shard into its rank-adjacent neighbor and stop
        the emptied server (it redirects its last clients during the
        remap commit, before it goes away)."""
        new_map = self.map.merged(into_id, from_id)
        self.router.remap(new_map)
        self.map = new_map
        self._adopt_standby_maps(new_map)
        victim = self._server(from_id)
        self.shards.remove(victim)
        victim.stop()
        for sb in list(self.standbys):
            if sb.shard_id == int(from_id):
                self.standbys.remove(sb)
                sb.stop()
        return new_map

    def migrate_ranks(self, from_id: int, to_id: int,
                      count: int) -> ShardMap:
        """Shift ``count`` boundary ranks from one shard to its
        rank-adjacent neighbor (both stay live)."""
        new_map = self.map.migrated(from_id, to_id, count)
        self.router.remap(new_map)
        self.map = new_map
        self._adopt_standby_maps(new_map)
        return new_map
