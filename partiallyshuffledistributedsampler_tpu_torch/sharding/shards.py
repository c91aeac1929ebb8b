"""``ShardServer``: an ``IndexServer`` that owns one slice of the rank space.

A copy of the JAX package's ``sharding/shards.py`` over the port's
``IndexServer``: on a ``backend="cuda"`` spec each regen runs the spec's
kernels on the card.  One difference: within an epoch a barrier
resharded, an auto-claim (``rank=-1``) takes only a grown world's new
rank or a slot the barrier freed (a leaver's, a dead rank's), once
(``_adoptable_locked``).  The JAX package's shard takes any slot of its
slice without a live lease, so a client shrunk out of the world could
take a survivor's slot — one whose survivor had finished and closed, or
was still on its way from the shard that owned it before the map flip —
and be served that survivor's remainder a second time.

A shard is a full :class:`~..service.IndexServer` — same spec (at the
full world size), same leases/acks/epochs/snapshots/replication/WAL —
plus the rank-space gate (docs/SHARDING.md): it knows the deployment's
:class:`~.shardmap.ShardMap` and its own ``shard_id``, refuses a HELLO
for a rank it does not own with the typed ``wrong_shard`` error
(carrying ``retry_ms`` and a fresh map so the client re-routes without a
router round-trip), restricts auto-claim (``rank=-1``) to its own slice,
and rides ``shard_map`` + ``shard`` in WELCOME.  Durability nests per
shard: a ``wal_dir`` is suffixed with the shard id, so N shards under
one base directory never interleave logs.  Cross-shard reshard barriers
arrive as phased ``RESHARD`` frames from the router (prepare → commit
with the imposed global barrier, or abort), mapping onto the server's
two-phase ``_reshard_prepare`` / ``_reshard_commit_prepared`` split; the
new map is adopted atomically with the cascade commit, and leases for
ranks the new map moved elsewhere are dropped so their clients re-route.
"""

from __future__ import annotations

import os

from .. import telemetry
from ..service import protocol as P
from ..service.server import IndexServer
from .shardmap import ShardMap


class ShardServer(IndexServer):
    """One shared-nothing shard of the rank space (see module doc)."""

    _ACCEPT_THREAD_NAME = "psds-shard-accept"
    _CONN_THREAD_PREFIX = "psds-shard-conn"

    def __init__(self, spec, shard_id: int, shard_map: ShardMap,
                 host: str = "127.0.0.1", port: int = 0, *,
                 wal_dir=None, **kw):
        if wal_dir is not None:
            # per-shard WAL: N shards under one base dir never interleave
            wal_dir = os.path.join(str(wal_dir), str(int(shard_id)))
        super().__init__(spec, host, port, wal_dir=wal_dir, **kw)
        self.shard_id = int(shard_id)
        #: the deployment's rank→shard partition; swapped wholesale (an
        #: atomic reference) at cross-shard commit, read lock-free on
        #: the HELLO gate
        self.shard_map = shard_map
        #: map staged by a phased commit, adopted with the cascade
        #: commit  # guarded by: self._lock
        self._pending_map = None
        #: ranks frozen mid-migration: the cut is prepared but not yet
        #: committed, so their GET_BATCHes pause-and-retry rather than
        #: racing the state handoff  # guarded by: self._lock
        self._migrating: set = set()
        #: ranks this shard handed to a sibling at a migrate commit;
        #: their requests draw ``wrong_shard`` (the same typed redirect
        #: a misrouted HELLO gets) until the client re-routes — the map
        #: flip carries NO generation bump, so the stream folds
        #: bit-identically at the new owner  # guarded by: self._lock
        self._migrated_out: set = set()
        #: the slots the last barrier freed (a leaver's, a dead rank's)
        #: not yet taken by an auto-claim  # guarded by: self._lock
        self._freed_slots: set = set()

    # --------------------------------------------------------- rank gating
    def _owned(self) -> tuple:
        return self.shard_map.ranks(self.shard_id)

    def _wrong_shard_err(self, rank: int) -> dict:
        m = self.shard_map
        try:
            owner = m.owner(rank)
        except ValueError:
            owner = None
        return {
            "code": "wrong_shard",
            "retry_ms": self.backpressure.retry_ms("wrong_shard"),
            "shard": self.shard_id, "owner": owner,
            "shard_map": m.to_wire(),
            "detail": f"rank {rank} is not owned by shard {self.shard_id} "
                      f"(slice {list(self._owned())}, map v{m.version}); "
                      f"re-route via the attached shard_map",
        }

    def _on_hello(self, sock, conn_id, header) -> None:
        want = header.get("rank", -1)
        want = -1 if want is None else int(want)
        m = self.shard_map
        if 0 <= want < m.world and not m.owns(self.shard_id, want):
            self.metrics.inc("wrong_shard_hellos")
            P.send_msg(sock, P.MSG_ERROR, self._wrong_shard_err(want))
            return
        super()._on_hello(sock, conn_id, header)

    def _on_get_capability(self, sock, conn_id, header) -> None:
        # capabilities are issued by the OWNING shard only — the grant
        # names the membership generation this shard's barrier protocol
        # revokes, so a sibling must not sign for a rank it cannot
        # revoke for (docs/CAPABILITY.md, docs/SHARDING.md)
        want = header.get("rank", -1)
        want = -1 if want is None else int(want)
        m = self.shard_map
        if 0 <= want < m.world and not m.owns(self.shard_id, want):
            self.metrics.inc("wrong_shard_hellos")
            P.send_msg(sock, P.MSG_ERROR, self._wrong_shard_err(want))
            return
        super()._on_get_capability(sock, conn_id, header)

    def _claim_rank_locked(self, want: int, conn_id: int, now: float):
        if want < 0:
            # auto-claim stays inside this shard's slice: the rest of
            # the rank space belongs to sibling shards
            lo, hi = self._owned()
            for rank in range(lo, min(hi, self.spec.world)):
                if not self._adoptable_locked(rank):
                    continue
                got = super()._claim_rank_locked(rank, conn_id, now)
                if got is not None:
                    self._freed_slots.discard(got)
                    return got
            return None
        return super()._claim_rank_locked(want, conn_id, now)

    def _adoptable_locked(self, rank: int) -> bool:
        """Whether an auto-claim may take ``rank`` (module doc): within an
        epoch a barrier resharded, only a grown world's new rank or a
        slot the barrier freed is — every other slot is a survivor's,
        whether its client is streaming, done, or still re-routing here
        after the map flip.  Under ``self._lock``."""
        layers = self._gen_layers_locked(self.epoch)
        if not layers:
            return True
        return rank >= int(layers[-1][0]) or rank in self._freed_slots

    def _welcome_extra(self) -> dict:
        return {"shard": self.shard_id,
                "shard_map": self.shard_map.to_wire()}

    def _span_extra(self, eng) -> dict:
        extra = super()._span_extra(eng)
        extra["shard"] = self.shard_id
        return extra

    # --------------------------------------------- cross-shard barriers
    def _on_reshard(self, sock, conn_id, header) -> None:
        phase = header.get("phase")
        if phase is None:
            # a plain RESHARD stays the local single-server barrier
            super()._on_reshard(sock, conn_id, header)
            return
        if phase == "prepare":
            try:
                new_world = int(header["world"])
                if new_world < 1:
                    raise ValueError(new_world)
            except (KeyError, TypeError, ValueError):
                P.send_msg(sock, P.MSG_ERROR,
                           {"code": "bad_request",
                            "detail": "RESHARD prepare needs an int "
                                      "world >= 1"})
                return
            rep = self._reshard_prepare(new_world)
            if rep is None:
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "retry_ms":
                        self.backpressure.retry_ms("reshard_conflict"),
                    "detail": "a reshard is already in flight; retry",
                })
                return
            P.send_msg(sock, P.MSG_OK,
                       {"phase": "prepare", "shard": self.shard_id, **rep})
            return
        if phase == "commit":
            try:
                barrier = int(header["barrier_units"])
            except (KeyError, TypeError, ValueError):
                P.send_msg(sock, P.MSG_ERROR,
                           {"code": "bad_request",
                            "detail": "RESHARD commit needs int "
                                      "barrier_units"})
                return
            map_wire = header.get("map")
            new_map = (ShardMap.from_wire(map_wire)
                       if map_wire is not None else None)
            dead = [int(r) for r in (header.get("dead_ranks") or ())]
            lo, hi = self._owned()
            participants = range(lo, min(hi, self.spec.world))
            with self._lock:
                self._pending_map = new_map
            ok = self._reshard_commit_prepared(
                barrier, participants=participants, dead=dead)
            if not ok:
                with self._lock:
                    self._pending_map = None
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "retry_ms":
                        self.backpressure.retry_ms("reshard_conflict"),
                    "detail": "no prepared barrier to commit",
                })
                return
            with self._lock:
                hdr = {"phase": "commit", "shard": self.shard_id,
                       "generation": self.generation,
                       "world": self.spec.world,
                       "committed": self._reshard is None}
            P.send_msg(sock, P.MSG_OK, hdr)
            return
        if phase == "abort":
            aborted = self._reshard_abort_prepared()
            with self._lock:
                self._pending_map = None
            P.send_msg(sock, P.MSG_OK,
                       {"phase": "abort", "shard": self.shard_id,
                        "aborted": bool(aborted)})
            return
        if phase == "migrate_prepare":
            # the CUT: freeze the moving ranks and export their state in
            # one locked step — after this reply, nothing at this shard
            # advances them, so the exported records ARE their stream
            # position (docs/AUTOPILOT.md "Migration")
            try:
                spans = [(int(lo), int(hi))
                         for lo, hi in (header.get("spans") or ())]
                ranks = sorted({r for lo, hi in spans
                                for r in range(lo, hi)})
            except (TypeError, ValueError):
                P.send_msg(sock, P.MSG_ERROR,
                           {"code": "bad_request",
                            "detail": "migrate_prepare needs spans "
                                      "[[lo, hi), ...]"})
                return
            with self._lock:
                if self._reshard is not None or self._migrating:
                    P.send_msg(sock, P.MSG_ERROR, {
                        "code": "reshard",
                        "retry_ms":
                            self.backpressure.retry_ms("reshard_conflict"),
                        "detail": "a barrier or migration is already in "
                                  "flight; retry",
                    })
                    return
                self._migrating = set(ranks)
                records = self._export_ranks_locked(ranks)
            P.send_msg(sock, P.MSG_OK,
                       {"phase": "migrate_prepare",
                        "shard": self.shard_id, "records": records})
            return
        if phase == "migrate_commit":
            # both sides of the handoff run this: the TARGET imports the
            # exported records (re-logged through its own WAL, so the
            # handoff replays like recovery), everyone adopts the new
            # map, and the SOURCE starts redirecting the moved ranks
            map_wire = header.get("map")
            new_map = (ShardMap.from_wire(map_wire)
                       if map_wire is not None else None)
            records = header.get("records") or []
            with self._lock:
                for rec in records:
                    self._import_record_locked(dict(rec))
                if new_map is not None \
                        and new_map.version > self.shard_map.version:
                    self.shard_map = new_map
                own = self.shard_map.owns
                self._migrated_out |= {
                    r for r in self._migrating
                    if not own(self.shard_id, r)}
                self._migrated_out = {
                    r for r in self._migrated_out
                    if not own(self.shard_id, r)}
                self._migrating = set()
                for rank in list(self._leases):
                    if not own(self.shard_id, rank):
                        self._leases.pop(rank)
                        self._vacated.pop(rank, None)
                version = self.shard_map.version
            if records:
                # one durable seed so a crash right after the import
                # cannot lose the handed-over cursors between WAL seals
                self._write_snapshot(force=True)
            telemetry.event("shard_map_adopted", shard=self.shard_id,
                            version=version)
            P.send_msg(sock, P.MSG_OK,
                       {"phase": "migrate_commit",
                        "shard": self.shard_id, "map_version": version})
            return
        if phase == "migrate_abort":
            with self._lock:
                self._migrating = set()
            P.send_msg(sock, P.MSG_OK,
                       {"phase": "migrate_abort", "shard": self.shard_id})
            return
        P.send_msg(sock, P.MSG_ERROR,
                   {"code": "bad_request",
                    "detail": f"unknown RESHARD phase {phase!r}"})

    # ------------------------------------------------- rank-state handoff
    def _export_ranks_locked(self, ranks) -> list:
        """The moving ranks' state as additive WAL-vocabulary records
        (cursor / capability / lease), exactly what
        ``_apply_record_locked`` replays — the migration handoff IS a
        WAL replay at the new owner.  Under ``self._lock``."""
        recs = []
        for rank in ranks:
            cur = self._cursors.get(rank)
            if cur is not None:
                recs.append({"op": "cursor", "rank": int(rank), **cur})
            cap = self._cap_records.get(rank)
            if cap is not None:
                recs.append({"op": "capability", "rank": int(rank), **cap})
            lease = self._leases.get(rank)
            if lease is not None and lease.get("batch"):
                recs.append({"op": "lease", "rank": int(rank),
                             "batch": int(lease["batch"])})
        return recs

    def _import_record_locked(self, rec: dict) -> None:
        """Apply one handed-over record AND re-log it through this
        shard's own WAL/replication feed, so the import survives a
        crash and mirrors to this shard's standby."""
        self._apply_record_locked(dict(rec))
        op = rec.pop("op")
        self._repl_append(op, **rec)

    def _on_get_batch(self, sock, conn_id, header) -> None:
        try:
            rank = int(header["rank"])
        except (KeyError, TypeError, ValueError):
            rank = None
        if rank is not None:
            with self._lock:
                migrating = rank in self._migrating
                moved = rank in self._migrated_out
            if migrating:
                # mid-cut: the rank's exported cursor must not move
                P.send_msg(sock, P.MSG_ERROR, {
                    "code": "reshard",
                    "retry_ms":
                        self.backpressure.retry_ms("reshard_freeze"),
                    "detail": f"rank {rank} is frozen mid-migration; "
                              "retry shortly",
                })
                return
            if moved:
                self.metrics.inc("migrated_redirects")
                P.send_msg(sock, P.MSG_ERROR, self._wrong_shard_err(rank))
                return
        super()._on_get_batch(sock, conn_id, header)

    def _commit_reshard_locked(self) -> bool:
        committed = super()._commit_reshard_locked()
        if committed:
            # the base commit vacates exactly the slots a leaver or a
            # dead rank left behind
            self._freed_slots = set(self._vacated)
        if committed and self._pending_map is not None:
            # the map flips atomically with the generation bump: before
            # it, migrating ranks keep draining here; after it, their
            # HELLOs draw wrong_shard and re-route to the new owner
            self.shard_map = self._pending_map
            self._pending_map = None
            lo, hi = self._owned()
            for rank in list(self._leases):
                if not lo <= rank < hi:
                    self._leases.pop(rank)
                    self._vacated.pop(rank, None)
            telemetry.event("shard_map_adopted", shard=self.shard_id,
                            version=self.shard_map.version)
        return committed

    def adopt_map(self, shard_map: ShardMap) -> None:
        """Adopt a newer map outside a barrier (router re-push)."""
        with self._lock:
            if shard_map.version >= self.shard_map.version:
                self.shard_map = shard_map
