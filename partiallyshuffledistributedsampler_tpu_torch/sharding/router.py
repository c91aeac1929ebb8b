"""``ShardRouter``: the thin control-plane front of a sharded serving plane.

A copy of the JAX package's ``sharding/router.py``: the same frames,
fault sites, spans and lock names.

The router (docs/SHARDING.md) speaks the existing HELLO protocol through
the same :class:`~..service.dispatch.DispatchListener` loop as the
servers, but it never serves a single index: a HELLO is answered with a
WELCOME carrying ``router: true`` and the current ``shard_map``, and the
client direct-connects the shard owning its rank — the steady-state
fused/pipelined path never proxies through this process.  Any data-plane
frame that does reach the router (``GET_BATCH``/``HEARTBEAT``/``LEAVE``)
draws the typed ``wrong_shard`` error with ``retry_ms`` and a fresh map.

What the router DOES own is the cross-shard control plane:

* ``set_epoch`` fans out to every shard behind the ``shard.barrier``
  fault site; a partial failure is a retryable ``shard_barrier`` error
  (the op is idempotent, the caller's retry completes it).
* ``reshard`` runs the two-phase barrier: **prepare** freezes every
  shard and gathers its local consumption maximum in whole base units;
  the router imposes the global max ``C`` at **commit** together with a
  version-bumped rebalanced map (dead shards' ranks ride as
  ``dead_ranks`` to the shard owning rank 0, where the existing
  orphan-descriptor machinery re-homes their un-served spans).  Any
  prepare refusal aborts the frozen siblings — no shard is left bricked.
* the map itself: versioned, fingerprinted, persisted in the router's
  own snapshot so a restarted router resumes at the same map version
  (clients keep serving meanwhile — the router is not on the data path).

Routing cost is observed in the ``router_route_ms`` histogram; per-frame
counters (``router_hellos``, ``router_redirects``, ``shard_barriers``)
ride the standard metrics registry (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import socket
import threading
import time
import warnings
from typing import Optional

from .. import faults as F
from .. import telemetry
from ..analysis.lockorder import new_lock
from ..service import protocol as P
from ..tenancy import tenant_id_for
from ..service.dispatch import DispatchListener
from ..service.metrics import ServiceMetrics
from ..utils.checkpoint import load_sampler_state, save_sampler_state
from .shardmap import ShardMap

ROUTER_SNAPSHOT_KIND = "shard_router"


class ShardRouter(DispatchListener):
    """Rank-space router over N shared-nothing shards (see module doc)."""

    _ACCEPT_THREAD_NAME = "psds-router-accept"
    _CONN_THREAD_PREFIX = "psds-router-conn"
    _SPAN_PREFIX = "router."

    def __init__(self, spec, shard_map: ShardMap,
                 host: str = "127.0.0.1", port: int = 0, *,
                 snapshot_path: Optional[str] = None,
                 rpc_timeout: float = 5.0,
                 multi_tenant: bool = False,
                 metrics: Optional[ServiceMetrics] = None,
                 clock=time.monotonic,
                 cell_id: Optional[str] = None,
                 cell_directory=None):
        self.spec = spec
        self.host, self.port = host, int(port)
        #: federation facts (docs/FEDERATION.md): the cell this router
        #: fronts and the shared directory holder; both None unfederated
        self.cell_id = None if cell_id is None else str(cell_id)
        self._cell_directory = cell_directory
        self.snapshot_path = snapshot_path
        self.rpc_timeout = float(rpc_timeout)
        self.multi_tenant = bool(multi_tenant)
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self._clock = clock
        self._lock = new_lock("router")
        #: the live rank→shard map  # guarded by: self._lock
        self._map = shard_map
        #: serializes cross-shard barriers (never nests under _lock)
        self._barrier_lock = new_lock("router.barrier")
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._listener = None
        self._threads: list = []
        self._conn_socks: dict = {}
        self._next_conn_id = 0  # guarded by: self._lock

    # ------------------------------------------------------------ lifecycle
    def start(self) -> tuple:
        """Restore the map snapshot (version survives restarts) and bind."""
        if self._listener is not None:
            raise RuntimeError("router already started")
        self._stop.clear()
        self._draining.clear()
        self._restore_snapshot()
        return self._listener_bind()

    @property
    def address(self) -> tuple:
        return self.host, self.port

    @property
    def shard_map(self) -> ShardMap:
        with self._lock:
            return self._map

    def stop(self) -> None:
        self._draining.set()
        self._stop.set()
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        with self._lock:
            socks = list(self._conn_socks.values())
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        leaked = [t for t in self._threads if t.is_alive()]
        if leaked:
            self.metrics.inc("leaked_threads", value=len(leaked))
            warnings.warn(
                f"ShardRouter.stop(): {len(leaked)} serve thread(s) "
                f"survived the join timeout: {[t.name for t in leaked]}",
                RuntimeWarning,
            )
        self._threads.clear()
        self._write_snapshot()

    def kill(self) -> None:
        """Abrupt death for restart drills: no snapshot, no goodbyes —
        direct-connected clients must not notice (docs/SHARDING.md)."""
        self._stop.set()
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        with self._lock:
            socks = list(self._conn_socks.values())
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads.clear()

    def __enter__(self) -> "ShardRouter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- snapshot
    def _snapshot_state_locked(self) -> dict:
        return {"kind": ROUTER_SNAPSHOT_KIND, "format": 1,
                "proto": P.PROTOCOL_VERSION, "map": self._map.to_wire()}

    def _write_snapshot(self) -> None:
        if self.snapshot_path is None:
            return
        with self._lock:
            state = self._snapshot_state_locked()
        try:
            save_sampler_state(self.snapshot_path, state)
        except OSError:
            self.metrics.inc("snapshot_errors")

    def _restore_snapshot(self) -> None:
        if self.snapshot_path is None:
            return
        try:
            state = load_sampler_state(self.snapshot_path)
        except (OSError, ValueError):
            return
        if state.get("kind") != ROUTER_SNAPSHOT_KIND:
            return
        try:
            m = ShardMap.from_wire(state["map"])
        except (KeyError, TypeError, ValueError, IndexError):
            return
        with self._lock:
            if m.version >= self._map.version:
                # addresses may have moved while we were down; keep the
                # restored ones only where the constructor gave none
                for sid, addr in enumerate(self._map.addrs):
                    if addr is not None and sid < m.n_shards:
                        m.set_addr(sid, addr)
                self._map = m

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, sock, conn_id, msg, header, payload) -> None:
        if self._draining.is_set():
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "draining",
                "detail": "router is stopping; reconnect shortly",
                "retry_ms": 200,
            })
            return
        if msg == P.MSG_HELLO:
            self._on_hello(sock, header)
        elif msg in (P.MSG_GET_BATCH, P.MSG_HEARTBEAT, P.MSG_LEAVE,
                     P.MSG_GET_CAPABILITY):
            # the router is never on the data path — capability
            # issuance included (the owning shard signs and revokes
            # its own grants; the router stays placement-only): redirect
            self.metrics.inc("router_redirects")
            P.send_msg(sock, P.MSG_ERROR, self._wrong_shard_err(
                header.get("rank")))
        elif msg == P.MSG_SET_EPOCH:
            self._on_set_epoch(sock, header)
        elif msg == P.MSG_RESHARD:
            self._on_reshard(sock, header)
        elif msg == P.MSG_SNAPSHOT:
            self._write_snapshot()
            with self._lock:
                state = self._snapshot_state_locked()
            P.send_msg(sock, P.MSG_SNAPSHOT_STATE, {"state": state})
        elif msg == P.MSG_METRICS:
            P.send_msg(sock, P.MSG_METRICS_REPORT,
                       {"report": self.metrics.report()})
        elif msg == P.MSG_TRACE_DUMP:
            limit = int(header.get("limit", 256))
            P.send_msg(sock, P.MSG_TRACE_REPORT, {
                "enabled": telemetry.enabled(),
                "entries": telemetry.snapshot(limit),
            })
        else:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "unknown_type",
                "detail": f"message type {P.msg_name(msg)} not routed",
            })

    def _wrong_shard_err(self, rank) -> dict:
        with self._lock:
            m = self._map
        owner = None
        if rank is not None:
            try:
                owner = m.owner(int(rank))
            except (TypeError, ValueError):
                owner = None
        return {
            "code": "wrong_shard", "retry_ms": 25,
            "shard": None, "owner": owner,
            "shard_map": m.to_wire(),
            "detail": "the router is not on the data path; direct-connect "
                      "the owning shard from the attached shard_map",
        }

    # -------------------------------------------------- multi-cell federation
    def _cell_dir(self):
        """The live ``CellDirectory`` (duck-typed holder or value), or
        None unfederated — the server-side helper's twin."""
        d = self._cell_directory
        if d is None:
            return None
        return d.current() if hasattr(d, "current") else d

    def _cell_fields(self) -> dict:
        if self.cell_id is None:
            return {}
        out = {"cell": self.cell_id}
        d = self._cell_dir()
        if d is not None:
            out["cell_directory"] = d.to_wire()
        return out

    def _cell_refusal(self, header: dict) -> Optional[dict]:
        """The router's cell gate: same typed retryable ``wrong_cell``
        redirect its shards answer with (docs/FEDERATION.md), so a
        client dialing the wrong cell's ROUTER is re-pointed before it
        ever reaches a shard.  Failover HELLOs are exempt, exactly as
        at the shard gate: the dying home cell's clients must be able
        to reach the DR cell before the directory flips."""
        if self.cell_id is None or header.get("failover"):
            return None
        d = self._cell_dir()
        if d is None:
            return None
        tenant = header.get("tenant")
        if tenant is None:
            fp = header.get("spec_fingerprint")
            tenant = (tenant_id_for(str(fp)) if fp is not None
                      else tenant_id_for(
                          self.spec.fingerprint(include_world=False)))
        home = d.home(str(tenant))
        if home == self.cell_id:
            return None
        self.metrics.inc("cell_redirects")
        return {
            "code": "wrong_cell", "retry_ms": 25,
            "cell": self.cell_id,
            "home": home,
            "cell_directory": d.to_wire(),
            "detail": f"tenant {tenant} is homed at cell {home!r}; this "
                      f"router fronts cell {self.cell_id!r} (directory "
                      f"v{d.version})",
        }

    # ----------------------------------------------------------------- HELLO
    def _on_hello(self, sock, header) -> None:
        t0 = time.perf_counter()
        proto = header.get("proto")
        if proto != P.PROTOCOL_VERSION:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "protocol_version",
                "server_proto": P.PROTOCOL_VERSION,
                "client_proto": proto,
                "detail": f"router speaks protocol {P.PROTOCOL_VERSION}, "
                          f"client sent {proto!r}",
            })
            return
        fp = header.get("spec_fingerprint")
        ours = self.spec.fingerprint(include_world=False)
        if fp is not None and fp != ours and not self.multi_tenant:
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "spec_mismatch",
                "server_fingerprint": ours,
                "client_fingerprint": fp,
                "detail": "client and router stream specs differ; this "
                          "plane is single-tenant",
            })
            return
        cell_refusal = self._cell_refusal(header)
        if cell_refusal is not None:
            P.send_msg(sock, P.MSG_ERROR, cell_refusal)
            return
        try:
            F.fire("router.route")
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:
            # an injected routing fault is a clean retryable refusal
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "router_route", "retry_ms": 50,
                "detail": f"routing refused ({exc!r}); retry",
            })
            return
        self.metrics.inc("router_hellos")
        self.metrics.inc("router_redirects")
        with self._lock:
            m = self._map
        welcome = {
            "proto": P.PROTOCOL_VERSION,
            "router": True,
            "rank": header.get("rank"),
            "shard_map": m.to_wire(),
            # additive: serving cell + global directory on a federated
            # deployment (docs/FEDERATION.md); empty otherwise
            **self._cell_fields(),
        }
        self.metrics.registry.histogram("router_route_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        P.send_msg(sock, P.MSG_WELCOME, welcome)

    # ---------------------------------------------------- cross-shard plane
    def _shard_rpc(self, addr, msg, header):
        """One blocking RPC to a shard (raw protocol, no HELLO — control
        frames hold no rank lease).  Raises ``OSError``/``ProtocolError``
        upward; the barrier layer converts those to typed retries."""
        s = socket.create_connection(tuple(addr), timeout=self.rpc_timeout)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.rpc_timeout)
            P.send_msg(s, msg, header)
            rmsg, rheader, _ = P.recv_msg(s)
            return rmsg, rheader
        finally:
            try:
                s.close()
            except OSError:
                pass

    def _live_shards(self, m: ShardMap) -> list:
        return [sid for sid in range(m.n_shards)
                if m.addr(sid) is not None]

    def set_epoch(self, epoch: int) -> None:
        """Fan ``SET_EPOCH`` out to every shard.  Idempotent: a partial
        failure raises (typed at the protocol surface as a retryable
        ``shard_barrier``) and the caller's retry completes it."""
        with self._barrier_lock:
            F.fire("shard.barrier")
            self.metrics.inc("shard_barriers")
            with self._lock:
                m = self._map
            for sid in self._live_shards(m):
                rmsg, rheader = self._shard_rpc(
                    m.addr(sid), P.MSG_SET_EPOCH, {"epoch": int(epoch)})
                if rmsg != P.MSG_OK:
                    raise RuntimeError(
                        f"shard {sid} refused SET_EPOCH: {rheader}")
        telemetry.event("router_set_epoch", epoch=int(epoch))

    def _on_set_epoch(self, sock, header) -> None:
        try:
            epoch = int(header["epoch"])
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": "SET_EPOCH needs an int epoch"})
            return
        try:
            self.set_epoch(epoch)
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:  # lint: allow-broad-except(fan-out failure is a typed retry)
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "shard_barrier", "retry_ms": 100,
                "detail": f"cross-shard set_epoch incomplete ({exc!r}); "
                          "the op is idempotent — retry",
            })
            return
        P.send_msg(sock, P.MSG_OK, {"epoch": epoch})

    def reshard(self, new_world: int, *, dead_shards=()) -> ShardMap:
        """The two-phase cross-shard barrier (see module doc).  Returns
        the committed (version-bumped) map.  ``dead_shards`` names shards
        that are gone without a standby: their ranks' un-served spans are
        re-homed as orphans on the shard owning rank 0."""
        new_world = int(new_world)
        if new_world < 1:
            raise ValueError(f"new_world must be >= 1, got {new_world}")
        with self._barrier_lock:
            F.fire("shard.barrier")
            self.metrics.inc("shard_barriers")
            with self._lock:
                m = self._map
            dead_shards = {int(s) for s in dead_shards}
            live = [sid for sid in self._live_shards(m)
                    if sid not in dead_shards]
            dead_ranks = sorted(
                r for sid in dead_shards
                for r in range(*m.ranks(sid)) if r < m.world)
            prepared: list = []
            t0 = time.perf_counter()
            try:
                reports = {}
                for sid in live:
                    rmsg, rheader = self._shard_rpc(
                        m.addr(sid), P.MSG_RESHARD,
                        {"world": new_world, "phase": "prepare"})
                    if rmsg != P.MSG_OK:
                        raise RuntimeError(
                            f"shard {sid} refused prepare: {rheader}")
                    prepared.append(sid)
                    reports[sid] = rheader
                epochs = {int(r["epoch"]) for r in reports.values()}
                if len(epochs) > 1:
                    raise RuntimeError(
                        f"shards disagree on the barrier epoch: {epochs}")
                barrier = max(int(r["units_max"])
                              for r in reports.values())
            except F.InjectedThreadDeath:
                raise
            except Exception:
                # no shard stays bricked behind an abandoned freeze
                for sid in prepared:
                    try:
                        self._shard_rpc(m.addr(sid), P.MSG_RESHARD,
                                        {"phase": "abort"})
                    except (OSError, P.ProtocolError):
                        pass  # lint: allow-broad-except(best-effort abort; shard sweep self-heals)
                raise
            new_map = m.rebalanced(new_world)
            rank0_owner = new_map.owner(0) if new_world >= 1 else 0
            for sid in live:
                hdr = {"world": new_world, "phase": "commit",
                       "barrier_units": int(barrier),
                       "map": new_map.to_wire()}
                if sid == rank0_owner and dead_ranks:
                    # orphan re-homing: only the shard serving rank 0's
                    # orphan prefix registers the dead ranks, or their
                    # spans would be orphaned once per shard
                    hdr["dead_ranks"] = dead_ranks
                rmsg, rheader = self._shard_rpc(
                    m.addr(sid), P.MSG_RESHARD, hdr)
                if rmsg != P.MSG_OK:
                    raise RuntimeError(
                        f"shard {sid} refused commit: {rheader}")
            with self._lock:
                self._map = new_map
            self.metrics.registry.histogram("shard_barrier_ms").observe(
                (time.perf_counter() - t0) * 1e3)
        self._write_snapshot()
        telemetry.event("router_reshard", world=new_world,
                        map_version=new_map.version,
                        barrier_units=int(barrier))
        return new_map

    def remap(self, new_map: ShardMap) -> ShardMap:
        """Adopt an elastic map transform (``split``/``merged``/
        ``migrated`` — the autopilot's shard-map arm): a two-phase
        cross-shard handoff of exactly the rank spans whose owner
        changed.  **Prepare** freezes the moving ranks at each source
        and collects their exported state; **commit** lands each span's
        records at its new owner FIRST (so the state exists before any
        client is redirected at it), then flips every shard's map —
        sources start answering the moved ranks with ``wrong_shard``.
        No generation bump, no cascade change: the folded streams are
        bit-identical to the static plane's (docs/AUTOPILOT.md).  Any
        prepare failure aborts the frozen sources; nothing is bricked."""
        with self._barrier_lock:
            F.fire("shard.migrate")
            self.metrics.inc("shard_migrations")
            with self._lock:
                m = self._map
            if new_map.world != m.world:
                raise ValueError(
                    f"remap moves ranks between shards at a fixed world "
                    f"({m.world}); use reshard() for world changes")
            if new_map.version <= m.version:
                raise ValueError(
                    f"remap needs a newer map (v{new_map.version} <= "
                    f"v{m.version})")
            spans = m.moved_spans(new_map)
            by_src: dict = {}
            for lo, hi, old_sid, _ in spans:
                by_src.setdefault(old_sid, []).append([lo, hi])
            t0 = time.perf_counter()
            prepared: list = []
            exports: dict = {}
            try:
                for sid in sorted(by_src):
                    rmsg, rheader = self._shard_rpc(
                        m.addr(sid), P.MSG_RESHARD,
                        {"phase": "migrate_prepare",
                         "spans": by_src[sid]})
                    if rmsg != P.MSG_OK:
                        raise RuntimeError(
                            f"shard {sid} refused migrate_prepare: "
                            f"{rheader}")
                    prepared.append(sid)
                    exports[sid] = rheader.get("records") or []
            except F.InjectedThreadDeath:
                raise
            except Exception:
                for sid in prepared:
                    try:
                        self._shard_rpc(m.addr(sid), P.MSG_RESHARD,
                                        {"phase": "migrate_abort"})
                    except (OSError, P.ProtocolError):
                        pass  # lint: allow-broad-except(best-effort abort; shard sweep self-heals)
                raise
            imports: dict = {}
            for sid in sorted(exports):
                for rec in exports[sid]:
                    owner = new_map.owner(int(rec["rank"]))
                    imports.setdefault(owner, []).append(rec)
            wire = new_map.to_wire()
            # every prepared source must commit even when the new map
            # drops its address (a merge empties it): reach it at its
            # OLD address so it starts redirecting its moved ranks
            addr_of: dict = {}
            for sid in {*prepared, *imports, *self._live_shards(new_map)}:
                a = (new_map.addr(sid)
                     if sid < new_map.n_shards else None)
                if a is None and sid < m.n_shards:
                    a = m.addr(sid)
                if a is not None:
                    addr_of[sid] = a
            # targets import before sources redirect: a client bounced
            # at a source must find its cursor already at the new owner
            order = sorted(imports) + [
                sid for sid in sorted(addr_of) if sid not in imports]
            for sid in order:
                rmsg, rheader = self._shard_rpc(
                    addr_of[sid], P.MSG_RESHARD,
                    {"phase": "migrate_commit", "map": wire,
                     "records": imports.get(sid, [])})
                if rmsg != P.MSG_OK:
                    raise RuntimeError(
                        f"shard {sid} refused migrate_commit: {rheader}")
            with self._lock:
                self._map = new_map
            self.metrics.registry.histogram("shard_migrate_ms").observe(
                (time.perf_counter() - t0) * 1e3)
        self._write_snapshot()
        telemetry.event("router_remap", map_version=new_map.version,
                        moved=[list(s) for s in spans])
        return new_map

    def _on_reshard(self, sock, header) -> None:
        try:
            new_world = int(header["world"])
            if new_world < 1:
                raise ValueError(new_world)
        except (KeyError, TypeError, ValueError):
            P.send_msg(sock, P.MSG_ERROR,
                       {"code": "bad_request",
                        "detail": "RESHARD needs an int world >= 1"})
            return
        try:
            new_map = self.reshard(
                new_world, dead_shards=header.get("dead_shards") or ())
        except F.InjectedThreadDeath:
            raise
        except Exception as exc:  # lint: allow-broad-except(fan-out failure is a typed retry)
            P.send_msg(sock, P.MSG_ERROR, {
                "code": "shard_barrier", "retry_ms": 100,
                "detail": f"cross-shard barrier incomplete ({exc!r}); "
                          "retry",
            })
            return
        P.send_msg(sock, P.MSG_OK, {
            "world": new_world, "map_version": new_map.version,
            "shard_map": new_map.to_wire(),
        })

    # -------------------------------------------------------------- tenancy
    def attach_tenant(self, spec) -> list:
        """Pre-attach a tenant namespace on every shard owning some of
        its ranks (the additive ``attach`` HELLO — no rank lease is
        claimed).  Lazy admission at first client HELLO also works; this
        just front-loads the regen scheduling fairly across shards.
        Returns the attached shard ids."""
        with self._lock:
            m = self._map
        fp = spec.fingerprint(include_world=False)
        wire = spec.to_wire()
        attached = []
        for sid in self._live_shards(m):
            lo, hi = m.ranks(sid)
            if hi <= lo:
                continue  # an empty slice owns no tenant ranks
            rmsg, rheader = self._shard_rpc(
                m.addr(sid), P.MSG_HELLO,
                {"proto": P.PROTOCOL_VERSION, "spec_fingerprint": fp,
                 "spec": wire, "attach": True})
            if rmsg != P.MSG_OK:
                raise RuntimeError(
                    f"shard {sid} refused tenant attach: {rheader}")
            attached.append(sid)
        return attached

    def note_failover(self, shard_id: int, addr) -> None:
        """Record a shard's promoted standby address (control-plane RPCs
        and future redirects go there; clients already direct-connected
        learned it from the shard's own WELCOME)."""
        with self._lock:
            self._map.set_addr(shard_id, addr)
        self._write_snapshot()
