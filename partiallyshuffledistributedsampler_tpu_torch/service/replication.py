"""Hot-standby replication: WAL shipping from a primary ``IndexServer``.

The primary appends every state-mutating transition to a sequenced
in-memory WAL (:class:`ReplicationLog`) and a background
:class:`ReplicationShipper` streams it to a standby ``IndexServer``
over the existing length-prefixed protocol (``REPL_SYNC`` /
``REPL_APPEND`` frames, docs/RESILIENCE.md "Replication & failover").

Design points:

* **Serving never blocks on the standby.**  ``append`` is an in-memory
  deque push under a lock; the shipper drains it asynchronously.  A
  slow, dead, or never-attached standby costs the primary nothing but
  the (bounded) log memory; the shipper reconnects with backoff and
  re-bootstraps (``REPL_SYNC`` carries the full snapshot-v2 state) when
  the tail it needs has been dropped.
* **Record vocabulary.**  Cheap high-frequency transitions ship as
  narrow records (``cursor`` upserts, ``lease`` grants/releases,
  ``epoch`` sets); the rare complex transitions — a reshard barrier's
  freeze→drain flip and its commit — ship the full state dict
  (``state`` records), so the standby applies them with the same code
  path a snapshot restore uses and cannot mis-replay a barrier.
  ``seal`` marks a primary snapshot write, letting a standby with its
  own ``snapshot_path`` persist at the same cadence.
* **Fencing terms.**  Every frame carries the primary's ``term``.  A
  promoted standby answers an old-term frame with
  ``ERROR(code='fenced')`` carrying the winning term — the zombie
  primary's shipper surfaces that through ``on_fenced`` and the server
  fences itself (every subsequent client write refused, docs/
  RESILIENCE.md "Split-brain fencing").
* **Fault sites.**  ``repl.append`` fires on every WAL append; an
  injected fault there degrades to a forced re-SYNC (counted as
  ``repl_append_errors``) — replication is an availability feature and
  must never take the serving path down.  ``repl.promote`` fires inside
  the standby's promotion (server.py) before any state flips.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

from .. import faults as F
from .. import telemetry
from . import protocol as P
from ..analysis.lockorder import new_lock

#: how many WAL records the in-memory log retains; a standby that falls
#: further behind is re-bootstrapped via REPL_SYNC instead of replaying
LOG_TAIL = 4096

#: idle shipper tick: also the empty-append heartbeat cadence the standby
#: judges feed freshness by (repl_feed_timeout must comfortably exceed it)
SHIP_TICK_S = 0.2


class ReplicationLog:
    """Sequenced, bounded, thread-safe WAL of state transitions.

    Records are ``{"lsn": int, "op": str, **data}``; ``lsn`` is a dense
    1-based sequence.  ``append`` is the ``repl.append`` fault site: an
    injected failure marks the log for re-SYNC (the shipper re-ships the
    full state) rather than surfacing into the serving path.

    With a :class:`~..durability.WriteAheadLog` attached (``wal=``) the
    in-memory deque becomes a *view* over the disk log: every record is
    written through to the segments (under this log's lock — the WAL's
    own lock nests inside it), ``lsn`` resumes from ``wal.last_lsn``
    across restarts, and ``take()`` falls back to reading the segments
    when the deque has rotated past a slow standby's cursor, so a
    catch-up that used to force a full re-SYNC becomes a tail read."""

    def __init__(self, metrics=None, tail: int = LOG_TAIL,
                 wal=None) -> None:
        self._lock = new_lock("repl.log")
        self._cond = threading.Condition(self._lock)
        self._records: deque = deque(maxlen=max(1, int(tail)))  # guarded by: self._lock
        self.wal = wal
        self.lsn = wal.last_lsn if wal is not None else 0  # guarded by: self._lock — last appended
        self.resync_needed = False  # guarded by: self._lock
        self._urgent = False       # guarded by: self._lock — non-absorbing record pending
        self._metrics = metrics

    def append(self, op: str, data: dict) -> None:
        try:
            F.fire("repl.append")
        except F.InjectedThreadDeath:
            raise
        except Exception:
            # an append that failed mid-transition could leave the log
            # with a hole; the recovery is a full re-SYNC, never an
            # error on the serving path that caused the transition
            with self._cond:
                self.lsn += 1
                self.resync_needed = True
                self._urgent = True
                self._cond.notify_all()
            if self._metrics is not None:
                self._metrics.inc("repl_append_errors")
            return
        with self._cond:
            self.lsn += 1
            rec = {"lsn": self.lsn, "op": op, **data}
            self._records.append(rec)
            if self.wal is not None:
                # write-through: the WAL assigns noop fillers for any
                # lsn a previously-injected fault dropped, keeping the
                # on-disk sequence dense; a drop here degrades
                # durability observably, never the serving path
                self.wal.append(rec)
            # ``cursor`` upserts arrive once per served batch and are
            # absorbing (a newer one supersedes an older one for the
            # same rank), so they coalesce until the next ship tick
            # instead of waking the shipper into a per-batch round trip
            # — that synchronous chatter is what would otherwise make
            # replication visible in the serving path's wall clock
            if op != "cursor":
                self._urgent = True
                self._cond.notify_all()
        if self._metrics is not None:
            self._metrics.inc("repl_appends")

    def take(self, after_lsn: int, timeout: float = SHIP_TICK_S):
        """Records with ``lsn > after_lsn``, waiting up to ``timeout``
        unless a non-absorbing record is already pending.  Superseded
        ``cursor`` records (an older upsert for a rank that has a newer
        one in the same batch) are thinned out; the standby's applied
        cursor jumps over the thinned lsns, which its gap check allows
        because the batch's boundary lsns stay intact.  Returns
        ``(records, resync)``: ``resync`` True when the tail no longer
        reaches back to ``after_lsn + 1`` (or an append failed) and the
        shipper must re-bootstrap.  With a ``wal`` attached, a deque
        that rotated past the cursor first falls back to reading the
        catch-up tail from the disk segments (``repl_wal_reads``);
        only a tail the checkpoint GC already cut forces the re-SYNC."""
        with self._cond:
            if not self._urgent and not self.resync_needed:
                self._cond.wait(timeout)
            self._urgent = False
            if self.resync_needed:
                return [], True
            recs = [r for r in self._records if r["lsn"] > after_lsn]
            gap = ((bool(recs) and recs[0]["lsn"] != after_lsn + 1)
                   or (not recs and self.lsn > after_lsn))
        if gap:
            if self.wal is None:
                return [], True  # tail rotated past the standby's cursor
            # segment records are immutable once framed, so the read
            # runs outside the log lock and never blocks appends
            recs = self.wal.read_records(after_lsn=after_lsn)
            if not recs or recs[0]["lsn"] != after_lsn + 1:
                return [], True  # GC cut past the cursor: re-bootstrap
            if self._metrics is not None:
                self._metrics.inc("repl_wal_reads")
        # upserts coalesce per (tenant, rank): a multi-tenant primary
        # tags records with the owning tenant id, and two tenants'
        # rank-0 cursors must not thin each other
        newest_cursor = {
            (r.get("tenant"), r["rank"]): r["lsn"]
            for r in recs if r["op"] == "cursor"}
        return [r for r in recs
                if r["op"] != "cursor"
                or newest_cursor[(r.get("tenant"), r["rank"])] == r["lsn"]
                ], False

    def clear_resync(self) -> None:
        with self._cond:
            self.resync_needed = False


class TenantTaggedLog:
    """A tenant engine's view of the front daemon's shared WAL.

    Multi-tenant daemons (docs/SERVICE.md "Tenancy") keep ONE sequenced
    log; each tenant engine appends through this wrapper, which stamps
    the owning tenant id into every record so the standby can route it
    to its mirror of that tenant and ``take()`` can thin cursor upserts
    per ``(tenant, rank)``."""

    def __init__(self, log: ReplicationLog, tenant: str) -> None:
        self._log = log
        self.tenant = str(tenant)

    def append(self, op: str, data: dict) -> None:
        self._log.append(op, {**data, "tenant": self.tenant})

    @property
    def lsn(self) -> int:
        """The shared sequence's last lsn — a tenant engine's seal
        stamps it as the checkpoint watermark (``wal_lsn``)."""
        return self._log.lsn


class ReplicationShipper:
    """The primary's background thread streaming its WAL to the standby.

    ``state_fn`` produces the full snapshot-v2 state for bootstrap;
    ``term_fn`` the current fencing term (stamped into every frame);
    ``on_fenced(term)`` is called when the standby answers with a newer
    term — the server uses it to fence itself (it has been superseded).

    The class attributes name the wire fault site and the metric family,
    so the cross-cell :class:`~..federation.WalShipper` — the same loop
    pointed at a remote cell — observes under its own names without
    duplicating the ship/fence/resync machinery.
    """

    #: fault-injection site armed on every outbound frame (None = none);
    #: the federation shipper overrides with "cell.ship"
    SITE: Optional[str] = None
    M_SHIPPED = "repl_shipped"
    M_RESYNCS = "repl_resyncs"
    M_LAG_MS = "repl_lag_ms"

    def __init__(
        self,
        log: ReplicationLog,
        standby_address,
        *,
        state_fn: Callable[[], dict],
        term_fn: Callable[[], int],
        on_fenced: Callable[[int], None],
        metrics=None,
        timeout: float = 5.0,
    ) -> None:
        self.log = log
        self.standby_address = (str(standby_address[0]),
                                int(standby_address[1]))
        self._state_fn = state_fn
        self._term_fn = term_fn
        self._on_fenced = on_fenced
        self._metrics = metrics
        self.timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.shipped_lsn = 0     # standby-acked prefix
        self.synced = threading.Event()  # a SYNC has been acked at least once
        self._backoff = 0.05

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="psds-service-repl-ship")
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        self._close()
        t, self._thread = self._thread, None
        if t is not None and join:
            t.join(timeout=2.0)

    def _close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------- the loop
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self._sock is None:
                    self._connect_and_sync()
                    continue
                recs, resync = self.log.take(self.shipped_lsn)
                if self._stop.is_set():
                    return
                if resync:
                    self.log.clear_resync()
                    self._close()  # next tick reconnects and re-SYNCs
                    if self._metrics is not None:
                        self._metrics.inc(self.M_RESYNCS)
                    continue
                # an empty append doubles as the feed-freshness heartbeat
                self._ship(P.MSG_REPL_APPEND, {
                    "term": self._term_fn(),
                    "from_lsn": self.shipped_lsn + 1,
                    "records": recs,
                })
                if recs and self._metrics is not None:
                    self._metrics.inc(self.M_SHIPPED, value=len(recs))
            except _Fenced:
                return  # superseded: on_fenced already ran; stop shipping
            except (ConnectionError, socket.timeout, OSError,
                    P.ProtocolError):
                self._close()
                self._stop.wait(self._backoff)
                self._backoff = min(1.0, self._backoff * 2)

    def _connect_and_sync(self) -> None:
        sock = socket.create_connection(self.standby_address,
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.timeout)
        self._sock = sock
        state = self._state_fn()
        # the bootstrap names the lsn the tail continues from: everything
        # the state dict already reflects is never re-shipped
        lsn = self.log.lsn
        self._ship(P.MSG_REPL_SYNC, {"term": self._term_fn(), "lsn": lsn,
                                     "state": state})
        self.shipped_lsn = lsn
        self.log.clear_resync()
        self._backoff = 0.05
        if self.synced.is_set() and self._metrics is not None:
            # any sync after the bootstrap is a RE-sync: a torn frame or
            # dropped link forced the full-state handshake again
            self._metrics.inc(self.M_RESYNCS)
        self.synced.set()
        telemetry.event("repl_sync", lsn=lsn)

    def _send_frame(self, msg_type: int, header: dict) -> None:
        """One framed send on the replication link.  Subclasses override
        to arm their own wire fault site (the `fault-sites` lint needs
        the site literal at the send)."""
        P.send_msg(self._sock, msg_type, header, site=self.SITE)

    def _ship(self, msg_type: int, header: dict) -> None:
        t0 = time.perf_counter()
        self._send_frame(msg_type, header)
        reply, rheader, _ = P.recv_msg(self._sock)
        if reply == P.MSG_ERROR:
            code = rheader.get("code")
            if code == "fenced":
                term = int(rheader.get("term", self._term_fn() + 1))
                telemetry.event("repl_fenced", term=term)
                try:
                    self._on_fenced(term)
                finally:
                    self._close()
                raise _Fenced(term)
            if code == "repl_gap":
                self._close()  # reconnect path re-SYNCs
                if self._metrics is not None:
                    self._metrics.inc(self.M_RESYNCS)
                return
            raise P.ProtocolError(
                f"standby refused {P.msg_name(msg_type)}: {code!r}")
        applied = rheader.get("applied_lsn")
        if applied is not None:
            self.shipped_lsn = max(self.shipped_lsn, int(applied))
        if self._metrics is not None:
            self._metrics.registry.histogram(self.M_LAG_MS).observe(
                (time.perf_counter() - t0) * 1e3)


class _Fenced(Exception):
    """Internal shipper signal: the standby promoted past our term."""

    def __init__(self, term: int) -> None:
        super().__init__(f"fenced at term {term}")
        self.term = int(term)
